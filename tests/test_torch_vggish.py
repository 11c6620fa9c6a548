"""VGGish (arXiv:1609.09430) on the port: its front-end against the
benchmark's plain reference (``portbench/reference/frontend.py``), its layer
list against the benchmark's plan of ``portbench/configs/vggish.json``, the
chain's kernel predicates at its widths and at counts the kernels refuse,
and ``ExplainerService`` at its published channel counts against the plain
reference LRP (``portbench/reference/lrp.py``), all on the CPU."""

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.utils.constants import LRP_NAME_MAP_TOY
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.ops import frontend as tfe
from drsa_audio_tpu_torch.ops.mel import mel_filterbank
from drsa_audio_tpu_torch.ops.stft import _frame_signal, dft_basis, hann_window
from drsa_audio_tpu_torch.serving import ExplainerService
from drsa_audio_tpu_torch.utils import constants as tconst
from drsa_audio_tpu_torch.utils.convert import from_jax_params
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.lrp import chain, engine, fused_gamma, taps
from test_torch_util import assert_close_lrp, jit_init_params, signed_permutation, t, to_np

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pb import model as pb_model  # noqa: E402
from pb import program as pb_program  # noqa: E402
from reference import frontend as ref_frontend  # noqa: E402
from reference import lrp as ref_lrp  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "vggish.json").read_text())
FRONTEND_KEYS = ("sample_rate", "slice_length", "clip_samples", "n_fft", "win_length",
                 "hop_length", "n_mels", "mel_width", "f_min", "f_max", "triangles", "log",
                 "log_offset", "center", "first_frame", "peak_normalize")
VGGISH_CHANNELS = [(128, 256), (256, 256), (256, 512), (512, 512)]


def _noise(b: int, n: int, seed: int, scale: float = 0.3) -> torch.Tensor:
    """The benchmark's inputs: Gaussian noise times ``scale``, clipped to [-1, 1]."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, n, generator=g) * scale).clamp(-1.0, 1.0)


def test_vggish_frontend_table_is_the_configurations():
    """The port's VGGish front-end (FRONTEND_PARAMS) states what the
    benchmark's configuration states, key for key; AUDIO_PARAMS has no
    VGGish case (it stays the JAX package's table)."""
    assert {k: tconst.FRONTEND_PARAMS["vggish"][k] for k in FRONTEND_KEYS} == \
        {k: CONFIG[k] for k in FRONTEND_KEYS}
    assert "vggish" not in tconst.AUDIO_PARAMS
    assert all(tconst.FRONTEND_PARAMS[c] == tconst.AUDIO_PARAMS[c] for c in tconst.AUDIO_PARAMS)
    cfg = tfe.FrontendConfig.for_case("vggish")
    assert (cfg.n_mels, cfg.width, cfg.clip_samples, cfg.peak_normalize) == (64, 96, 15600, False)


@pytest.mark.parametrize("scale", [0.3, 0.01, 1.0])
def test_vggish_logmel_matches_the_reference(scale):
    """The service's log-mel (matmul DFT of 400-sample frames in a 512-point
    basis, uncentred, mel-linear bands, ln(mel + 0.01), frames 0..95)
    against the reference's (rfft of the zero-padded frames). rtol 1e-5 in
    the log domain, with atol 1e-5 of the largest |log-mel|: ln(mel + 0.01)
    crosses 0 where mel is 0.99, and there the float32 round-off of the two
    DFTs (~5e-6 absolute, ~1e-6 of the magnitudes) is no small share of the
    value."""
    cfg = tfe.FrontendConfig.for_case("vggish")
    x = _noise(4, 15600, 11, scale)
    got = tfe.logmel(x, cfg)
    want = ref_frontend.features(x, CONFIG)
    assert got.shape == want.shape == (4, 64, 96)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("case", ["gtzan", "gtzan_6s", "toy"])
def test_gtzan_mels_equal_the_parents_formula(case):
    """The GTZAN and toy cases give the same bits as the front-end did
    before it took other framings: centred n_fft frames, the Hz-linear bank,
    log10(x + 1e-7) clamped at -4, frames 1 .. width."""
    cfg = tfe.FrontendConfig.for_case(case)
    x = tfe.peak_normalize(_noise(3, cfg.sample_rate * cfg.slice_length, 5))
    frames = _frame_signal(x, cfg.n_fft, cfg.hop_length) * hann_window(cfg.n_fft)
    cos_b, sin_b = (torch.as_tensor(m) for m in dft_basis(cfg.n_fft))
    mag = torch.sqrt((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2).transpose(-1, -2)
    fb = torch.as_tensor(mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate))
    mel = (mag.transpose(-1, -2) @ fb).transpose(-1, -2)
    want = torch.clamp(torch.log10(mel + 1e-7), min=-4.0)[..., 1:cfg.width + 1]
    assert torch.equal(tfe.logmel(x, cfg), want)


def test_vggish_layer_specs_match_the_benchmarks_plan():
    """build_layer_specs(vggish_config()) is the benchmark's plan of the
    configuration, layer for layer: kind, name and config; 72.1 M weights."""
    got = [(s.kind, s.name, s.config) for s in tvgg.build_layer_specs(tvgg.vggish_config())]
    want = [(s.kind, s.name, s.config) for s in pb_program.layer_specs(CONFIG)]
    assert got == want
    n = 0
    for kind, _, c in got:
        if kind == "conv":
            n += c["out_ch"] * (c["in_ch"] * 9 + 1)
        elif kind == "linear":
            n += c["out_f"] * (c["in_f"] + 1)
    assert n - (128 + 1) * 10 == 72_141_184       # without the class probe


def test_old_fields_give_the_same_layer_specs():
    """A config of the old fields alone, and the same stated per block and
    per dense layer, give one layer list."""
    old = tvgg.gtzan_6s_config()
    new = dataclasses.replace(
        old, block_depths=(2,) * 5,
        dense_layers=(tvgg.DenseLayer(100, True, True, 0.3),) * 2)
    assert tvgg.build_layer_specs(old) == tvgg.build_layer_specs(new)


def _vggish_section(hw=(64, 96)):
    cfg = dataclasses.replace(tvgg.vggish_config(), input_size=hw)
    specs = tvgg.build_layer_specs(cfg)
    params = tvgg.init_params(specs, 0, device="cpu")
    rules = [(n, (r, kw)) for n, r, kw in CONFIG["rules"]]
    tsp = t_insert(specs, 14, t(signed_permutation(0, 512)), 4, input_size=hw)
    conv_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    return conv_sec, params, texp.class_composite(rules, 4)


def test_plan_chain_accepts_vggish():
    """VGGish's conv section at its published widths is planned for the
    chain kernels: first_layer under block 0 (64 channels at 64 x 96), one
    chain_block a block above it, convs of 128 to 512 channels."""
    conv_sec, params, comp = _vggish_section()
    plan = chain.plan_chain(conv_sec, params, comp, fine_hw=(64, 96))
    assert plan is not None
    assert [b["convs"] for b in plan["blocks"]] == [[0], [3], [6, 8], [11, 13]]
    assert [b["pool_above"] for b in plan["blocks"]] == [(2, 2, 2), (5, 2, 2), (10, 2, 2), None]


@pytest.mark.parametrize("c,takes", [(8, True), (100, True), (128, True), (136, False),
                                     (192, True), (256, True), (320, True), (512, True),
                                     (200, False), (576, False), (12, False), (0, False)])
def test_chain_takes_mirrors_the_kernels_counts(c, takes):
    """csrc/chain_block.cu ``takes``: multiples of 8 or of 20 up to 128,
    multiples of 64 from 192 to 512."""
    assert chain.chain_takes(c) is takes


def test_first_block_predicates():
    assert chain.first_layer_takes(64, (64, 96)) and chain.first_layer_takes(8)
    assert not chain.first_layer_takes(12) and not chain.first_layer_takes(64, (64, 1024))
    assert not chain.first_layer_takes(64, (60, 96))
    assert chain.first_block_deep_takes(64, 64) and chain.first_block_deep_takes(64, 100)
    assert not chain.first_block_deep_takes(128, 64) and not chain.first_block_deep_takes(64, 256)
    assert not chain.first_block_deep_takes(12, 16)


@pytest.mark.parametrize("ci,co", VGGISH_CHANNELS + [(192, 64), (64, 256)])
def test_wide_apply_taps_are_laid_out_in_chunks_of_128(ci, co):
    """For a conv over 128 channels the apply's taps come in chunks of 128
    columns (taps.apply_chunk), one a grid column of the kernel; each chunk
    holds hi and lo of its columns, zeros past Ci; the prep's in chunks of
    32 of the 2*Co columns, over ceil(Ci / 8) slices."""
    rng = np.random.default_rng(ci + co)
    w = t(rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
    cv = chain.prep_inner_weights({"c": {"weight": w, "bias": t(rng.standard_normal(co))}},
                                  tvgg.LayerSpec("conv", "c", {}), {"gamma": 0.15})
    assert cv.apply_cols == (128 if max(ci, co) > 128 else taps.wg_cols(ci))
    assert cv.w_apply_wg.shape == (-(-ci // cv.apply_cols), co // 8, 2, 9, 2, cv.apply_cols, 4)
    assert cv.w_prep_wg.shape == (2 * co // 32, ci // 8, 2, 9, 2, 32, 4)
    w_apply = cv.wz1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, co, ci)
    full = cv.w_apply_wg.permute(2, 3, 1, 4, 6, 0, 5).reshape(2, 9, co, -1)
    hi = taps.tf32(w_apply)
    assert torch.equal(full[0, :, :, :ci], hi)
    assert torch.equal(full[1, :, :, :ci], taps.tf32(w_apply - hi))
    if full.shape[-1] > ci:
        assert full[:, :, :, ci:].abs().max().item() == 0.0


def test_counts_the_kernels_refuse_take_the_plain_walk():
    """At filters (12, 12, 24, 24, 24), counts no chain kernel takes,
    plan_chain refuses the section, fused_gamma.takes refuses its
    12-channel convs, and the port's heatmaps (the plain tiled walk) still match the JAX
    package's on the CPU."""
    filters = (12, 12, 24, 24, 24)
    jcfg = dataclasses.replace(jvgg.toy_config(), n_filters=filters)
    tcfg = dataclasses.replace(tvgg.toy_config(), n_filters=filters)
    jspecs = jvgg.build_layer_specs(jcfg)
    jparams = jit_init_params(jspecs, 3)
    tspecs = tvgg.build_layer_specs(tcfg)
    tparams = from_jax_params(to_np(jparams), device="cpu")
    U = signed_permutation(5, 24)
    jsp = j_insert(jspecs, 10, jnp.asarray(U), 4, input_size=(64, 64))
    tsp = t_insert(tspecs, 10, t(U), 4, input_size=(64, 64))
    comp = texp.class_composite(LRP_NAME_MAP_TOY, 4)
    conv_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    assert chain.plan_chain(conv_sec, tparams, comp, fine_hw=(64, 64)) is None
    # gamma_nonneg.cu takes Co in multiples of 8 or 20: not the 12-channel convs
    twelve = [s for s in conv_sec if s.kind == "conv" and s.config["out_ch"] == 12]
    assert len(twelve) == 2
    assert not any(fused_gamma.takes(engine.LayerOp(s, tparams)) for s in twelve)
    x = np.random.default_rng(4).standard_normal((2, 1, 64, 64)).astype(np.float32)
    want, want_logits = jexp.subspace_heatmaps(jsp, jparams, jnp.asarray(x),
                                               jexp.class_composite(LRP_NAME_MAP_TOY, 4), 4,
                                               class_idx=1)
    got, logits = texp.subspace_heatmaps(tsp, tparams, t(x), comp, 4, class_idx=1)
    assert_close_lrp(got.numpy(), np.asarray(want))
    assert_close_lrp(logits.numpy(), np.asarray(want_logits))


# A small framing of VGGish's for the service test: 32 bands of 48 frames
# (400 + 47 * 160 samples), the rest of the front-end as published.
SMALL = {"n_mels": 32, "mel_width": 48, "clip_samples": 400 + 47 * 160}


def test_service_matches_the_reference_at_published_widths(monkeypatch):
    """ExplainerService at VGGish's published channel counts (64 ... 512,
    fc 4096, 4096, 128) on 32 x 48 log-mels, b=2, K=4, seeded weights, a
    signed-permutation U, on the CPU (the plain chain versions, as
    plan_chain accepts the section), against the reference LRP on the same
    weights. The tolerances are tests/test_torch_serving.py's
    (assert_close_lrp: rtol 1e-4, atol 1e-5 of the largest |value|; the
    concepts' order exact): the two walk the same algebra in another
    order, NHWC against NCHW, the chain's clone-shared denominators against
    the reference's per clone."""
    cfg = {**CONFIG, **SMALL}
    monkeypatch.setitem(tconst.FRONTEND_PARAMS, "vggish",
                        {**tconst.FRONTEND_PARAMS["vggish"], **SMALL})
    params, _ = pb_model.draw(cfg, 2 ** 31 + 7, "cpu")
    U = t(signed_permutation(9, 512))
    specs = tvgg.build_layer_specs(dataclasses.replace(tvgg.vggish_config(), input_size=(32, 48)))
    theirs = {n: {k: v.clone() for k, v in p.items()} for n, p in params.items()}
    rules = [(n, (r, dict(kw))) for n, r, kw in cfg["rules"]]
    svc = ExplainerService(specs, theirs, rules, {"jazz": U.numpy()}, 4, 14, case="vggish",
                           class_idx_mapper={c: i for i, c in enumerate(cfg["classes"])},
                           device="cpu")
    calls = []
    monkeypatch.setattr(chain, "chain_block",
                        lambda *a, **k: calls.append(1) or chain.chain_block_plain(*a, **k))
    wavs = _noise(2, SMALL["clip_samples"], 13)
    got = svc.explain(wavs.numpy(), "jazz")
    assert len(calls) == 3                     # the chain ran, not the tiled walk
    ref_model = ref_lrp.Model(cfg, params)
    mel = ref_frontend.features(wavs, cfg)
    heat, logits = ref_model.explain(mel[:, None], U, cfg["classes"].index("jazz"))
    heat, logits = heat.numpy(), logits.numpy()
    rel = heat[:, 1:].sum(axis=(-2, -1))
    order = np.argsort(rel, axis=-1)[:, ::-1]
    rows = np.arange(2)[:, None]
    np.testing.assert_array_equal(got["mask"], order)
    assert_close_lrp(got["logits"], logits)
    assert_close_lrp(got["standard_heatmaps"][:, 0], heat[:, 0])
    assert_close_lrp(got["subspace_heatmaps"], heat[:, 1:][rows, order])
    assert_close_lrp(got["subspace_relevances"], rel[rows, order])
