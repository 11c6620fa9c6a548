"""A configuration states its layer pattern (``blocks``, ``dense``) and its
front-end (``win_length``, ``f_min``, ``f_max``, ``triangles``, ``log``,
``center``, ``first_frame``, ``peak_normalize``, ``clip_samples``) as data.
The GTZAN configurations written out in that form give the same plan,
weights, program and reference as in their own form; a model of VGGish's
pattern runs through a whole cell; and the front-end with VGGish's keys is
VGGish's own (``vggish_input`` / ``mel_features``, transcribed below)."""

import time

import numpy as np
import pytest
import torch

from tests import tiny
from pb import model, program, work
from reference import frontend, lrp

NARROW = {"n_filters": [8, 8, 16, 16, 16], "subspace_dim": 16, "n_dense": 16}


def explicit(cfg: dict) -> dict:
    """``cfg`` with its layer pattern written as ``blocks`` and ``dense``
    and every front-end key at the value its absence stands for."""
    out = {k: v for k, v in cfg.items() if k not in tiny.OLD_KEYS}
    out["blocks"] = [{"filters": f, "depth": cfg["block_depth"], "pool": list(p)}
                     for f, p in zip(cfg["n_filters"], cfg["pool_kernels"])]
    out["dense"] = [{"out": cfg["n_dense"], "relu": True, "bn": cfg["dense_bn"],
                     "dropout": cfg["dropout"]} for _ in range(cfg["dense_depth"])]
    out.update(win_length=cfg["n_fft"], f_min=0.0, f_max=cfg["sample_rate"] / 2, triangles="hz",
               log="log10_clamp", center=True, first_frame=1, peak_normalize=True,
               clip_samples=cfg["slice_length"] * cfg["sample_rate"])
    return out


def _vgg_specs(cfg):
    """The specs the program's own build_layer_specs gives the configuration."""
    from drsa_audio_tpu_torch.models.vgg import VGGConfig, build_layer_specs
    return build_layer_specs(VGGConfig(
        n_filters=tuple(cfg["n_filters"]), conv_kernel=tuple(cfg["conv_kernel"]),
        pool_kernels=tuple(tuple(p) for p in cfg["pool_kernels"]), n_dense=cfg["n_dense"],
        n_classes=cfg["n_classes"], dropout=cfg["dropout"], block_depth=cfg["block_depth"],
        dense_depth=cfg["dense_depth"], input_size=(cfg["n_mels"], cfg["mel_width"]),
        conv_bn=cfg["conv_bn"], dense_bn=cfg["dense_bn"]))


def _old_logmel(wav, cfg):
    """The harness's front-end before it took the keys, line for line."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    x = torch.nn.functional.pad(wav[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    n = torch.arange(n_fft, dtype=torch.float64, device=wav.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / n_fft)).to(torch.float32)
    mag = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()
    fb = torch.as_tensor(frontend.htk_filterbank(n_fft // 2 + 1, cfg["n_mels"], cfg["sample_rate"]),
                         dtype=torch.float32, device=wav.device)
    mel = (mag @ fb).transpose(-1, -2)
    return torch.clamp(torch.log10(mel + 1e-7), min=-4.0)[..., 1:cfg["mel_width"] + 1]


def _noise(n, samples, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, samples, generator=g) * 0.3).clamp(-1, 1)


@pytest.mark.parametrize("name", ["gtzan3s", "gtzan6s"])
def test_the_explicit_form_gives_the_same_plan_weights_and_specs(name):
    cfg = tiny.config(name)
    ex = explicit(cfg)
    assert model.layer_plan(ex) == model.layer_plan(cfg)
    got, want = program.layer_specs(ex), _vgg_specs(cfg)
    assert got == want == program.layer_specs(cfg)
    assert [s.config for s in got] == [s.config for s in want]
    assert work.request_work(ex, 4) == work.request_work(cfg, 4)
    small, small_ex = {**cfg, **NARROW}, explicit({**cfg, **NARROW})
    p1, U1 = model.draw(small, 2 ** 31 + 3, "cpu")
    p2, U2 = model.draw(small_ex, 2 ** 31 + 3, "cpu")
    assert torch.equal(U1, U2) and p1.keys() == p2.keys()
    for n in p1:
        assert p1[n].keys() == p2[n].keys()
        assert all(torch.equal(p1[n][k], p2[n][k]) for k in p1[n])


@pytest.mark.parametrize("name", ["gtzan3s", "gtzan6s"])
def test_the_explicit_form_gives_the_same_reference(name):
    cfg = {**tiny.config(name), **NARROW}
    ex = explicit(cfg)
    params, U = model.draw(cfg, 11, "cpu")
    wavs = _noise(2, frontend.settings(cfg)["clip_samples"], 12)
    mel = frontend.features(wavs, cfg)
    assert torch.equal(mel, frontend.features(wavs, ex))
    assert torch.equal(mel, _old_logmel(frontend.peak_normalize(wavs), cfg))
    assert frontend.n_frames(cfg) == frontend.settings(cfg)["clip_samples"] // cfg["hop_length"] + 1
    with torch.no_grad():
        h1, l1 = lrp.Model(cfg, params).explain(mel[:, None], U[3], 3)
        h2, l2 = lrp.Model(ex, params).explain(mel[:, None], U[3], 3)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)


def test_a_model_of_vggishs_pattern_runs_a_whole_cell_correct():
    cfg = tiny.vggish_pattern()
    plan = model.layer_plan(cfg)
    convs = [ly for ly in plan if ly["kind"] == "conv"]
    assert [ly["out_ch"] for ly in convs] == [8, 8, 16, 16, 16, 16]
    assert [ly["name"] for ly in plan if ly["kind"] == "maxpool"] == [
        "features.2", "features.5", "features.10", "features.15"]
    assert [(ly["kind"], ly["name"]) for ly in plan if ly["name"].startswith("classifier")] == [
        ("linear", "classifier.0"), ("relu", "classifier.1"), ("linear", "classifier.2"),
        ("relu", "classifier.3"), ("linear", "classifier.4"), ("linear", "classifier.5")]
    assert plan[[ly["name"] for ly in plan].index("features.14")]["kind"] == "relu"
    c = tiny.cell("gtzan3s.serve_b256", batch=4)
    c["cfg"] = cfg
    res = tiny.run.run_cell(c, 2 ** 31 + 41, 1.0, False, device="cpu",
                            t_start=time.perf_counter(), info=lambda d: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


# --- VGGish's front-end, transcribed from mel_features.py and vggish_input.py

def _frame(data, window_length, hop_length):
    num_frames = 1 + int(np.floor((data.shape[0] - window_length) / hop_length))
    shape = (num_frames, window_length) + data.shape[1:]
    strides = (data.strides[0] * hop_length,) + data.strides
    return np.lib.stride_tricks.as_strided(data, shape=shape, strides=strides)


def _periodic_hann(window_length):
    return 0.5 - (0.5 * np.cos(2 * np.pi / window_length * np.arange(window_length)))


def _hertz_to_mel(frequencies_hertz):
    return 1127.0 * np.log(1.0 + (frequencies_hertz / 700.0))


def _spectrogram_to_mel_matrix(num_mel_bins, num_spectrogram_bins, audio_sample_rate,
                               lower_edge_hertz, upper_edge_hertz):
    nyquist_hertz = audio_sample_rate / 2.
    spectrogram_bins_mel = _hertz_to_mel(np.linspace(0.0, nyquist_hertz, num_spectrogram_bins))
    band_edges_mel = np.linspace(_hertz_to_mel(lower_edge_hertz),
                                 _hertz_to_mel(upper_edge_hertz), num_mel_bins + 2)
    mel_weights_matrix = np.empty((num_spectrogram_bins, num_mel_bins))
    for i in range(num_mel_bins):
        lower_edge_mel, center_mel, upper_edge_mel = band_edges_mel[i:i + 3]
        lower_slope = ((spectrogram_bins_mel - lower_edge_mel) / (center_mel - lower_edge_mel))
        upper_slope = ((upper_edge_mel - spectrogram_bins_mel) / (upper_edge_mel - center_mel))
        mel_weights_matrix[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    mel_weights_matrix[0, :] = 0.0
    return mel_weights_matrix


def _vggish_examples(data, sample_rate=16000):
    """vggish_input.waveform_to_examples for a float waveform at 16 kHz:
    [examples, 96 frames, 64 bands]."""
    window_length_samples = int(round(sample_rate * 0.025))
    hop_length_samples = int(round(sample_rate * 0.010))
    fft_length = 2 ** int(np.ceil(np.log(window_length_samples) / np.log(2.0)))
    frames = _frame(data, window_length_samples, hop_length_samples)
    spectrogram = np.abs(np.fft.rfft(frames * _periodic_hann(window_length_samples),
                                     int(fft_length)))
    mel = np.dot(spectrogram, _spectrogram_to_mel_matrix(64, spectrogram.shape[1], sample_rate,
                                                         125.0, 7500.0))
    log_mel = np.log(mel + 0.01)
    return _frame(log_mel, 96, 96)


def test_vggish_keys_give_vggishs_own_log_mel():
    cfg = {**tiny.config("gtzan3s"), **tiny.VGGISH_FRONTEND}
    assert frontend.settings(cfg)["clip_samples"] == 15600 and frontend.n_frames(cfg) == 96
    wavs = _noise(3, 15600, 21)
    got = frontend.features(wavs, cfg).double().numpy()
    assert got.shape == (3, 64, 96)
    for i in range(3):
        want = _vggish_examples(wavs[i].double().numpy())
        assert want.shape == (1, 96, 64)
        np.testing.assert_allclose(got[i], want[0].T, rtol=0, atol=2e-5)
    fb = frontend.filterbank(cfg)
    np.testing.assert_allclose(fb, _spectrogram_to_mel_matrix(64, 257, 16000, 125.0, 7500.0),
                               rtol=0, atol=1e-12)
    # without clip_samples a clip is slice_length seconds, a whole number of samples
    del cfg["clip_samples"]
    n = frontend.settings(cfg)["clip_samples"]
    assert n == 15360 and isinstance(n, int)


def test_vggish_keys_count_their_frontend_work():
    cfg = {**tiny.vggish_pattern(), **tiny.VGGISH_FRONTEND}
    w = work.request_work(cfg, 2)
    nnz = int(np.count_nonzero(frontend.filterbank(cfg)))
    assert w["frontend"] == work.kind("frontend")(2, 15600, 96, 512, 64, nnz)
