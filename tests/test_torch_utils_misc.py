"""The port's small utility modules against the JAX package's, on the CPU:
profiling, utilities, the analytic flattened size, the 'torch' init
scheme, cast_params, and the conversion of the reference's own torch
checkpoints (guides: tests/test_utils_misc.py, tests/test_convert.py).

Tolerances: logits of a reference-named torch VGG clone against the port's
and the JAX package's params from its state dict at rtol 1e-5, atol 1e-6 *
max|logit| (the same float32 model, summation orders apart); the export
round trip bit-equal; the init's empirical std within 5% of the uniform
law's (at least 1,024 draws a layer)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.utils import convert as jconv
from drsa_audio_tpu.utils import profiling as jprof
from drsa_audio_tpu.utils import utilities as jutil
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.utils import convert as tconv
from drsa_audio_tpu_torch.utils import profiling as tprof
from drsa_audio_tpu_torch.utils import utilities as tutil

CONFIGS = ("gtzan_3s_config", "gtzan_6s_config", "toy_config")


def test_phase_timer_matches_jax():
    timers = [jprof.PhaseTimer(), tprof.PhaseTimer()]
    for t in timers:
        for name in ("a", "a", "b"):
            with t.phase(name):
                pass
        t.totals.update({"a": 0.5, "b": 1.25})      # fixed times: the table's text
    assert timers[1].counts == timers[0].counts == {"a": 2, "b": 1}
    assert timers[1].summary() == timers[0].summary()
    assert timers[1].summary().splitlines()[1].startswith("b ")


def test_phase_timer_counts_a_failing_block():
    t = tprof.PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("x"):
            raise ValueError("boom")
    assert t.counts["x"] == 1 and t.totals["x"] >= 0.0


@pytest.mark.parametrize("value,decimals", [(3.79, 1), ((29 - 3) / 7, 1), (2.5, 0),
                                            (1.23456, 3), (-0.15, 1)])
def test_round_down_matches_jax(value, decimals):
    assert tutil.round_down(value, decimals) == jutil.round_down(value, decimals)


def test_hidden_prints(capsys):
    with tutil.HiddenPrints():
        print("should not appear")
    print("visible")

    @tutil.HiddenPrints()
    def noisy():
        print("also hidden")
        return 3

    assert noisy() == 3
    out = capsys.readouterr().out
    assert "should not appear" not in out and "also hidden" not in out
    assert "visible" in out


def test_trace_and_annotate_write_a_trace_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir):
        with tprof.annotate("matmul_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert "matmul_region" in open(os.path.join(log_dir, files[0])).read()


@pytest.mark.parametrize("name", CONFIGS)
def test_conv_out_shape_matches_jax_on_the_configs(name):
    cfg = getattr(tvgg, name)()
    kw = dict(input_size=cfg.input_size, pool_kernels=cfg.pool_kernels,
              out_filters=cfg.n_filters[-1], block_depth=cfg.block_depth)
    got = tvgg.conv_out_shape(**kw)
    assert got == jvgg.conv_out_shape(**kw) == cfg.flat_features


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_conv_out_shape_matches_jax_on_a_grid(padding):
    for hw in ((64, 64), (96, 200), (128, 256)):
        for pools in (((2, 2),) * 3, ((2, 4), (3, 2)), ((4, 4),)):
            for depth in (1, 2):
                for stride in (1, 2):
                    kw = dict(input_size=hw, pool_kernels=pools, conv_kernel=(3, 3),
                              out_filters=16, padding=padding, stride=stride,
                              block_depth=depth)
                    assert tvgg.conv_out_shape(**kw) == jvgg.conv_out_shape(**kw), kw


def _fan_in(spec):
    c = spec.config
    return c["in_ch"] * c["kernel"][0] * c["kernel"][1] if spec.kind == "conv" else c["in_f"]


@pytest.mark.parametrize("name", CONFIGS)
def test_init_params_torch_scheme_matches_jax_bounds(name):
    """Under scheme='torch' every weight lies within JAX's bound sqrt(3 *
    (2/6) / fan_in) (torch's a=sqrt(5) default), every bias within
    1/sqrt(fan_in), and a layer's empirical std is the uniform law's
    bound/sqrt(3) within 5%, as the JAX package's draws are."""
    tspecs = tvgg.build_layer_specs(getattr(tvgg, name)())
    jspecs = jvgg.build_layer_specs(getattr(jvgg, name)())
    tp = tvgg.init_params(tspecs, 0, device="cpu", scheme="torch")
    jp = jax.jit(lambda k: jvgg.init_params(jspecs, k, scheme="torch"))(jax.random.PRNGKey(0))
    checked = 0
    for spec in tspecs:
        if spec.kind not in ("conv", "linear"):
            continue
        bound = np.sqrt(3.0 * (2.0 / 6.0) / _fan_in(spec))
        for w, b in ((tp[spec.name]["weight"].numpy(), tp[spec.name]["bias"].numpy()),
                     (np.asarray(jp[spec.name]["w"]), np.asarray(jp[spec.name]["b"]))):
            assert np.abs(w).max() <= bound * (1 + 1e-6)
            assert np.abs(b).max() <= 1.0 / np.sqrt(_fan_in(spec)) * (1 + 1e-6)
            if w.size >= 1024:
                assert abs(w.std() / (bound / np.sqrt(3.0)) - 1.0) < 0.05, spec.name
                checked += 1
    assert checked >= 2


def test_init_params_he_scheme_is_the_default_and_unknown_raises():
    specs = tvgg.build_layer_specs(tvgg.toy_config())
    a = tvgg.init_params(specs, 3, device="cpu")
    b = tvgg.init_params(specs, 3, device="cpu", scheme="he")
    assert all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])
    w = a["features.3"]["weight"]
    assert w.abs().max().item() <= np.sqrt(6.0 / (8 * 9)) * (1 + 1e-6)
    with pytest.raises(ValueError, match="scheme"):
        tvgg.init_params(specs, 3, device="cpu", scheme="xavier")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_cast_params_casts_weights_and_keeps_batchnorm(dtype):
    specs = tvgg.build_layer_specs(tvgg.gtzan_6s_config())
    params = tvgg.init_params(specs, 0, device="cpu")
    out = tvgg.cast_params(params, dtype)
    for spec in specs:
        if spec.kind in ("conv", "linear"):
            assert {v.dtype for v in out[spec.name].values()} == {dtype}
            assert torch.equal(out[spec.name]["weight"].float(),
                               params[spec.name]["weight"].to(dtype).float())
        elif spec.kind.startswith("batchnorm"):
            assert out[spec.name] is params[spec.name]
    assert params["features.0"]["weight"].dtype == torch.float32


# ------------------------------------------------- reference checkpoints

def build_torch_model(cfg):
    """Reference-architecture torch model with the reference's module names
    (a copy of build_torch_model in tests/test_convert.py)."""
    feats = []
    in_ch = 1
    for block, filters in enumerate(cfg.n_filters):
        for d in range(cfg.block_depth):
            feats.append(nn.Conv2d(in_ch if d == 0 else filters, filters,
                                   cfg.conv_kernel, padding="same"))
            if cfg.conv_bn:
                feats.append(nn.BatchNorm2d(filters))
            feats.append(nn.ReLU())
        feats.append(nn.MaxPool2d(tuple(cfg.pool_kernels[block])))
        in_ch = filters

    head = []
    n_in = cfg.flat_features
    for _ in range(cfg.dense_depth):
        head.append(nn.Linear(n_in, cfg.n_dense))
        if cfg.dense_bn:
            head.append(nn.BatchNorm1d(cfg.n_dense))
        head.append(nn.ReLU())
        if cfg.dropout:
            head.append(nn.Dropout(cfg.dropout))
        n_in = cfg.n_dense
    head.append(nn.Linear(n_in, cfg.n_classes))

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.features = nn.Sequential(*feats)
            self.classifier = nn.Sequential(*head)

        def forward(self, x):
            x = self.features(x)
            x = x.reshape(x.shape[0], -1)
            return self.classifier(x)

    return M()


@pytest.fixture(scope="module", params=CONFIGS)
def reference_model(request):
    """(config name, torch clone in eval mode with random BN statistics, its
    logits on two seeded inputs, the inputs)."""
    torch.manual_seed(0)
    cfg = getattr(tvgg, request.param)()
    tm = build_torch_model(cfg).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    x = np.random.default_rng(0).standard_normal((2, 1) + tuple(cfg.input_size)).astype(
        np.float32)
    with torch.no_grad():
        ref = tm(torch.as_tensor(x)).numpy()
    return request.param, tm, ref, x


def test_params_from_state_dict_matches_jax_and_the_reference(reference_model):
    name, tm, ref, x = reference_model
    tspecs = tvgg.build_layer_specs(getattr(tvgg, name)())
    jspecs = jvgg.build_layer_specs(getattr(jvgg, name)())
    sd = tm.state_dict()
    tp = tconv.params_from_state_dict(sd, tspecs, device="cpu")
    jp = jconv.params_from_state_dict(sd, jspecs)
    with torch.no_grad():
        got = tvgg.forward(tspecs, tp, torch.as_tensor(x)).numpy()
    want = np.asarray(jvgg.forward(jspecs, jp, jnp.asarray(x)))
    for other in (want, ref):
        np.testing.assert_allclose(got, other, rtol=1e-5, atol=1e-6 * np.abs(other).max())
    # the port's params hold the state dict's values, copied
    assert all(torch.equal(tp[n][k], sd[f"{n}.{k}"]) for n in tp for k in tp[n])
    assert tp["features.0"]["weight"].data_ptr() != sd["features.0.weight"].data_ptr()


def test_state_dict_from_params_round_trips_bit_equal(reference_model):
    name, tm, ref, x = reference_model
    specs = tvgg.build_layer_specs(getattr(tvgg, name)())
    sd = tm.state_dict()
    out = tconv.state_dict_from_params(tconv.params_from_state_dict(sd, specs, device="cpu"),
                                       specs)
    assert set(out) == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert all(isinstance(v, np.ndarray) and np.array_equal(v, sd[k].numpy())
               for k, v in out.items())
    assert set(out) == set(jconv.state_dict_from_params(
        jconv.params_from_state_dict(sd, jvgg.build_layer_specs(getattr(jvgg, name)())),
        jvgg.build_layer_specs(getattr(jvgg, name)())))
    clone = build_torch_model(getattr(tvgg, name)()).eval()
    clone.load_state_dict({k: torch.as_tensor(v) for k, v in out.items()}, strict=False)
    with torch.no_grad():
        assert np.array_equal(clone(torch.as_tensor(x)).numpy(), ref)


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_torch_checkpoint_reads_a_reference_file(tmp_path, wrapped):
    """A reference checkpoint holds the state dict beside the optimizer's
    state and numpy's and Python's RNG states (the reason for
    weights_only=False); a bare state dict loads too."""
    import random
    cfg = dataclasses.replace(tvgg.toy_config(), conv_bn=True)
    tm = build_torch_model(cfg).eval()
    path = str(tmp_path / "best_model_3.pth")
    blob = ({"model_state_dict": tm.state_dict(), "epoch": 3,
             "np_rng": np.random.get_state(), "py_rng": random.getstate()}
            if wrapped else tm.state_dict())
    torch.save(blob, path)
    specs = tvgg.build_layer_specs(cfg)
    params = tconv.load_torch_checkpoint(path, specs, device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 1, 64, 64)),
                        dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(tvgg.forward(specs, params, x), tm(x), rtol=1e-5,
                                   atol=1e-6)
    assert params["features.1"]["running_var"].shape == (8,)
