"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: the same model, weights and inputs in both, passed as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from drsa_audio_tpu.models import projection as jproj
from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.ops import frontend as jfe
from drsa_audio_tpu.utils import constants as jconst
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.utils.convert import from_jax_params

# name -> (config fn name, name map, DRSA layer, d, mel size, case)
MODELS = {
    "toy": ("toy_config", "LRP_NAME_MAP_TOY", 10, 16, (64, 64), "toy"),
    "gtzan3s": ("gtzan_3s_config", "LRP_NAME_MAP_GTZAN", 10, 64, (128, 128), "gtzan"),
    "gtzan6s": ("gtzan_6s_config", "LRP_NAME_MAP_GTZAN_6S", 33, 128, (128, 256), "gtzan_6s"),
}


def to_np(jparams) -> dict:
    return jax.tree_util.tree_map(np.asarray, jparams)


def random_bn(jparams: dict, seed: int) -> dict:
    """The JAX params with random BatchNorm scale, bias, mean and var drawn
    with numpy, so that folding them is not the identity."""
    rng = np.random.default_rng(seed)
    out = dict(jparams)
    for name, p in jparams.items():
        if "var" in p:
            ch = p["var"].shape[0]
            draw = {"scale": rng.uniform(0.5, 1.5, ch), "bias": rng.normal(0.0, 0.1, ch),
                    "mean": rng.normal(0.0, 0.1, ch), "var": rng.uniform(0.5, 2.0, ch)}
            out[name] = {k: jnp.asarray(v.astype(np.float32)) for k, v in draw.items()}
    return out


def jit_init_params(jspecs, seed: int) -> dict:
    """jvgg.init_params under one jit, in about half its time on the CPU:
    the same values as the eager call (threefry draws the same bits), and
    the layers in the layer list's order, as the eager call gives them (a
    jit returns a dict's keys sorted; random_bn draws in the dict's order)."""
    out = jax.jit(lambda k: jvgg.init_params(jspecs, k))(jax.random.PRNGKey(seed))
    return {s.name: out[s.name] for s in jspecs if s.name in out}


def both_models(name: str, seed: int = 0):
    """(JAX specs, JAX params, port specs, port params on the CPU, name map,
    layer, d, hw, case) with the port's weights bridged from the JAX ones.
    A model with BatchNorm (the 6s one) gets random BN statistics and is
    folded, as its callers fold it before they explain: the JAX package
    folds its params and the port takes them through the bridge."""
    cfg_fn, nm, layer, d, hw, case = MODELS[name]
    jspecs = jvgg.build_layer_specs(getattr(jvgg, cfg_fn)())
    jparams = jit_init_params(jspecs, seed)
    tspecs = tvgg.build_layer_specs(getattr(tvgg, cfg_fn)())
    if getattr(jvgg, cfg_fn)().conv_bn:
        jparams = random_bn(jparams, seed)
        tspecs, _ = tvgg.fold_batchnorm(tspecs, from_jax_params(to_np(jparams), device="cpu"))
        jspecs, jparams = jvgg.fold_batchnorm(jspecs, jparams)
    tparams = from_jax_params(to_np(jparams), device="cpu")
    return jspecs, jparams, tspecs, tparams, getattr(jconst, nm), layer, d, hw, case


def assert_close_lrp(got, want):
    """The JAX package's own fused-vs-tiled bound (tests/test_pallas_chain.py):
    rtol 1e-4, atol 1e-5 * max|ref|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


# Smallest pool margin (tie_margins) that a cross-framework parity test's
# input must hold, per model, relative to the pooled tensor's maximum. The
# scan at the end of this file (service inputs, U = signed_permutation(11))
# counts the windows that the two packages' forwards route differently:
# toy (b=2, seeds 0-199) flipped at gaps up to 1.2e-7 and gtzan3s (b=1,
# seeds 0-199) up to 2.3e-7, so their thresholds are about 4x that. gtzan6s
# (b=1, seeds 0-299) flipped at gaps up to 3.3e-7, and once at 2.2e-6 (seed
# 35, whose two log-mels differ by 6.3e-5 in log10 units); no 6s input of
# the scan holds more than 5.1e-7 (seed 14), so its threshold is 4e-7,
# above every flip seen but that one.
POOL_MARGIN = {"toy": 5e-7, "gtzan3s": 1e-6, "gtzan6s": 4e-7}


def _windows(a: np.ndarray, kh: int, kw: int) -> np.ndarray:
    b, c, H, W = a.shape
    return a.reshape(b, c, H // kh, kh, W // kw, kw).transpose(
        0, 1, 2, 4, 3, 5).reshape(b, c, H // kh, W // kw, kh * kw)


def tie_margins(jspecs_proj, jparams, x) -> tuple[float, float]:
    """The precondition of a parity test between the two packages' forwards,
    from the JAX forward's recorded activations (NCHW, every layer of
    ``jspecs_proj`` on input ``x``):

    - pool: the smallest gap between the two largest entries of a max-pool
      window, over every window whose maximum is positive, relative to the
      maximum of that pool's input. Below the frameworks' float32 round-off
      the first argmax can differ, and the window's relevance then lands on
      another pixel;
    - relu: the smallest |pre-activation| at a relu gate, relative to that
      input's maximum. The tests report it with the pool margin but set no
      threshold on it: every rule above a relu multiplies by the relu's
      output, so a sign flip at |a| = m moves relevance of order m only.
    """
    pool = relu = np.inf
    h = jnp.asarray(x)
    for spec in jspecs_proj:
        a = np.asarray(h)
        if spec.kind == "maxpool":
            win = np.sort(_windows(a, *spec.config["kernel"]), axis=-1)
            live = win[..., -1] > 0
            if live.any():
                gap = (win[..., -1] - win[..., -2])[live]
                pool = min(pool, float(gap.min() / np.abs(a).max()))
        elif spec.kind == "relu":
            relu = min(relu, float(np.abs(a).min() / np.abs(a).max()))
        h = jvgg.apply_layer(spec, jparams, h, train=False)
    return pool, relu


def _service_inputs(jspecs, layer: int, U, wavs, case: str):
    cfg = jfe.FrontendConfig.for_case(case)
    mels = jfe.logmel(jfe.peak_normalize(jnp.asarray(wavs)), cfg)[:, None]
    jsp = jproj.insert_projection(jspecs, layer, jnp.asarray(U), 4,
                                  input_size=(cfg.n_mels, cfg.width))
    return jsp, mels


def service_margins(jspecs, jparams, layer: int, U, wavs, case: str):
    """tie_margins of a service request: the JAX front-end's mels through
    the JAX model with the projection at ``layer``."""
    jsp, mels = _service_inputs(jspecs, layer, U, wavs, case)
    return tie_margins(jsp, jparams, mels)


def route_agreement(jsp, jparams, tsp, tparams, xj, xt) -> tuple[int, float, float]:
    """Both packages' forwards side by side (JAX on ``xj``, the port on
    ``xt``): the number of live max-pool windows whose first argmax differs,
    the largest top-two gap among them (relative, as in tie_margins), and
    the smallest ratio, over live windows, of the JAX top-two gap to the
    change of that gap in the port's forward (below 1 the window can flip).
    Measured on the host that runs it; the scan below reports it."""
    flips, flip_gap, ratio = 0, 0.0, np.inf
    hj, ht = jnp.asarray(xj), torch.as_tensor(np.asarray(xt))
    for sj, st in zip(jsp, tsp):
        if sj.kind == "maxpool":
            wj, wt = (_windows(np.asarray(a), *sj.config["kernel"]) for a in (hj, ht))
            order = np.argsort(wj, axis=-1)[..., -2:]
            top2_j, top2_t = (np.take_along_axis(w, order, -1) for w in (wj, wt))
            gap = top2_j[..., 1] - top2_j[..., 0]
            change = np.abs(top2_t[..., 1] - top2_t[..., 0] - gap)
            live = top2_j[..., 1] > 0
            flipped = (wj.argmax(-1) != wt.argmax(-1)) & live
            flips += int(flipped.sum())
            if flipped.any():
                flip_gap = max(flip_gap, float(gap[flipped].max() / np.abs(wj).max()))
            if live.any():
                ratio = min(ratio, float((gap / np.maximum(change, 1e-30))[live].min()))
        hj = jvgg.apply_layer(sj, jparams, hj, train=False)
        with torch.no_grad():
            ht = tvgg.apply_layer(st, tparams, ht)
    return flips, flip_gap, ratio


def signed_permutation(seed: int, d: int) -> np.ndarray:
    """An orthogonal U whose products are exact in float32: the inverse
    projection then rebuilds exact relu zeros as exact zeros in both
    frameworks (see the note in test_torch_serving.py)."""
    rng = np.random.default_rng(seed)
    U = np.zeros((d, d), np.float32)
    U[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    return U


if __name__ == "__main__":
    # Scan service inputs for POOL_MARGIN: per numpy seed of the waveforms,
    # the JAX forward's tie margins, the windows the port routes otherwise
    # with the largest gap among them, route_agreement's ratio, and the
    # largest difference of the two packages' log-mels. From the repository
    # root:
    #   PYTHONPATH=. python tests/test_torch_util.py gtzan6s 1 0 300  # model, batch, seeds
    import sys

    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.ops import frontend as tfe

    jax.config.update("jax_platforms", "cpu")
    name, b, first, last = sys.argv[1], *map(int, sys.argv[2:5])
    jspecs, jparams, tspecs, tparams, _, layer, d, hw, case = both_models(name)
    U = signed_permutation(11, d)
    tsp = insert_projection(tspecs, layer, t(U), 4, input_size=hw)
    n = jfe.FrontendConfig.for_case(case)
    n = n.slice_length * n.sample_rate
    for seed in range(first, last):
        wavs = (np.random.default_rng(seed).standard_normal((b, n)) * 0.3).astype(np.float32)
        jsp, mj = _service_inputs(jspecs, layer, U, wavs, case)
        mt = tfe.logmel(tfe.peak_normalize(t(wavs)), tfe.FrontendConfig.for_case(case))[:, None]
        pool, relu = tie_margins(jsp, jparams, mj)
        flips, flip_gap, ratio = route_agreement(jsp, jparams, tsp, tparams, mj, mt)
        mel_diff = float(np.abs(np.asarray(mj) - mt.numpy()).max())
        print(f"{name} seed {seed}: pool margin {pool:.3g}, relu margin {relu:.3g}, "
              f"windows routed otherwise {flips} (largest gap {flip_gap:.3g}), "
              f"gap/change ratio {ratio:.3g}, log-mel difference {mel_diff:.3g}", flush=True)


# ------------------------------------------------ JAX's draws, for the port

def jax_toy_draws(keys, n_samples: int, config, wav_augment: bool, mel_augment: bool,
                  mask_param: int = 10) -> dict:
    """The draws of the JAX package's toy_augment_and_mel for each key, in
    its order (jax.random.split(key, 9), then fold_in(key, 1) for the mask),
    stacked in the port's draws format (numpy)."""
    r = jax.random
    ir_len = int(0.3 * config.sample_rate)     # the JAX reverb's decay_s * sample_rate
    per = []
    for key in keys:
        d = {}
        if wav_augment:
            ks = r.split(key, 9)
            d.update(gain_on=r.bernoulli(ks[0], 0.5), gain_db=r.uniform(ks[1], (), minval=-12.0, maxval=3.0),
                     delay_on=r.bernoulli(ks[2], 0.4), delay_ms=r.randint(ks[3], (), 50, 300),
                     reverb_on=r.bernoulli(ks[4], 0.3), reverb_ir=r.normal(ks[5], (ir_len,)),
                     noise_on=r.bernoulli(ks[6], 0.3), noise=r.normal(ks[7], (n_samples,)),
                     noise_ratio=r.uniform(ks[8], (), minval=1e-3, maxval=1e-1))
        if mel_augment:
            h, w = config.n_mels, config.width
            kc, k1, k2 = r.split(r.fold_in(key, 1), 3)
            k3, k4 = r.split(kc)
            d.update(mask_rows=r.bernoulli(kc, 0.5), n_r=r.randint(k1, (), 1, mask_param // 2 + 2),
                     r0=r.randint(k2, (), 0, h - mask_param // 2),
                     n_c=r.randint(k3, (), 1, mask_param + 2), c0=r.randint(k4, (), 0, w - mask_param))
        per.append(d)
    return {k: np.stack([np.asarray(d[k]) for d in per]) for k in per[0]} if per[0] else {}


def jax_gtzan_draws(keys, n_samples: int, config, wav_augment: bool, mel_augment: bool,
                    mask_param: int = 40) -> dict:
    """The draws of the JAX package's gtzan_augment_and_mel for each key, in
    its order (jax.random.split(key, 16); the masks split ks[14] in 4),
    stacked in the port's draws format (numpy)."""
    r = jax.random
    window = config.sample_rate * config.slice_length
    per = []
    for key in keys:
        ks = r.split(key, 16)
        d = {"start": r.randint(ks[0], (), 0, n_samples - window)}
        if wav_augment:
            d.update(gain_on=r.bernoulli(ks[1], 0.5), gain_db=r.uniform(ks[2], (), minval=-12.0, maxval=3.0),
                     semitones=r.uniform(ks[3], (), minval=-12.0, maxval=12.0),
                     pitch_on=r.bernoulli(ks[4], 0.3), use_low=r.bernoulli(ks[5], 0.5),
                     low_f=r.uniform(ks[6], (), minval=1400.0, maxval=4000.0),
                     high_f=r.uniform(ks[7], (), minval=200.0, maxval=1400.0),
                     filter_on=r.bernoulli(ks[8], 0.4), noise_on=r.bernoulli(ks[9], 0.3),
                     noise=r.normal(ks[10], (window,)),
                     noise_ratio=r.uniform(ks[11], (), minval=1e-3, maxval=1e-1))
        if mel_augment:
            d["rate"] = r.uniform(ks[12], (), minval=0.8, maxval=1.2)
        d["insert"] = r.randint(ks[13], (), 0, 1 << 20)
        if mel_augment:
            h, w = config.n_mels, config.width
            k1, k2, k3, k4 = r.split(ks[14], 4)
            d.update(n_rows=r.randint(k1, (), 1, mask_param // 2 + 1),
                     row0=r.randint(k2, (), 0, h - mask_param // 2),
                     n_cols=r.randint(k3, (), 1, mask_param + 1),
                     col0=r.randint(k4, (), 0, w - mask_param))
        per.append(d)
    return {k: np.stack([np.asarray(d[k]) for d in per]) for k in per[0]}


def torch_draws(draws: dict, device="cpu") -> dict:
    """Numpy draws as the port's tensors: integers as int64."""
    out = {}
    for k, v in draws.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.long() if t.dtype in (torch.int32, torch.int64) else t
    return out
