"""The port's merged-tail chain (merged_tail_plain, as the CPU runs it)
against the JAX package's merged Pallas chain (interpret mode), the port's
merged path against its default path, and the merge predicate against the
JAX package's. The switch is set through the module flags, with the
environment override cleared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.models.vgg import LayerSpec as JSpec
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu.xai.lrp import pallas_chain as pc
from drsa_audio_tpu.xai.lrp.engine import Composite as JComposite
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.lrp import chain as tchain
from drsa_audio_tpu_torch.xai.lrp.engine import Composite as TComposite
from test_torch_util import assert_close_lrp, both_models, signed_permutation, t

# DRSA layer -> subspace width (utils.constants SUBSPACE_DIMS_*)
DIMS = {"toy": {7: 16, 10: 16, 13: 16}, "gtzan3s": {7: 64, 10: 64, 13: 128},
        "gtzan6s": {33: 128}}


@pytest.fixture
def switch(monkeypatch):
    """Set both packages' merged-tail flag."""
    def set_(on: bool):
        monkeypatch.setattr(pc, "CHAIN_MERGED", on)
        monkeypatch.setattr(tchain, "CHAIN_MERGED", on)
    return set_


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def run(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, run)
    return calls


def _sections(name, layer):
    """Both packages' conv sections, with the projection at ``layer``."""
    jspecs, jparams, tspecs, tparams, nm, _, _, hw, _ = both_models(name)
    U = signed_permutation(3, DIMS[name][layer])
    jsp = j_insert(jspecs, layer, jnp.asarray(U), 4, input_size=hw)
    tsp = t_insert(tspecs, layer, t(U), 4, input_size=hw)
    j_sec, _ = jexp._conv_section(jexp._split_at_filter(jsp)[0])
    t_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    return jsp, jparams, j_sec, tsp, tparams, t_sec, nm, hw


@pytest.mark.parametrize("name,layer,b", [("toy", 10, 2), ("gtzan3s", 10, 1), ("toy", 7, 2)])
def test_merged_tail_plain_matches_jax_merged_chain(name, layer, b, rng, switch, monkeypatch):
    """The port's merged chain (merged_tail_plain on the CPU) against JAX
    fused_lower_conv_backward with CHAIN_MERGED on (its _merged_tail_kernel
    in interpret mode), on the same recorded activations and relevance.
    Layer 10 merges two convs, layer 7 one."""
    switch(True)
    jsp, jparams, j_sec, tsp, tparams, t_sec, nm, hw = _sections(name, layer)
    x = rng.standard_normal((b, 1) + hw).astype(np.float32)
    comp_j = jexp.class_composite(nm, 4)
    _, acts, _ = jexp.explain_forward_upper(jsp, jparams, jnp.asarray(x), comp_j,
                                            class_idx=0, nhwc=True)
    plan_j = pc.plan_chain(j_sec, jparams, comp_j, fine_hw=hw)
    d = DIMS[name][layer]
    R = rng.standard_normal((b, 4) + tuple(acts[-2].shape[1:3]) + (d,)).astype(np.float32)
    j_calls = _spy(monkeypatch, pc, "_merged_tail_kernel")
    want = np.asarray(pc.fused_lower_conv_backward(plan_j, jparams, list(acts[:-1]),
                                                   jnp.asarray(R), 4))
    assert j_calls, "the JAX chain did not take its merged path"

    plan_t = tchain.plan_chain(t_sec, tparams, texp.class_composite(nm, 4), fine_hw=hw)
    t_calls = _spy(monkeypatch, tchain, "merged_tail_plain")
    got = tchain.fused_lower_conv_backward(plan_t, tparams, [t(a) for a in acts[:-1]],
                                           t(R), 4)
    assert t_calls == ["merged_tail_plain"]
    assert got.shape == (b, 4) + hw
    assert_close_lrp(got.numpy(), want)


@pytest.mark.parametrize("name", ["toy", "gtzan3s"])
def test_merged_path_matches_default_path(name, rng, switch, monkeypatch):
    """subspace_heatmaps on the CPU with the switch on against the switch
    off: the service's path reaches the merged tail through
    fused_lower_conv_backward, and both walks agree."""
    _, _, _, tsp, tparams, _, nm, hw = _sections(name, 10)
    comp = texp.class_composite(nm, 4)
    x = t(rng.standard_normal((1, 1) + hw))
    switch(False)
    want, _ = texp.subspace_heatmaps(tsp, tparams, x, comp, 4, class_idx=0)
    switch(True)
    calls = _spy(monkeypatch, tchain, "merged_tail")
    got, _ = texp.subspace_heatmaps(tsp, tparams, x, comp, 4, class_idx=0)
    assert calls == ["merged_tail"]
    assert got.shape == (1, 5) + hw and torch.isfinite(got).all()
    assert_close_lrp(got.numpy(), want.numpy())


def _jax_merges(plan) -> bool:
    """The JAX package's merge predicate (pallas_chain.py:1066-1072, with its
    flags aside) on its own plan; no plan (its XLA path) merges nothing."""
    if plan is None:
        return False
    blocks = plan["blocks"]
    M = len(blocks) - 2
    P0 = blocks[0]["P"]
    return (len(blocks) >= 3 and len(blocks[0]["convs"]) == 1
            and all(len(blocks[i]["convs"]) == 1 for i in range(1, M + 1))
            and all(blocks[i]["P"] == P0 for i in range(1, M + 1))
            and all(blocks[i]["pool_above"][2] == 2 for i in range(M)))


def _hand_sections(layout, rng):
    """Both packages' conv sections, params and composites for a layout of
    convs ("c<ci>-<co>") and (2,2) pools ("p"), bottom-up."""
    j_sec, t_sec, jp, tp, rules = [], [], {}, {}, []
    for i, item in enumerate(layout):
        name = f"f{i}"
        if item == "p":
            j_sec.append(JSpec("maxpool", name, {"kernel": (2, 2)}))
            t_sec.append(tvgg.LayerSpec("maxpool", name, {"kernel": (2, 2)}))
            continue
        ci, co = (int(v) for v in item[1:].split("-"))
        w = rng.standard_normal((co, ci, 3, 3)).astype(np.float32)
        b = rng.standard_normal(co).astype(np.float32)
        jp[name], tp[name] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}, {"weight": t(w), "bias": t(b)}
        rules.append((name, ("flat", {}) if not rules else ("gamma", {"gamma": 0.5})))
        j_sec += [JSpec("conv", name, {}), JSpec("relu", name + "r", {})]
        t_sec += [tvgg.LayerSpec("conv", name, {}), tvgg.LayerSpec("relu", name + "r", {})]
    return (j_sec, jp, JComposite.from_list(rules)), (t_sec, tp, TComposite.from_list(rules))


@pytest.mark.parametrize("name,layer,merges", [
    ("gtzan3s", 10, True), ("toy", 10, True), ("gtzan3s", 7, True), ("toy", 7, True),
    ("gtzan3s", 13, False),     # block 3's 64-channel input packs at another factor
    ("toy", 13, False),
    ("gtzan6s", 33, False),     # two convs in block 0
])
def test_merge_predicate_matches_jax(name, layer, merges):
    _, jparams, j_sec, _, tparams, t_sec, nm, hw = _sections(name, layer)
    plan_j = pc.plan_chain(j_sec, jparams, jexp.class_composite(nm, 4), fine_hw=hw)
    plan_t = tchain.plan_chain(t_sec, tparams, texp.class_composite(nm, 4), fine_hw=hw)
    assert _jax_merges(plan_j) == merges
    assert tchain.mergeable(plan_t, tparams) == merges


@pytest.mark.parametrize("layout,merges", [
    (["c1-8", "p", "c8-8", "c8-8", "p", "c8-16", "p", "c16-16"], False),   # two-conv middle block
    (["c1-8", "p", "c8-8", "p", "c8-16", "p", "c16-16"], True),
    (["c1-8", "p", "c8-8"], False),                                        # two blocks
])
def test_merge_predicate_matches_jax_hand_built(layout, merges, rng):
    (j_sec, jp, jc), (t_sec, tp, tc) = _hand_sections(layout, rng)
    plan_j, plan_t = pc.plan_chain(j_sec, jp, jc), tchain.plan_chain(t_sec, tp, tc)
    assert plan_j is not None and plan_t is not None
    assert _jax_merges(plan_j) == merges
    assert tchain.mergeable(plan_t, tp) == merges
