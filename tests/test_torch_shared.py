"""The port's shared-denominator explain path, its clone_chunk path and the
NCHW recording of the lower segment against the JAX package, and the shared
path against the port's default chain path. On the CPU the gamma rule of
every 3x3 conv runs rules.shared_gamma_nonneg's plain version. Tolerance for
LRP outputs: rtol 1e-4, atol 1e-5 * max|ref| (assert_close_lrp); U is a
signed permutation (see test_torch_serving.py), and each input holds no
max-pool window within POOL_MARGIN of a tie in the JAX forward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.lrp import engine as teng
from drsa_audio_tpu_torch.xai.lrp import rules as trules
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, signed_permutation, t, tie_margins)

# name -> (batch, numpy seed of the mel input); pool margins 7.0e-6 (toy,
# 14x POOL_MARGIN) and 1.9e-6 (3s, 1.9x POOL_MARGIN, 8x the largest flip
# seen) in the JAX forward with U = signed_permutation(3, d)
INPUTS = {"toy": (2, 1), "gtzan3s": (1, 0)}


def _case(name):
    jspecs, jparams, tspecs, tparams, nm, layer, d, hw, _ = both_models(name)
    U = signed_permutation(3, d)
    jsp = j_insert(jspecs, layer, jnp.asarray(U), 4, input_size=hw)
    tsp = t_insert(tspecs, layer, t(U), 4, input_size=hw)
    b, seed = INPUTS[name]
    x = np.random.default_rng(seed).standard_normal((b, 1) + hw).astype(np.float32)
    margins = tie_margins(jsp, jparams, x)
    assert margins[0] >= POOL_MARGIN[name], margins
    return (jsp, jparams, jexp.class_composite(nm, 4), tsp, tparams,
            texp.class_composite(nm, 4), x)


def _both(name, **kw):
    jsp, jparams, jcomp, tsp, tparams, tcomp, x = _case(name)
    want = jexp.subspace_heatmaps(jsp, jparams, jnp.asarray(x), jcomp, 4, class_idx=0, **kw)
    got = texp.subspace_heatmaps(tsp, tparams, t(x), tcomp, 4, class_idx=0, **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", ["toy", "gtzan3s"])
def test_shared_path_matches_jax(name):
    (heat, logits), (want_heat, want_logits) = _both(name, shared_denominators=True)
    assert heat.shape == want_heat.shape
    assert_close_lrp(heat, want_heat)
    assert_close_lrp(logits, want_logits)


@pytest.mark.parametrize("name,chunk,nhwc", [("toy", 1, True), ("toy", 2, True),
                                             ("toy", 2, False), ("gtzan3s", 2, True)])
def test_clone_chunk_matches_jax(name, chunk, nhwc):
    """clone_chunk with the chain off (fused=False), in both layouts: the
    chain takes precedence over clone_chunk where it accepts the model."""
    (heat, _), (want, _) = _both(name, clone_chunk=chunk, nhwc=nhwc, fused=False)
    assert_close_lrp(heat, want)


@pytest.mark.parametrize("name", ["toy", "gtzan3s"])
def test_shared_path_matches_default_chain(name):
    _, _, _, tsp, tparams, tcomp, x = _case(name)
    shared, _ = texp.subspace_heatmaps(tsp, tparams, t(x), tcomp, 4, class_idx=0,
                                       shared_denominators=True)
    default, _ = texp.subspace_heatmaps(tsp, tparams, t(x), tcomp, 4, class_idx=0)
    assert torch.isfinite(shared).all()
    assert_close_lrp(shared.numpy(), default.numpy())
    std = shared[:, 0].numpy()
    np.testing.assert_allclose(std, shared[:, 1:].sum(dim=1).numpy(), rtol=1e-5,
                               atol=1e-6 * np.abs(std).max())


def test_forward_upper_nchw_acts_match_jax():
    jsp, jparams, jcomp, tsp, tparams, tcomp, x = _case("toy")
    R_j, acts_j, _ = jexp.explain_forward_upper(jsp, jparams, jnp.asarray(x), jcomp,
                                                class_idx=0, nhwc=False)
    R_t, acts_t, _ = texp.explain_forward_upper(tsp, tparams, t(x), tcomp, class_idx=0,
                                                nhwc=False)
    assert len(acts_t) == len(acts_j) == len(texp._split_at_filter(tsp)[0])
    for a_t, a_j in zip(acts_t, acts_j):
        a_j = np.asarray(a_j)
        assert a_t.shape == a_j.shape
        np.testing.assert_allclose(a_t.numpy(), a_j, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(a_j).max()))
    assert_close_lrp(R_t.numpy(), np.asarray(R_j))


def test_argument_errors_match_jax():
    """NHWC activations with shared denominators, and the chain without NHWC
    activations, are refused by both packages."""
    jsp, jparams, jcomp, tsp, tparams, tcomp, x = _case("toy")
    R_j, acts_j, _ = jexp.explain_forward_upper(jsp, jparams, jnp.asarray(x), jcomp,
                                                class_idx=0, nhwc=False)
    R_t, acts_t, _ = texp.explain_forward_upper(tsp, tparams, t(x), tcomp, class_idx=0,
                                                nhwc=False)
    for kw, msg in (({"shared_denominators": True, "nhwc": True}, "NCHW"),
                    ({"fused": True, "nhwc": False}, "nhwc=True")):
        with pytest.raises(ValueError, match=msg):
            jexp.explain_lower(jsp, jparams, acts_j, R_j, jcomp, 4, **kw)
        with pytest.raises(ValueError, match=msg):
            texp.explain_lower(tsp, tparams, acts_t, R_t, tcomp, 4, **kw)


def test_6s_shared_walk_rules():
    """On the folded 6s model at layer 33 the shared walk runs gamma_nonneg
    on the convs 3, 7, 10, 14, 17, 21, 24, 28 and 31 (9 kernel launches on
    the GPU) and wsquare on conv 0, as the JAX package specializes them."""
    _, _, tspecs, tparams, nm, layer, d, hw, _ = both_models("gtzan6s")
    tsp = t_insert(tspecs, layer, t(signed_permutation(3, d)), 4, input_size=hw)
    lower, _ = texp._split_at_filter(tsp)
    comp = texp.class_composite(nm, 4)
    rules = {s.name: teng._specialize_rule(comp.rule_for(s.name)[0], lower, i)
             for i, s in enumerate(lower) if s.kind == "conv"}
    assert rules == {"features.0": "wsquare",
                     **{f"features.{i}": "gamma_nonneg"
                        for i in (3, 7, 10, 14, 17, 21, 24, 28, 31)}}
    assert all(trules.SHARED_RULES[r] for r in rules.values())
