"""LRP rules as modified-backward primitives (the port of
drsa_audio_tpu.xai.lrp.rules).

Each rule takes a layer operator (engine.LayerOp: the layer's forward with
modified parameters, its transpose ``vjp`` and ``bias_of``), the recorded
input activation ``x`` and the incoming relevance ``R``, and returns the
relevance at the layer input. The algebra is zennit 0.5.1's, term for term as
the JAX package computes it:

  epsilon       R_in = x * vjp(R / stab(f(x)))
  norm          R_in = x * vjp(R / stab(f(x; w, 0)))
  zplus         two-term positive/negative input split with clamped params
  gamma         four clamp combinations gated by the sign of f(x)
  gamma_nonneg  gamma on provably non-negative x (two terms; z_true derived)
  alphabeta     alpha * positive part - beta * negative part
  zbox          box-constrained input, bounds low <= x <= high
  wsquare       z = f(1; w^2, b^2);  R_in = vjp(R / stab(z))
  flat          z = f(1; 1, 0);      R_in = vjp(R / stab(z))
  pass          identity

The rules are linear in R for fixed activations, which the K-clone fold of
xai.explain relies on. The ``shared_*`` variants (SHARED_RULES) take x at
batch b and R at batch K*b: the modified forwards run once at b and only the
transposes run at K*b.
"""

from __future__ import annotations

import torch


def stabilize(z: torch.Tensor, epsilon: float) -> torch.Tensor:
    """z + eps * sign(z), with sign(0) := +1 (zennit Stabilizer)."""
    return z + torch.where(z >= 0, epsilon, -epsilon)


def _identity(p):
    return p


def _zero(p):
    return torch.zeros_like(p)


def _pos(p):
    return torch.clamp(p, min=0.0)


def _neg(p):
    return torch.clamp(p, max=0.0)


def _gmods(gamma: float):
    def gmod_pos(p):
        return p + gamma * torch.clamp(p, min=0.0)

    def gmod_neg(p):
        return p + gamma * torch.clamp(p, max=0.0)

    return gmod_pos, gmod_neg


def lrp_epsilon(layer, x, R, *, epsilon: float = 1e-6, **_):
    z = layer.forward(x)
    return x * layer.vjp(R / stabilize(z, epsilon), x)


def lrp_norm(layer, x, R, *, stabilizer: float = 1e-6, **_):
    z = layer.forward(x, _identity, _zero)
    return x * layer.vjp(R / stabilize(z, stabilizer), x)


def lrp_zplus(layer, x, R, *, stabilizer: float = 1e-6, **_):
    xp, xn = _pos(x), _neg(x)
    z1 = layer.forward(xp, _pos, _pos)    # (x+, w+, b+)
    z2 = layer.forward(xn, _neg, _zero)   # (x-, w-, 0)
    s = R / stabilize(z1 + z2, stabilizer)
    return xp * layer.vjp(s, x, _pos) + xn * layer.vjp(s, x, _neg)


def lrp_alphabeta(layer, x, R, *, alpha: float = 2.0, beta: float = 1.0,
                  stabilizer: float = 1e-6, **_):
    xp, xn = _pos(x), _neg(x)
    z1 = layer.forward(xp, _pos, _pos)    # (x+, w+, b+)
    z2 = layer.forward(xn, _neg, _zero)   # (x-, w-, 0)
    z3 = layer.forward(xp, _neg, _neg)    # (x+, w-, b-)
    z4 = layer.forward(xn, _pos, _zero)   # (x-, w+, 0)
    s_a = R / stabilize(z1 + z2, stabilizer)
    s_b = R / stabilize(z3 + z4, stabilizer)
    return (alpha * (xp * layer.vjp(s_a, x, _pos) + xn * layer.vjp(s_a, x, _neg))
            - beta * (xp * layer.vjp(s_b, x, _neg) + xn * layer.vjp(s_b, x, _pos)))


def lrp_zbox(layer, x, R, *, low: float = -1.0, high: float = 1.0,
             stabilizer: float = 1e-6, **_):
    """ZBox (zennit): z = f(x) - f(l; w+, b+) - f(h; w-, b-) with constant
    bounds l <= x <= h; R_in = x*c - l*c_l - h*c_h."""
    lo, hi = torch.full_like(x, low), torch.full_like(x, high)
    z = layer.forward(x) - layer.forward(lo, _pos, _pos) - layer.forward(hi, _neg, _neg)
    s = R / stabilize(z, stabilizer)
    return x * layer.vjp(s, x) - lo * layer.vjp(s, x, _pos) - hi * layer.vjp(s, x, _neg)


def lrp_gamma(layer, x, R, *, gamma: float = 0.25, stabilizer: float = 1e-6, **_):
    """Generalized gamma (zennit 0.5.1): handles negative inputs and outputs
    through four clamp combinations gated by the true output sign."""
    gp, gn = _gmods(gamma)
    xp, xn = torch.clamp(x, min=0.0), torch.clamp(x, max=0.0)
    z1 = layer.forward(xp, gp, gp)        # (x+, w + g*w+, b + g*b+)
    z2 = layer.forward(xn, gn, gn)        # (x-, w + g*w-, b + g*b-)
    z3 = layer.forward(xp, gn, _zero)     # (x+, w + g*w-, 0)
    z4 = layer.forward(xn, gp, _zero)     # (x-, w + g*w+, 0)
    z_true = layer.forward(x)
    s_pos = R * (z_true > 0.0).to(R.dtype) / stabilize(z1 + z2, stabilizer)
    s_neg = R * (z_true < 0.0).to(R.dtype) / stabilize(z3 + z4, stabilizer)
    return (xp * layer.vjp(s_pos, x, gp) + xn * layer.vjp(s_pos, x, gn)
            + xp * layer.vjp(s_neg, x, gn) + xn * layer.vjp(s_neg, x, gp))


def lrp_gamma_nonneg(layer, x, R, *, gamma: float = 0.25,
                     stabilizer: float = 1e-6, **_):
    """Gamma on non-negative x (post-ReLU / MaxPool): the x- terms vanish,
    but the x- bias still enters the positive denominator (z2). z_true is
    derived algebraically from z1 + z3 (w+ + w- = w), as the JAX package's
    grouped path does, so the output-sign masks flip where its masks flip."""
    gp, gn = _gmods(gamma)
    z1 = layer.forward(x, gp, gp)
    z3 = layer.forward(x, gn, _zero)
    bias1 = layer.bias_of(gp)
    z2 = layer.bias_of(gn)
    z_true = (z1 + z3 - bias1) / (2.0 + gamma) + layer.bias_of(_identity)
    s1 = R * (z_true > 0.0).to(R.dtype) / stabilize(z1 + z2, stabilizer)
    s3 = R * (z_true < 0.0).to(R.dtype) / stabilize(z3, stabilizer)
    return x * (layer.vjp(s1, x, gp) + layer.vjp(s3, x, gn))


def _square(p):
    return p * p


def _ones(p):
    return torch.ones_like(p)


def lrp_wsquare(layer, x, R, *, stabilizer: float = 1e-6, **_):
    ones = torch.ones_like(x)
    z = layer.forward(ones, _square, _square)
    return layer.vjp(R / stabilize(z, stabilizer), x, _square)


def lrp_flat(layer, x, R, *, stabilizer: float = 1e-6, **_):
    ones = torch.ones_like(x)
    z = layer.forward(ones, _ones, _zero)
    return layer.vjp(R / stabilize(z, stabilizer), x, _ones)


def lrp_pass(layer, x, R, **_):
    return R


def lrp_subspace_mask(layer, x, R, *, num_concepts: int = 4, **_):
    """SubspaceHook equivalent (reference attribute.py:42-60): R is
    [batch*(K+1), n, K, d_k]; clone 0 keeps everything, clone k keeps only
    subspace k."""
    k = num_concepts
    b_total, n, kk, d_k = R.shape
    R = R.reshape(-1, k + 1, n, kk, d_k)
    eye = torch.eye(k, dtype=R.dtype, device=R.device)[None, :, None, :, None]
    return torch.cat([R[:, :1], R[:, 1:] * eye], dim=1).reshape(b_total, n, kk, d_k)


RULES = {
    "epsilon": lrp_epsilon,
    "gamma": lrp_gamma,
    "gamma_nonneg": lrp_gamma_nonneg,
    "zplus": lrp_zplus,
    "alphabeta": lrp_alphabeta,
    "flat": lrp_flat,
    "wsquare": lrp_wsquare,
    "norm": lrp_norm,
    "zbox": lrp_zbox,
    "pass": lrp_pass,
    "subspace_mask": lrp_subspace_mask,
}


# --------------------------------------------------------------------------
# Shared-activation variants: K relevance clones over ONE activation batch.
# The clones share every activation, so each rule's denominators and sign
# masks are computed once at batch b and broadcast onto R [K*b, ...]
# (clone-major); only the transposes run at K*b. A layer's transpose reads
# its input's shape only, so ``layer.vjp`` takes the batch-b x.

def _expand_batch(t: torch.Tensor, K: int) -> torch.Tensor:
    """[b, ...] -> [K*b, ...], clone-major."""
    return t.unsqueeze(0).expand(K, *t.shape).reshape(K * t.shape[0], *t.shape[1:])


def _mul_small(big: torch.Tensor, small: torch.Tensor, K: int) -> torch.Tensor:
    """big [K*b, ...] * small [b, ...] without materialising the tile."""
    return (big.reshape(K, small.shape[0], *big.shape[1:]) * small).reshape(big.shape)


def shared_epsilon(layer, x, R, K: int, *, epsilon: float = 1e-6, **_):
    s = _mul_small(R, 1.0 / stabilize(layer.forward(x), epsilon), K)
    return _mul_small(layer.vjp(s, x), x, K)


def shared_norm(layer, x, R, K: int, *, stabilizer: float = 1e-6, **_):
    z = layer.forward(x, _identity, _zero)
    s = _mul_small(R, 1.0 / stabilize(z, stabilizer), K)
    return _mul_small(layer.vjp(s, x), x, K)


def shared_gamma_nonneg(layer, x, R, K: int, *, gamma: float = 0.25,
                        stabilizer: float = 1e-6, **_):
    """On a GPU tensor and a 3x3 SAME conv, the fused kernel
    (xai.lrp.fused_gamma); elsewhere, and on the CPU, the plain rule. The
    choice follows the layer's spec and the tensor's device only. The plain
    rule derives z_true with a division by (2+gamma), as the JAX package's
    rule does; the kernel multiplies by f32(1/(2+gamma)), as its TPU kernel
    does."""
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    if x.device.type != "cpu" and fused_gamma.takes(layer):
        return fused_gamma.gamma_nonneg_folded(x, R, layer.w, layer.b, K,
                                               gamma=gamma, stabilizer=stabilizer)
    gp, gn = _gmods(gamma)
    z1, z3 = layer.forward_stacked(x, [gp, gn], [gp, None])
    bias1 = layer.bias_of(gp)
    z_true = (z1 + z3 - bias1) / (2.0 + gamma) + layer.bias_of(_identity)
    m1 = (z_true > 0.0).to(R.dtype) / stabilize(z1 + layer.bias_of(gn), stabilizer)
    m3 = (z_true < 0.0).to(R.dtype) / stabilize(z3, stabilizer)
    c = layer.vjp_stacked([_mul_small(R, m1, K), _mul_small(R, m3, K)], x, [gp, gn])
    return _mul_small(c, x, K)


def shared_gamma(layer, x, R, K: int, *, gamma: float = 0.25,
                 stabilizer: float = 1e-6, **_):
    gp, gn = _gmods(gamma)
    xp, xn = _pos(x), _neg(x)
    z1 = layer.forward(xp, gp, gp)
    z2 = layer.forward(xn, gn, gn)
    z3 = layer.forward(xp, gn, _zero)
    z4 = layer.forward(xn, gp, _zero)
    z_true = layer.forward(x)
    m_pos = (z_true > 0.0).to(R.dtype) / stabilize(z1 + z2, stabilizer)
    m_neg = (z_true < 0.0).to(R.dtype) / stabilize(z3 + z4, stabilizer)
    s_pos, s_neg = _mul_small(R, m_pos, K), _mul_small(R, m_neg, K)
    return (_mul_small(layer.vjp(s_pos, x, gp) + layer.vjp(s_neg, x, gn), xp, K)
            + _mul_small(layer.vjp(s_pos, x, gn) + layer.vjp(s_neg, x, gp), xn, K))


def shared_zplus(layer, x, R, K: int, *, stabilizer: float = 1e-6, **_):
    xp, xn = _pos(x), _neg(x)
    z = layer.forward(xp, _pos, _pos) + layer.forward(xn, _neg, _zero)
    s = _mul_small(R, 1.0 / stabilize(z, stabilizer), K)
    return _mul_small(layer.vjp(s, x, _pos), xp, K) + _mul_small(layer.vjp(s, x, _neg), xn, K)


def shared_alphabeta(layer, x, R, K: int, *, alpha: float = 2.0,
                     beta: float = 1.0, stabilizer: float = 1e-6, **_):
    xp, xn = _pos(x), _neg(x)
    za = layer.forward(xp, _pos, _pos) + layer.forward(xn, _neg, _zero)
    zb = layer.forward(xp, _neg, _neg) + layer.forward(xn, _pos, _zero)
    s_a = _mul_small(R, 1.0 / stabilize(za, stabilizer), K)
    s_b = _mul_small(R, 1.0 / stabilize(zb, stabilizer), K)
    return (alpha * (_mul_small(layer.vjp(s_a, x, _pos), xp, K)
                     + _mul_small(layer.vjp(s_a, x, _neg), xn, K))
            - beta * (_mul_small(layer.vjp(s_b, x, _neg), xp, K)
                      + _mul_small(layer.vjp(s_b, x, _pos), xn, K)))


def shared_wsquare(layer, x, R, K: int, *, stabilizer: float = 1e-6, **_):
    z = layer.forward(torch.ones_like(x), _square, _square)
    return layer.vjp(_mul_small(R, 1.0 / stabilize(z, stabilizer), K), x, _square)


def shared_flat(layer, x, R, K: int, *, stabilizer: float = 1e-6, **_):
    z = layer.forward(torch.ones_like(x), _ones, _zero)
    return layer.vjp(_mul_small(R, 1.0 / stabilize(z, stabilizer), K), x, _ones)


SHARED_RULES = {
    "epsilon": shared_epsilon,
    "norm": shared_norm,
    "gamma": shared_gamma,
    "gamma_nonneg": shared_gamma_nonneg,
    "zplus": shared_zplus,
    "alphabeta": shared_alphabeta,
    "wsquare": shared_wsquare,
    "flat": shared_flat,
}
