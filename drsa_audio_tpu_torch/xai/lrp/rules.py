"""LRP rules as modified-backward primitives (the port of
drsa_audio_tpu.xai.lrp.rules).

Each rule takes a layer operator (engine.LayerOp: the layer's forward with
modified parameters, its transpose ``vjp`` and ``bias_of``), the recorded
input activation ``x`` and the incoming relevance ``R``, and returns the
relevance at the layer input. The algebra is zennit 0.5.1's, term for term as
the JAX package computes it:

  epsilon       R_in = x * vjp(R / stab(f(x)))
  gamma         four clamp combinations gated by the sign of f(x)
  gamma_nonneg  gamma on provably non-negative x (two terms; z_true derived)
  wsquare       z = f(1; w^2, b^2);  R_in = vjp(R / stab(z))
  flat          z = f(1; 1, 0);      R_in = vjp(R / stab(z))
  pass          identity

The rules are linear in R for fixed activations, which the K-clone fold of
xai.explain relies on.
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


def _gmods(gamma: float):
    def gmod_pos(p):
        return p + gamma * torch.clamp(p, min=0.0)

    def gmod_neg(p):
        return p + gamma * torch.clamp(p, max=0.0)

    return gmod_pos, gmod_neg


def lrp_epsilon(layer, x, R, *, epsilon: float = 1e-6, **_):
    z = layer.forward(x)
    return x * layer.vjp(R / stabilize(z, epsilon), x)


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
    "flat": lrp_flat,
    "wsquare": lrp_wsquare,
    "pass": lrp_pass,
    "subspace_mask": lrp_subspace_mask,
}
