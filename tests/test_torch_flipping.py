"""The port's Flipper and its parts (drsa_audio_tpu_torch.xai.eval.flipping)
against the JAX package's, mirroring tests/test_flipping.py, on the CPU.

Bit-equal: the schedule, the patch ranking, the keep masks and
calculate_aupc on the same scores. Flipper end to end (its forwards run in
each framework): rtol 1e-4, atol 1e-5 * max|preds|, preds the port's
per-instance scores [steps+1, b]. The patch sums of R are formed in another
order in each framework, so an input whose two patch sums lie within
round-off could rank differently: every R here holds its distinct patch
sums at least PATCH_MARGIN apart (relative to the largest), and the tests
assert it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.runtime import native as jnative
from drsa_audio_tpu.xai.eval import flipping as jflip
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.xai.eval import flipping as tflip
from test_torch_util import both_models

PATCH_MARGIN = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The small forwards of these tests spend more in torch's intra-op
    thread pools than in the work when several test workers share the
    host: one thread per test here, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def patch_margin(R: np.ndarray, p: int) -> float:
    """Smallest gap between two distinct ReLU patch sums of one (clip,
    concept) of R [b, k, h, w], relative to the largest sum."""
    b, k, h, w = R.shape
    s = np.maximum(R, 0).astype(np.float64).reshape(b, k, h // p, p, w // p, p).sum(axis=(3, 5))
    s = np.sort(s.reshape(b, k, -1), axis=-1)
    gaps = np.diff(s, axis=-1)
    gaps = gaps[gaps > 0]
    return float(gaps.min() / s.max()) if gaps.size else np.inf


def _relevance(seed, shape, p):
    R = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = R.reshape(shape[0], -1, *shape[-2:])
    assert patch_margin(flat, p) >= PATCH_MARGIN
    return R


class Quadrants:
    """Linear two-class model: logit c = sum of the pixels of half c."""

    def __call__(self, x):
        h = x.shape[2] // 2
        return torch.stack([x[:, 0, :h].sum(dim=(1, 2)), x[:, 0, h:].sum(dim=(1, 2))], dim=1)


def jax_quadrants(x):
    h = x.shape[2] // 2
    return jnp.stack([x[:, 0, :h].sum(axis=(1, 2)), x[:, 0, h:].sum(axis=(1, 2))], axis=1)


@pytest.fixture(scope="module")
def toy():
    """The toy VGG in both packages (bridged weights): (JAX forward, port
    forward)."""
    jspecs, jparams, tspecs, tparams, *_ = both_models("toy")
    jfwd = jax.jit(lambda x: jvgg.forward(jspecs, jparams, x))
    return jfwd, lambda x: tvgg.forward(tspecs, tparams, x)


def _close_to_jax(port, jax_out, preds):
    """(aupc, mean scores, flips) against the JAX Flipper's."""
    atol = 1e-5 * np.abs(preds).max()
    np.testing.assert_allclose(port[0], np.asarray(jax_out[0]), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(port[1], np.asarray(jax_out[1]), rtol=1e-4, atol=atol)
    np.testing.assert_array_equal(port[2], np.asarray(jax_out[2]))


@pytest.mark.parametrize("n", [1, 4, 5, 16, 64, 100])
def test_quadratic_schedule_matches_jax(n):
    assert tflip.quadratic_schedule(n) == jflip.quadratic_schedule(n)
    assert sum(tflip.quadratic_schedule(n)) == n


@pytest.mark.parametrize("k", [1, 4])
def test_rank_and_masks_match_jax(k):
    """Ranks (with exact zero ties, which keep index order) and the keep
    masks of every step, patch grid and pixels, bit-equal."""
    p, h, w = 4, 16, 24
    R = _relevance(k, (3, k, h, w), p)
    R[0, :, :8] = -1.0                                         # zero patches: ties
    order = tflip.rank_patches(torch.as_tensor(R), p)
    jorder = jflip.rank_patches(jnp.asarray(R), p)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    flips = tflip.quadratic_schedule((h // p) * (w // p))
    keep = tflip._cumulative_masks(order, flips)
    jkeep = jflip._cumulative_masks(jorder, flips, (h // p, w // p))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(
        tflip._upsample_patch_mask(keep, (h // p, w // p), p).numpy(),
        np.asarray(jflip._upsample_patch_mask(jkeep, (h // p, w // p), p)))


def test_calculate_aupc_matches_jax(rng):
    preds = rng.uniform(0, 3, (7, 6)).astype(np.float32)
    flips = np.array([0, 1, 4, 9, 16, 25, 9])
    for n_classes in (2, 3, 4):                                # 4: an unbalanced batch
        np.testing.assert_array_equal(tflip.calculate_aupc(preds, flips, n_classes),
                                      jflip.calculate_aupc(preds, flips, n_classes))
    assert tflip.calculate_aupc(preds, flips, 4).shape == (1, 6)


@pytest.mark.parametrize("shape,p", [
    ((4, 1, 1, 16, 16), 2),          # one concept, [b, 1, 1, h, w]
    ((2, 3, 1, 16, 16), 4),          # three concepts: the union of their top patches
    ((4, 1, 16, 16), 4),             # R with the input's channel axis
])
def test_flipper_quadrants_matches_jax(shape, p):
    x = np.abs(np.random.default_rng(9).standard_normal((shape[0], 1, 16, 16))).astype(np.float32)
    R = _relevance(3, shape, p)
    f = tflip.Flipper(perturbation_size=p, device="cpu")
    preds, _, _ = f.predictions(Quadrants(), x, R)
    _close_to_jax(f(Quadrants(), x, R), jflip.Flipper(perturbation_size=p)(jax_quadrants, x, R),
                  preds)


def test_flipper_toy_model_matches_jax(toy):
    """The toy VGG at perturbation 8 (64 patches, 6 steps), forwards in two
    chunks smaller than the batch."""
    jfwd, tfwd = toy
    x = np.random.default_rng(4).standard_normal((4, 1, 64, 64)).astype(np.float32)
    R = _relevance(5, (4, 2, 1, 64, 64), 8)
    f = tflip.Flipper(perturbation_size=8, forward_batch=10, device="cpu")
    preds, flips, n_classes = f.predictions(tfwd, x, R)
    assert preds.shape == (7, 4) and n_classes == 2 and list(flips) == [0, 1, 4, 9, 16, 25, 9]
    _close_to_jax(f(tfwd, x, R), jflip.Flipper(perturbation_size=8, forward_batch=10)(jfwd, x, R),
                  preds)


def test_flipper_forward_batch_and_class_ids(toy):
    """forward_batch below the batch gives the scores of one forward (at
    the Flipper tolerance: the convolutions' batch size sets their
    summation order on the CPU); uneven batches (b not a multiple of the
    classes, b below them) and explicit class_ids as in the JAX package."""
    jfwd, tfwd = toy
    x = np.random.default_rng(6).standard_normal((3, 1, 64, 64)).astype(np.float32)
    R = _relevance(7, (3, 1, 1, 64, 64), 16)
    whole = tflip.Flipper(16, device="cpu").predictions(tfwd, x, R)[0]
    for fb in (1, 4, 5):
        np.testing.assert_allclose(
            tflip.Flipper(16, forward_batch=fb, device="cpu").predictions(tfwd, x, R)[0], whole,
            rtol=1e-4, atol=1e-5 * np.abs(whole).max())
    f = tflip.Flipper(16, device="cpu")
    for ids in (None, [1, 1, 0]):
        preds = f.predictions(tfwd, x, R, class_ids=ids)[0]
        _close_to_jax(f(tfwd, x, R, class_ids=ids), jflip.Flipper(16)(jfwd, x, R, class_ids=ids),
                      preds)
    aupc, mean, _ = f(tfwd, x[:1], R[:1])                       # one clip, two classes
    assert aupc.shape == (1, 1) and np.isfinite(mean).all()
    with pytest.raises(ValueError, match="class_ids"):
        tflip.Flipper(16, device="cpu")(tfwd, x, R, class_ids=[0, 1])
    with pytest.raises(ValueError, match="perturbation_mode"):
        tflip.Flipper(16, "blur", device="cpu")(tfwd, x, R)


@pytest.mark.parametrize("normalization", ["normalized", "min", "none"])
def test_flipper_inpainting_matches_jax(toy, normalization):
    """Telea through each package's binding of the same library; the JAX
    package would fill with the mean without it, so it must be there."""
    assert jnative.available()
    jfwd, tfwd = toy
    x = np.random.default_rng(8).standard_normal((2, 1, 64, 64)).astype(np.float32)
    R = _relevance(9, (2, 1, 1, 64, 64), 16)
    f = tflip.Flipper(16, "inpainting", normalization, device="cpu")
    preds = f.predictions(tfwd, x, R)[0]
    _close_to_jax(f(tfwd, x, R), jflip.Flipper(16, "inpainting", normalization)(jfwd, x, R),
                  preds)
    masks = tflip._upsample_patch_mask(tflip._cumulative_masks(
        tflip.rank_patches(torch.as_tensor(R[:, :, 0]), 16), [1, 3, 9, 3]), (4, 4), 16)
    filled = f._inpaint_all(x, masks.numpy())
    np.testing.assert_array_equal(filled, jflip.Flipper(16, "inpainting", normalization)
                                  ._inpaint_all(x, masks.numpy()))


def test_flipper_random_mode():
    """Seeded per-clip permutations (the port's own draw): each clip's
    order is a permutation, a seed repeats its order and another seed
    does not; every step flips the schedule's count, and the last step
    leaves nothing (the linear model scores 0)."""
    b, P = 3, 16

    def draw(seed):
        return tflip.Flipper(4, seed=seed, device="cpu")._order(None, "random", b, 1, P)
    orders = draw(1)
    assert orders.shape == (b, 1, P)
    for o in orders[:, 0]:
        assert sorted(o.tolist()) == list(range(P))
    assert not torch.equal(orders[0], orders[1])
    assert torch.equal(orders, draw(1)) and not torch.equal(orders, draw(2))
    flips = tflip.quadratic_schedule(P)
    keep = tflip._cumulative_masks(orders, flips)
    np.testing.assert_array_equal(keep.sum(dim=-1).numpy(),
                                  np.repeat(P - np.cumsum(flips)[:, None], b, axis=1))
    x = np.abs(np.random.default_rng(2).standard_normal((b, 1, 16, 16))).astype(np.float32) + 0.1
    aupc, mean, got_flips = tflip.Flipper(4, seed=1, device="cpu")(Quadrants(), x, None,
                                                                   flipping_mode="random")
    assert aupc.shape == (1, 3) and mean.shape == (len(flips) + 1,)
    assert mean[-1] == 0.0 and mean[0] > 0 and list(got_flips) == [0] + flips


def test_flipper_relevant_first_drops_faster():
    """Flipping by the true relevance lowers the class score sooner than a
    random order: the smaller AUPC (reference cpf.py:106-107)."""
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((2, 1, 16, 16))).astype(np.float32) + 0.5
    R = np.zeros((2, 1, 1, 16, 16), np.float32)
    R[0, ..., :8, :] = x[0, 0, :8]
    R[1, ..., 8:, :] = x[1, 0, 8:]
    f = tflip.Flipper(4, device="cpu")
    assert f(Quadrants(), x, R)[0].mean() < f(Quadrants(), x, R, flipping_mode="random")[0].mean()


def test_flipper_needs_cuda_unless_named(monkeypatch):
    """No device named and no CUDA: refused, not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflip.Flipper()
