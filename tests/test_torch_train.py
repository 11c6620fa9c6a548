"""The port's training (drsa_audio_tpu_torch.models.train, the train-mode
forward of models.vgg, models.experimental) against the JAX package's, on
the CPU. Dropout keep masks are JAX's (bernoulli of fold_in(key, layer
index)), passed to the port; weights are bridged from JAX's init.

Tolerances: loss rtol 1e-5; params and BN state rtol 1e-4, atol 1e-5 *
max|ref| per tensor; gradients and the momentum buffer rtol 1e-4, atol
1e-5 * the largest |ref| of the model's tensors (summation order of the
convs and reductions differs). The bias of a layer that BatchNorm follows
has a gradient of zero but for round-off: atol 1e-4 * that largest |ref|
(up to 2.1e-5 of it measured, on mels with zeroed bands). On those mels the
BN model's other gradients take atol 3e-5 * that largest |ref| (up to
1.1e-5 measured; as much with BN written out in the JAX package's
operation order: the convs' summation order over bands of identical
inputs, which BN's normalisation amplifies).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from drsa_audio_tpu.models import experimental as jexp
from drsa_audio_tpu.models import train as jtrain
from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.utils import evaluation as jeval
from drsa_audio_tpu_torch.models import experimental as texp
from drsa_audio_tpu_torch.models import train as ttrain
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.utils import evaluation as teval
from drsa_audio_tpu_torch.utils.convert import from_jax_params

RENAME = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
          "mean": "running_mean", "var": "running_var"}


def small_cfg(bn=True, dropout=0.1):
    return dict(n_filters=(4, 8), pool_kernels=((4, 4), (2, 2)), n_dense=16, n_classes=2,
                dropout=dropout, block_depth=1, dense_depth=1, input_size=(64, 64),
                conv_bn=bn, dense_bn=bn)


def _models(bn=True, dropout=0.1, zero_bias=False):
    jspecs = jvgg.build_layer_specs(jvgg.VGGConfig(**small_cfg(bn, dropout)))
    tspecs = tvgg.build_layer_specs(tvgg.VGGConfig(**small_cfg(bn, dropout)))
    jparams = jvgg.init_params(jspecs, jax.random.PRNGKey(0))
    if zero_bias:
        jparams = {n: ({**p, "b": jnp.zeros_like(p["b"])} if "w" in p else p)
                   for n, p in jparams.items()}
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jspecs, jparams, tspecs, tparams


def _jax_keep_masks(jspecs, key, batch):
    """The keep masks the JAX package's forward draws: layer i's from
    fold_in(key, i)."""
    out = {}
    for i, s in enumerate(jspecs):
        if s.kind == "dropout":
            n = next(p for p in jspecs[:i][::-1] if p.kind == "linear").config["out_f"]
            keep = jax.random.bernoulli(jax.random.fold_in(key, i), 1.0 - s.config["rate"], (batch, n))
            out[s.name] = torch.as_tensor(np.array(keep))
    return out


def _close(got, want, rtol=1e-4, name="", atol=None):
    """rtol, atol (1e-5 * max|want| where None)."""
    want = np.asarray(want)
    atol = 1e-5 * np.abs(want).max() if atol is None else atol
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol, err_msg=name)


def _bn_cancelled(jspecs) -> set:
    """(layer, "b") of each conv or linear layer that BatchNorm follows."""
    return {(a.name, "b") for a, b in zip(jspecs, jspecs[1:])
            if a.kind in ("conv", "linear") and b.kind.startswith("batchnorm")}


def _tree_close(tree_t: dict, tree_j: dict, what: str, model_atol=None, cancelled=()):
    """Each tensor at rtol 1e-4, atol 1e-5 * its own max|ref|; or, given
    ``model_atol``, at atol model_atol * the largest |ref| over the model's
    tensors (1e-4 of it for the ``cancelled`` biases)."""
    top = max((float(np.abs(np.asarray(v)).max()) for p in tree_j.values() for v in p.values()),
              default=0.0)
    for n, p in tree_j.items():
        for k, v in p.items():
            atol = None
            if model_atol is not None:
                atol = (1e-4 if (n, k) in cancelled else model_atol) * top
            _close(tree_t[n][RENAME[k]].detach(), v, name=f"{what} {n}.{k}", atol=atol)


def _mels(rng, b, masked: bool):
    x = rng.standard_normal((b, 1, 64, 64)).astype(np.float32)
    if masked:                  # SpecAugment-style bands of exact zeros
        x[:, :, 10:30, :] = 0.0
        x[:, :, :, 40:60] = 0.0
    return x


def _jax_loss_and_grads(jspecs, has_bn):
    def loss_fn(trainable, state, mels, labels, key):
        params = jtrain.merge_params(trainable, state)
        if has_bn:
            logits, _ = jvgg.train_forward_with_bn(jspecs, params, mels, key)
        else:
            logits = jvgg.forward(jspecs, params, mels, train=True, dropout_key=key)
        return optax.softmax_cross_entropy(logits, jax.nn.one_hot(labels, 2)).mean()
    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("has_bn,masked,zero_bias", [
    (True, False, False),      # the narrow BN model, dropout 0.1
    (True, True, False),
    (False, True, True),       # no BN, zero biases, masked mels: relu and pool ties
])
def test_three_train_steps_match_jax(has_bn, masked, zero_bias):
    """Three steps of make_train_step on mels: loss, gradients, trainable
    params, BN running statistics and the momentum buffer after each."""
    jspecs, jparams, tspecs, tparams = _models(has_bn, 0.1, zero_bias)
    grad_atol = 3e-5 if has_bn and masked else 1e-5
    rng = np.random.default_rng(1)
    lr = 1e-2
    jopt = jtrain.make_optimizer(lr)
    jtr, jst = jtrain.split_trainable(jparams)
    jos = jopt.init(jtr)
    jstep = jtrain.make_train_step(jspecs, jopt, has_bn=has_bn)
    jgrad = _jax_loss_and_grads(jspecs, has_bn)
    ttr, tst = ttrain.split_trainable(tparams)
    topt = ttrain.make_optimizer(ttr, lr)
    tstep = ttrain.make_train_step(tspecs, topt, has_bn=has_bn)
    if zero_bias:               # a pre-activation at exactly 0 is there to gate
        x = torch.as_tensor(_mels(rng, 8, masked))
        assert (tvgg.apply_layer(tspecs[0], tparams, x) == 0).any()
    for step in range(3):
        mels = _mels(rng, 8, masked)
        labels = (np.arange(8) % 2).astype(np.int32)
        key = jax.random.PRNGKey(10 + step)
        jloss_g, jgrads = jgrad(jtr, jst, jnp.asarray(mels), jnp.asarray(labels), key)
        jtr, jst, jos, jloss, jacc = jstep(jtr, jst, jos, jnp.asarray(mels), jnp.asarray(labels), key)
        draws = {"dropout": _jax_keep_masks(jspecs, key, 8)}
        tloss, tacc = tstep(tparams, torch.as_tensor(mels), torch.as_tensor(labels), draws)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(jloss_g), float(jloss), rtol=1e-6)
        assert float(tacc) == float(jacc)
        _tree_close({n: {k: v.grad for k, v in p.items()} for n, p in ttr.items()}, jgrads,
                    f"step {step} grad", grad_atol, cancelled=_bn_cancelled(jspecs))
        _tree_close(ttr, jtr, f"step {step} param")
        _tree_close(tst, jst, f"step {step} BN state")
        trace = jos[1][0].trace
        _tree_close({n: {k: topt.state[v]["momentum_buffer"] for k, v in p.items()}
                     for n, p in ttr.items()}, trace, f"step {step} momentum", grad_atol,
                    cancelled=_bn_cancelled(jspecs))


def test_relu_gradient_at_zero_is_jaxs():
    """relu_train: the value of max(x, 0) bit for bit, and jnp.maximum's
    gradient: 0.5 at exactly 0."""
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], np.float32)
    t = torch.tensor(x, requires_grad=True)
    y = tvgg.relu_train(t)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, 0))
    want = jax.grad(lambda v: jnp.maximum(v, 0.0).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert t.grad[2] == 0.5


def test_vgg_module_train_mode_updates_bn_buffers():
    """VGG in training mode: BN on batch statistics, the buffers moved as
    train_forward_with_bn moves them; eval mode leaves them."""
    cfg = tvgg.VGGConfig(**small_cfg(True, 0.0))
    model = tvgg.VGG(cfg)
    x = torch.randn(6, 1, 64, 64, generator=torch.Generator().manual_seed(0))
    params = {n: {k: v.detach().clone() for k, v in p.items()} for n, p in model.params().items()}
    want, new = tvgg.train_forward_with_bn(model.specs, params, x)
    got = model.train()(x)
    torch.testing.assert_close(got, want)
    for n, p in model.params().items():
        if "running_mean" in p:
            torch.testing.assert_close(p["running_var"], new[n]["running_var"])
            assert not torch.equal(p["running_mean"], params[n]["running_mean"])
    before = {n: p["running_mean"].clone() for n, p in model.params().items() if "running_mean" in p}
    model.eval()(x)
    assert all(torch.equal(model.params()[n]["running_mean"], v) for n, v in before.items())


def test_eval_step_matches_jax():
    jspecs, jparams, tspecs, tparams = _models(True)
    x = _mels(np.random.default_rng(2), 8, False)
    labels = (np.arange(8) % 2).astype(np.int32)
    jl, ja, jp = jtrain.make_eval_step(jspecs)(jparams, jnp.asarray(x), jnp.asarray(labels))
    tl, ta, tp = ttrain.make_eval_step(tspecs)(tparams, torch.as_tensor(x), torch.as_tensor(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(ta) == float(ja)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_make_optimizer_matches_optax():
    """Three updates of SGD(momentum 0.99, weight decay 1e-2) on the same
    gradients: rtol 1e-5, atol 1e-6 (the JAX package's own torch check)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    jopt = jtrain.make_optimizer(0.1, 0.99, 1e-2)
    jp = {"l": {"w": jnp.asarray(w0)}}
    st = jopt.init(jp)
    tp = {"l": {"weight": torch.as_tensor(w0.copy())}}
    topt = ttrain.make_optimizer(tp, 0.1, 0.99, 1e-2)
    for g in grads:
        upd, st = jopt.update({"l": {"w": jnp.asarray(g)}}, st, jp)
        jp = optax.apply_updates(jp, upd)
        tp["l"]["weight"].grad = torch.as_tensor(g)
        topt.step()
    np.testing.assert_allclose(tp["l"]["weight"].detach().numpy(), np.asarray(jp["l"]["w"]),
                               rtol=1e-5, atol=1e-6)


def _fit_inputs():
    rng = np.random.default_rng(3)
    mels = rng.standard_normal((16, 1, 64, 64)).astype(np.float32)
    labels = (np.arange(16) % 2).astype(np.int32)

    def batches():
        yield mels[:8], labels[:8]
        yield mels[8:], labels[8:]
    return mels, batches


def test_fit_checkpoint_roundtrip_resume_and_latest_scan(tmp_path):
    """fit saves params, BN state, optimizer state and the generator's state
    through a temporary name; load_checkpoint(epoch=None) takes the highest
    exact ckpt_N.pt past leftover temporary files; a run resumed from epoch
    1 ends bit-equal to the uninterrupted two-epoch run (the dropout draws
    continue from the saved generator state)."""
    _, _, specs, params = _models(True, 0.1)
    mels, batches = _fit_inputs()
    kw = dict(lr=1e-3, has_bn=True, device="cpu", seed=5)
    full, stats = ttrain.fit(specs, params, batches, batches, num_epochs=2,
                             model_path=str(tmp_path / "full"), save_step=1, **kw)
    assert len(stats.train_loss) == 2 and os.path.exists(tmp_path / "full" / "train_stats_0.csv")
    assert sorted(os.listdir(tmp_path / "full")) == ["ckpt_1.pt", "ckpt_2.pt", "train_stats_0.csv"]
    # the caller's params are not trained in place
    assert torch.equal(params["features.0"]["weight"],
                       _models(True, 0.1)[3]["features.0"]["weight"])

    (tmp_path / "full" / "ckpt_30.pt.tmp-123").write_bytes(b"partial")
    (tmp_path / "full" / "ckpt_7.pt.partial").write_bytes(b"partial")
    ckpt = ttrain.load_checkpoint(str(tmp_path / "full"))
    assert ckpt["epoch"] == 2
    assert set(ckpt) == {"trainable", "state", "opt_state", "epoch", "rng_state"}
    restored = ttrain.merge_params(ckpt["trainable"], ckpt["state"])
    x = torch.as_tensor(mels[:4])
    torch.testing.assert_close(tvgg.forward(specs, restored, x), tvgg.forward(specs, full, x),
                               rtol=0, atol=0)

    resumed, rstats = ttrain.fit(specs, params, batches, batches, num_epochs=1,
                                 resume_from=str(tmp_path / "full"), from_epoch=1,
                                 model_path=str(tmp_path / "resumed"), **kw)
    assert os.listdir(tmp_path / "resumed") == [] or "ckpt_2.pt" in os.listdir(tmp_path / "resumed")
    for n, p in full.items():
        for k, v in p.items():
            assert torch.equal(resumed[n][k], v), f"{n}.{k}"
    assert rstats.train_loss[0] == stats.train_loss[1]
    with pytest.raises(FileNotFoundError):
        ttrain.load_checkpoint(str(tmp_path / "resumed" / ".."))


def test_entry_points_reject_a_missing_card():
    """fit, init_params and from_jax_params resolve their device: CUDA
    unless named, raising without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jspecs, jparams, specs, params = _models(True, 0.1)
    _, batches = _fit_inputs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.fit(specs, params, batches, batches, num_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvgg.init_params(specs, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))


def test_train_stats_csv_crosses_packages(tmp_path):
    """A CSV written by the port reads in the JAX package's get_train_stats,
    and the reverse; both equal to the written lists."""
    vals = dict(train_loss=[0.9, 0.7], train_acc=[0.5, 0.75], valid_losses=[1.1, 0.8],
                valid_acc=[0.25, 0.5])
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ttrain.TrainStats(**vals).save_csv(str(tmp_path / "t"), from_epoch=3)
    jtrain.TrainStats(**vals).save_csv(str(tmp_path / "j"))
    assert jeval.get_train_stats(str(tmp_path / "t")) == vals
    assert teval.get_train_stats(str(tmp_path / "j")) == vals
    assert teval.get_train_stats(str(tmp_path / "t" / "train_stats_3.csv")) == vals
    assert ((tmp_path / "t" / "train_stats_3.csv").read_text()
            == (tmp_path / "j" / "train_stats_0.csv").read_text())


def test_experimental_heads_match_jax():
    """differential_logits and reverse_logsumexp: rtol 1e-5, atol 1e-6 * max."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    w = rng.standard_normal((3, 7)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    jd = jexp.differential_logits(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    td = texp.differential_logits(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b))
    _close(td, jd, rtol=1e-5)
    _close(texp.reverse_logsumexp(td), jexp.reverse_logsumexp(jd), rtol=1e-5)


def test_train_step_takes_a_vgg_module():
    """make_train_step given a VGG module steps its own parameters and BN
    buffers, as the functional step does on copies of them."""
    model = tvgg.VGG(tvgg.VGGConfig(**small_cfg(True, 0.1)))
    params = {n: {k: v.detach().clone() for k, v in p.items()} for n, p in model.params().items()}
    x = torch.as_tensor(_mels(np.random.default_rng(5), 8, False))
    labels = torch.as_tensor(np.arange(8) % 2)
    draws = {"dropout": tvgg.draw_keep_masks(model.specs, 8, torch.Generator().manual_seed(1))}
    opt_m = ttrain.make_optimizer(ttrain.split_trainable(model.params())[0], 1e-2)
    opt_f = ttrain.make_optimizer(ttrain.split_trainable(params)[0], 1e-2)
    lm, _ = ttrain.make_train_step(model, opt_m, has_bn=True)(None, x, labels, draws)
    lf, _ = ttrain.make_train_step(model.specs, opt_f, has_bn=True)(params, x, labels, draws)
    assert torch.equal(lm, lf)
    for n, p in model.params().items():
        for k, v in p.items():
            assert torch.equal(v.detach(), params[n][k]), f"{n}.{k}"
