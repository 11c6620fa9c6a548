"""Rank bodies for tests/test_torch_parallel.py and the card's world-1 test in
tests/test_torch_gpu.py: each runs in a process that
drsa_audio_tpu_torch.parallel.launch spawns, which re-imports this module,
so it imports no jax and holds no tests. Every result goes back to the
test as numpy."""

import numpy as np
import torch

from drsa_audio_tpu_torch.models import train as ttrain
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection
from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
from drsa_audio_tpu_torch.parallel import sharding as tsh
from drsa_audio_tpu_torch.serving import ExplainerService
from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
from drsa_audio_tpu_torch.xai.explain import class_composite
from drsa_audio_tpu_torch.xai.lrp.engine import Composite

# the narrow BatchNorm model of tests/test_torch_train.py (small_cfg(bn=True))
SMALL_BN = dict(n_filters=(4, 8), pool_kernels=((4, 4), (2, 2)), n_dense=16, n_classes=2,
                dropout=0.1, block_depth=1, dense_depth=1, input_size=(64, 64),
                conv_bn=True, dense_bn=True)


NO_DROPOUT = {"dropout": {}}          # the toy model has no dropout layer


def np_tree(tree: dict) -> dict:
    return {n: {k: v.detach().cpu().numpy() for k, v in p.items()} for n, p in tree.items()}


def torch_tree(tree: dict) -> dict:
    return {n: {k: torch.tensor(v) for k, v in p.items()} for n, p in tree.items()}


def toy_step(mesh, params, mels, labels, draws, steps: int = 1, specs=None, has_bn=False):
    """``steps`` sharded train steps (SGD lr 1e-2, the port's defaults
    otherwise); (losses, accuracies, params after)."""
    specs = specs or tvgg.build_layer_specs(tvgg.toy_config())
    trainable, _ = ttrain.split_trainable(params)
    step = tsh.make_sharded_train_step(specs, ttrain.make_optimizer(trainable, 1e-2), mesh,
                                       has_bn=has_bn)
    losses, accs = [], []
    for i in range(steps):
        loss, acc = step(params, mels[i], labels[i], draws[i])
        losses.append(loss.item())
        accs.append(acc.item())
    return losses, accs, np_tree(params)


def bn_draws(specs, b: int, steps: int) -> list:
    g = torch.Generator().manual_seed(3)
    return [{"dropout": tvgg.draw_keep_masks(specs, b, g)} for _ in range(steps)]


def cases(mesh, data: dict) -> dict:
    """Every case of the group at world size mesh.size(); ``data`` holds the
    toy model's params (bridged from JAX), mels ``x`` [10, 1, 64, 64], and
    waveforms ``wavs`` [8, 16000] with their U."""
    rank = mesh.get_local_rank()
    world = mesh.size()
    specs = tvgg.build_layer_specs(tvgg.toy_config())
    params = torch_tree(data["params"])
    composite = Composite.from_list(LRP_NAME_MAP_TOY)
    x = data["x"]
    out = {"rank": rank, "size": world, "names": mesh.mesh_dim_names}

    heat = tsh.sharded_heatmaps(specs, params, composite, mesh, class_idx=0)
    out["heat10"] = heat(x).numpy()
    out["heat2"] = heat(x[:2]).numpy()           # at world 3 a rank without rows

    fx = tsh.sharded_drsa_extraction(specs, params, composite, mesh, 10, 0, num_locations=6)
    out["extract_train"] = [t.numpy() for t in fx(x, 5)]

    labels = np.arange(10) % 2
    out["step10"] = toy_step(mesh, torch_tree(data["params"]), [x], [labels], [NO_DROPOUT])
    if world == 3:
        return out

    out["heat8"] = heat(x[:8]).numpy()
    fx = tsh.sharded_drsa_extraction(specs, params, composite, mesh, 10, 0)
    out["extract_infer"] = [t.numpy() for t in fx(x[:8])]

    # the explain pipeline from waveforms, each rank's rows recorded
    rows = []
    inner = tsh.subspace_heatmaps

    def recorded(sp, p, mels, *args, **kwargs):
        rows.append(mels.shape[0])
        return inner(sp, p, mels, *args, **kwargs)

    tsh.subspace_heatmaps = recorded
    try:
        sp = insert_projection(specs, 10, torch.as_tensor(data["U"]), 4)
        explain = tsh.sharded_explain_pipeline(sp, params, class_composite(LRP_NAME_MAP_TOY, 4),
                                               mesh, 4, class_idx=1,
                                               frontend_config=FrontendConfig.for_case("toy"))
        out["pipeline"] = explain(data["wavs"]).numpy()
    finally:
        tsh.subspace_heatmaps = inner
    out["pipeline_rows"] = rows

    labels8 = np.arange(8) % 2
    out["step8"] = toy_step(mesh, torch_tree(data["params"]), [x[:8]], [labels8], [NO_DROPOUT])

    # each rank feeds only its rows; rank 1's params are off until replicated
    mine = slice(4 * rank, 4 * rank + 4)
    local = torch_tree(data["params"])
    if rank:
        for p in local.values():
            for v in p.values():
                v.add_(1.0)
    out["step8_local"] = toy_step(
        mesh, tsh.replicate(local, mesh), [tsh.global_from_local(x[mine], mesh, 8)],
        [tsh.global_from_local(labels8[mine], mesh, 8)], [NO_DROPOUT])

    bn_specs = tvgg.build_layer_specs(tvgg.VGGConfig(**SMALL_BN))
    out["bn_steps"] = toy_step(mesh, tvgg.init_params(bn_specs, seed=0, device="cpu"),
                               [x[:8], x[2:]], [labels8, labels8[::-1].copy()],
                               bn_draws(bn_specs, 8, 2), steps=2, specs=bn_specs, has_bn=True)

    svc = ExplainerService(specs, params, LRP_NAME_MAP_TOY, Us={"class1": data["U_svc"]},
                           num_concepts=2, layer_idx=10, case="toy", device="cpu", mesh=mesh)
    out["service"] = svc.explain(data["wavs"], "class1")
    return out


def card_world1(mesh, data: dict) -> dict:
    """On the card, world size 1 under NCCL: the sharded explain pipeline
    (3s at full width, mels in) and the sharded train step against the
    same calls without a mesh, cuDNN held to deterministic algorithms, and
    the chain's launches."""
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps
    from drsa_audio_tpu_torch.xai.lrp import chain
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN

    torch.backends.cudnn.deterministic = True      # this rank's process only
    device = tsh.mesh_device(mesh)
    specs = tvgg.build_layer_specs(tvgg.gtzan_3s_config())
    params = tvgg.init_params(specs, seed=0, device=device)
    sp = insert_projection(specs, 10, torch.as_tensor(data["U"], device=device), 4,
                           input_size=(128, 128))
    composite = class_composite(LRP_NAME_MAP_GTZAN, 4)
    mels = torch.as_tensor(data["mels"], device=device)
    chain.reset_launches()
    got = tsh.sharded_explain_pipeline(sp, params, composite, mesh, 4, class_idx=2)(mels)
    launches = dict(chain.LAUNCHES)
    with torch.inference_mode():
        want, _ = subspace_heatmaps(sp, params, mels, composite, 4, class_idx=2)

    labels = torch.arange(len(mels), device=device) % 10
    one = tvgg.init_params(specs, seed=1, device=device)
    two = tvgg.init_params(specs, seed=1, device=device)
    step = ttrain.make_train_step(specs, ttrain.make_optimizer(one, 1e-2))
    loss1, _ = step(one, mels, labels, {"dropout": tvgg.draw_keep_masks(
        specs, len(mels), torch.Generator(device=device).manual_seed(4))})
    sharded = tsh.make_sharded_train_step(specs, ttrain.make_optimizer(two, 1e-2), mesh)
    loss2, _ = sharded(two, mels, labels, {"dropout": tvgg.draw_keep_masks(
        specs, len(mels), torch.Generator(device=device).manual_seed(4))})
    return {"launches": launches, "heat_equal": bool(torch.equal(got, want)),
            "loss_equal": loss1.item() == loss2.item(),
            "params_equal": all(torch.equal(one[n][k], two[n][k]) for n in one for k in one[n])}
