"""Training (the port of drsa_audio_tpu.models.train): SGD with momentum,
the batched augment + log-mel pipelines, the train and eval steps,
checkpoints and the epoch loop.

The host feeds raw waveform batches; slicing, augmentation, STFT, the
phase-vocoder stretch, mel, log, pad/crop and masks run on the device
inside the step, as ordinary PyTorch ops over the whole batch with
parameters per example. Each pipeline is split into a sampler, which draws
everything random from a ``torch.Generator`` (window start, gates, gains,
delays, noise and impulse-response arrays, semitones, filters, stretch
rate, pad position, masks), and an apply step that takes those draws. The
train step takes its draws (augmentation and dropout) as one argument.
Loss and accuracy stay on the device; ``fit`` synchronises once per epoch.
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import os
import re
from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from drsa_audio_tpu_torch.models.vgg import (
    LayerSpec, draw_keep_masks, forward, set_running_stats, train_forward_with_bn,
)
from drsa_audio_tpu_torch.ops import augment as aug
from drsa_audio_tpu_torch.ops.frontend import (
    FrontendConfig, logmel, peak_normalize, slice_hop_samples,
)
from drsa_audio_tpu_torch.ops.mel import mel_scale
from drsa_audio_tpu_torch.ops.stft import stft
from drsa_audio_tpu_torch.utils.device import resolve_device


def _leaves(trainable: dict) -> list:
    """The trainable tensors in a fixed order: layers as listed, keys
    sorted. The optimizer's state_dict numbers its tensors in this order."""
    return [p[k] for p in trainable.values() for k in sorted(p)]


def make_optimizer(trainable: dict, lr: float, momentum: float = 0.99,
                   weight_decay: float = 1e-4) -> torch.optim.SGD:
    """SGD over the tensors of ``trainable`` ({layer: {key: tensor}}), torch's
    convention, the JAX package's update (optax add_decayed_weights then
    sgd): buf = momentum * buf + (g + weight_decay * w); w -= lr * buf. The
    tensors are made to require grad."""
    leaves = _leaves(trainable)
    for t in leaves:
        t.requires_grad_(True)
    return torch.optim.SGD(leaves, lr=lr, momentum=momentum, weight_decay=weight_decay)


def split_trainable(params: dict):
    """(trainable, state): BatchNorm running statistics are state, not
    trained. Both share params' tensors."""
    trainable, state = {}, {}
    for name, p in params.items():
        if "running_mean" in p:
            trainable[name] = {k: v for k, v in p.items() if k in ("weight", "bias")}
            state[name] = {k: v for k, v in p.items() if k in ("running_mean", "running_var")}
        else:
            trainable[name] = p
    return trainable, state


def merge_params(trainable: dict, state: dict) -> dict:
    return {name: {**p, **state[name]} if name in state else p
            for name, p in trainable.items()}


# --------------------------------------------------------- input pipelines

def _uniform(b, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(b, generator=generator, device=device)


def _bernoulli(b, p, generator, device):
    return torch.rand(b, generator=generator, device=device) < p


def _randint(b, lo, hi, generator, device):
    return torch.randint(lo, hi, (b,), generator=generator, device=device)


def sample_toy_draws(batch: int, n_samples: int, config: FrontendConfig, wav_augment: bool,
                     mel_augment: bool, mask_param: int = 10,
                     generator: torch.Generator | None = None, device=None) -> dict:
    """Everything random of ``toy_augment_and_mel`` for ``batch`` clips of
    ``n_samples``, drawn from ``generator`` on its device:
    Gain p=.5 (-12..3 dB), Delay p=.4 (50..299 ms), Reverb p=.3, Noise p=.3
    (std ratio 1e-3..1e-1), then one row-or-column mask."""
    g = generator
    device = g.device if g is not None else device
    d = {}
    if wav_augment:
        d.update(
            gain_on=_bernoulli(batch, 0.5, g, device), gain_db=_uniform(batch, -12.0, 3.0, g, device),
            delay_on=_bernoulli(batch, 0.4, g, device), delay_ms=_randint(batch, 50, 300, g, device),
            reverb_on=_bernoulli(batch, 0.3, g, device),
            reverb_ir=torch.randn((batch, aug.reverb_length(config.sample_rate)), generator=g,
                                  device=device),
            noise_on=_bernoulli(batch, 0.3, g, device),
            noise=torch.randn((batch, n_samples), generator=g, device=device),
            noise_ratio=_uniform(batch, 1e-3, 1e-1, g, device))
    if mel_augment:
        h, w = config.n_mels, config.width
        d.update(
            mask_rows=_bernoulli(batch, 0.5, g, device),
            n_r=_randint(batch, 1, mask_param // 2 + 2, g, device),
            r0=_randint(batch, 0, h - mask_param // 2, g, device),
            n_c=_randint(batch, 1, mask_param + 2, g, device),
            c0=_randint(batch, 0, w - mask_param, g, device))
    return d


def toy_augment_and_mel(wavs: torch.Tensor, draws: dict, config: FrontendConfig,
                        wav_augment: bool, mel_augment: bool):
    """Toy waveforms [b, 16000] -> log-mels [b, 1, 64, 64] with the
    reference's toy menu, each example by its ``draws``
    (``sample_toy_draws``, which also sizes the mask). No clamp, time
    cropped to [:width]."""
    sr = config.sample_rate
    wav = peak_normalize(wavs)
    if wav_augment:
        d = draws

        def gate(on, new, old):
            return torch.where(on[:, None], new, old)
        wav = gate(d["gain_on"], aug.gain_db(wav, d["gain_db"]), wav)
        wav = gate(d["delay_on"], aug.delay(wav, d["delay_ms"], sr), wav)
        wav = gate(d["reverb_on"], aug.reverb(wav, d["reverb_ir"], sr), wav)
        wav = gate(d["noise_on"], aug.add_noise(wav, d["noise"], d["noise_ratio"]), wav)
    mag = stft(wav, config.n_fft, config.hop_length).abs()
    mel = torch.log10(mel_scale(mag, config.n_mels, sr) + 1e-7)[..., :config.width]
    if mel_augment:
        d = draws
        mel = aug.single_mask(mel, d["mask_rows"], d["n_r"], d["r0"], d["n_c"], d["c0"])
    return mel[:, None]


def sample_gtzan_draws(batch: int, n_samples: int, config: FrontendConfig, wav_augment: bool,
                       mel_augment: bool, mask_param: int = 40,
                       generator: torch.Generator | None = None, device=None) -> dict:
    """Everything random of ``gtzan_augment_and_mel`` for ``batch`` clips of
    ``n_samples``, drawn from ``generator`` on its device: the window start;
    Gain p=.5, PitchShift p=.3 (-12..12 semitones), HighLowPass p=.4 (low
    1400..4000 Hz or high 200..1400 Hz, even odds), Noise p=.3; the stretch
    rate (0.8..1.2); the pad position; the time and frequency masks."""
    g = generator
    device = g.device if g is not None else device
    window = config.sample_rate * config.slice_length
    d = {"start": _randint(batch, 0, n_samples - window, g, device)}
    if wav_augment:
        d.update(
            gain_on=_bernoulli(batch, 0.5, g, device), gain_db=_uniform(batch, -12.0, 3.0, g, device),
            semitones=_uniform(batch, -12.0, 12.0, g, device),
            pitch_on=_bernoulli(batch, 0.3, g, device),
            use_low=_bernoulli(batch, 0.5, g, device),
            low_f=_uniform(batch, 1400.0, 4000.0, g, device),
            high_f=_uniform(batch, 200.0, 1400.0, g, device),
            filter_on=_bernoulli(batch, 0.4, g, device),
            noise_on=_bernoulli(batch, 0.3, g, device),
            noise=torch.randn((batch, window), generator=g, device=device),
            noise_ratio=_uniform(batch, 1e-3, 1e-1, g, device))
    if mel_augment:
        d["rate"] = _uniform(batch, 0.8, 1.2, g, device)
    d["insert"] = _randint(batch, 0, 1 << 20, g, device)
    if mel_augment:
        h, w = config.n_mels, config.width
        d.update(
            n_rows=_randint(batch, 1, mask_param // 2 + 1, g, device),
            row0=_randint(batch, 0, h - mask_param // 2, g, device),
            n_cols=_randint(batch, 1, mask_param + 1, g, device),
            col0=_randint(batch, 0, w - mask_param, g, device))
    return d


def gtzan_augment_and_mel(wavs: torch.Tensor, draws: dict, config: FrontendConfig,
                          wav_augment: bool, mel_augment: bool):
    """GTZAN clips [b, >= 29 s] -> log-mels [b, 1, n_mels, width] through the
    reference's train pipeline, each example by its ``draws``
    (``sample_gtzan_draws``, which also sizes the masks): its window, peak
    normalisation, {Gain, PitchShift, HighLowPass, Noise}, STFT, time
    stretch, mel, log10, clamp at -4, the stretched-away columns zeroed,
    pad/crop to ``width`` at the drawn position, time and frequency masks."""
    d = draws
    sr = config.sample_rate
    window = sr * config.slice_length
    idx = d["start"][:, None] + torch.arange(window, device=wavs.device)
    wav = peak_normalize(torch.gather(wavs, -1, idx))
    if wav_augment:
        def gate(on, new, old):
            return torch.where(on[:, None], new, old)
        wav = gate(d["gain_on"], aug.gain_db(wav, d["gain_db"]), wav)
        wav = gate(d["pitch_on"], aug.pitch_shift(wav, d["semitones"], config.n_fft,
                                                  config.hop_length), wav)
        filtered = aug.low_or_highpass(wav, d["use_low"], d["low_f"], d["high_f"], sr)
        wav = gate(d["filter_on"], filtered, wav)
        wav = gate(d["noise_on"], aug.add_noise(wav, d["noise"], d["noise_ratio"]), wav)

    mag = stft(wav, config.n_fft, config.hop_length).abs()
    if mel_augment:
        out_frames = int(mag.shape[-1] / 0.8) + 2
        mag, valid = aug.stretch_magnitude(mag, d["rate"], out_frames)
    else:
        valid = torch.full((wav.shape[0],), mag.shape[-1], device=wav.device)
    mel = torch.log10(mel_scale(mag, config.n_mels, sr) + 1e-7)
    mel = torch.clamp(mel, min=-4.0)
    # stretched-away columns are zeroed before the pad/crop, which pads
    # with zeros as the reference does
    cols = torch.arange(mel.shape[-1], device=mel.device)
    mel = mel * (cols < valid[:, None]).to(mel.dtype)[:, None, :]
    mel = aug.adjust_size(mel, config.width, valid, d["insert"])
    if mel_augment:
        mel = aug.time_freq_mask(mel, d["n_rows"], d["row0"], d["n_cols"], d["col0"])
    return mel[:, None]


def valid_chunks_to_mels(wavs: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """Validation pipeline: each clip's num_chunks evenly spaced windows of
    its first 29 s, peak-normalised, through the service's log-mel, no
    augmentation. wavs [b, T >= 29 s] -> [b * chunks, 1, n_mels, width]."""
    window = int(config.slice_length * config.sample_rate)
    hop = slice_hop_samples(config.slice_length, config.num_chunks, config.sample_rate)
    idx = (torch.arange(config.num_chunks, device=wavs.device)[:, None] * hop
           + torch.arange(window, device=wavs.device)[None, :])
    mels = logmel(peak_normalize(wavs[:, idx]), config)      # [b, chunks, n_mels, width]
    return mels.reshape(-1, 1, config.n_mels, config.width)


class MelPipeline(NamedTuple):
    """A batched augment + log-mel pipeline: ``sample(batch, n_samples,
    generator)`` draws what ``apply(wavs, draws)`` takes."""
    sample: Callable
    apply: Callable


def toy_pipeline(config: FrontendConfig, wav_augment: bool = True, mel_augment: bool = True,
                 mask_param: int = 10) -> MelPipeline:
    return MelPipeline(
        lambda b, n, g: sample_toy_draws(b, n, config, wav_augment, mel_augment, mask_param, g),
        lambda w, d: toy_augment_and_mel(w, d, config, wav_augment, mel_augment))


def gtzan_pipeline(config: FrontendConfig, wav_augment: bool = True, mel_augment: bool = True,
                   mask_param: int = 40) -> MelPipeline:
    return MelPipeline(
        lambda b, n, g: sample_gtzan_draws(b, n, config, wav_augment, mel_augment, mask_param, g),
        lambda w, d: gtzan_augment_and_mel(w, d, config, wav_augment, mel_augment))


# ------------------------------------------------------------- train steps

def _specs_of(specs_or_model) -> Sequence[LayerSpec]:
    return getattr(specs_or_model, "specs", specs_or_model)


def sample_step_draws(specs_or_model, per_example_mel: MelPipeline | None, batch_shape,
                      generator: torch.Generator) -> dict:
    """One train step's draws from ``generator``: {"mel": the pipeline's
    draws (where there is a pipeline), "dropout": keep masks}."""
    specs = _specs_of(specs_or_model)
    draws = {}
    if per_example_mel is not None:
        draws["mel"] = per_example_mel.sample(batch_shape[0], batch_shape[-1], generator)
    draws["dropout"] = draw_keep_masks(specs, batch_shape[0], generator)
    return draws


class _SumOverGroup(torch.autograd.Function):
    """all_reduce (sum) of ``x``, whose backward is the all_reduce of the
    gradient: every rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def group_batch_norm(group, x, running_mean, running_var, weight, bias, training=True,
                     momentum=0.1, eps=1e-5):
    """``F.batch_norm``'s training mode on the statistics of the whole
    group's batch: the count and sum, then the sum of squared deviations
    from the global mean, all-reduced with autograd through the reduction
    (the all-reduce XLA inserts for a mean over a sharded axis). The running
    variance takes the unbiased correction of the global count."""
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    sums = _SumOverGroup.apply(
        torch.cat([x.sum(dims), x.new_full((1,), x.numel() / x.shape[1])]), group)
    n = sums[-1]
    mean = sums[:-1] / n
    xc = x - mean.view(shape)
    var = _SumOverGroup.apply((xc * xc).sum(dims), group) / n
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var * (n / (n - 1)), alpha=momentum)
    return xc * torch.rsqrt(var + eps).view(shape) * weight.view(shape) + bias.view(shape)


def _all_reduce_grads(optimizer: torch.optim.Optimizer, group) -> None:
    """Sum every parameter's gradient over the group, in one flat bucket."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def make_train_step(specs_or_model, optimizer: torch.optim.Optimizer,
                    per_example_mel: MelPipeline | None = None, has_bn: bool = False,
                    group=None):
    """The train step ``step(params, batch, labels, draws, n_global=None)
    -> (loss, acc)``.

    ``params`` holds the optimizer's tensors (a ``VGG`` model's own where
    None). With ``per_example_mel`` the batch is raw waveforms and the
    pipeline runs inside the step on ``draws["mel"]``; otherwise the batch is
    mels. The forward (dropout from ``draws["dropout"]``; with ``has_bn``
    BatchNorm on batch statistics, whose running statistics are written
    back into ``params``), the mean softmax cross-entropy, backward and the
    optimizer's update. Loss and accuracy are returned on the device; the
    gradients stay in each tensor's ``.grad``.

    With ``group`` (a ``torch.distributed`` process group) the step is this
    rank's part of one step on a global batch of ``n_global`` rows, of which
    ``batch``, ``labels`` and ``draws`` hold this rank's: the loss is the
    sum of the rank's cross-entropies over ``n_global``, so that the
    gradients, all-reduced in one flat bucket before ``optimizer.step()``,
    are the global mean's, uneven blocks included; BatchNorm normalises with
    the global batch's statistics (``group_batch_norm``); the loss and
    accuracy returned are the global ones."""
    specs = _specs_of(specs_or_model)
    model = specs_or_model if hasattr(specs_or_model, "params") else None
    batch_norm = F.batch_norm if group is None else functools.partial(group_batch_norm, group)

    def step(params, batch, labels, draws, n_global=None):
        params = model.params() if params is None else params
        labels = labels.long()
        if group is not None and n_global is None:
            raise ValueError("a step over a process group needs the global batch's n_global")
        with torch.no_grad():
            mels = per_example_mel.apply(batch, draws["mel"]) if per_example_mel else batch
        if has_bn:
            logits, new = train_forward_with_bn(specs, params, mels, draws["dropout"],
                                                batch_norm=batch_norm)
        else:
            logits = forward(specs, params, mels, train=True, keep_masks=draws["dropout"])
        if group is None:
            loss = F.cross_entropy(logits, labels)
        else:
            loss = F.cross_entropy(logits, labels, reduction="sum") / n_global
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            _all_reduce_grads(optimizer, group)
        optimizer.step()
        with torch.no_grad():
            if has_bn:
                set_running_stats(params, new)
            if group is None:
                return loss.detach(), (logits.argmax(-1) == labels).float().mean()
            totals = torch.stack([loss.detach(),
                                  (logits.argmax(-1) == labels).float().sum() / n_global])
            dist.all_reduce(totals, group=group)
        return totals[0], totals[1]

    return step


def make_eval_step(specs_or_model):
    """``step(params, mels, labels) -> (loss, acc, predictions)``, inference
    mode, on the device."""
    specs = _specs_of(specs_or_model)

    @torch.no_grad()
    def step(params, mels, labels):
        labels = labels.long()
        logits = forward(specs, params, mels)
        pred = logits.argmax(-1)
        return F.cross_entropy(logits, labels), (pred == labels).float().mean(), pred

    return step


# ------------------------------------------------------------ fit harness

@dataclasses.dataclass
class TrainStats:
    train_loss: list = dataclasses.field(default_factory=list)
    train_acc: list = dataclasses.field(default_factory=list)
    valid_losses: list = dataclasses.field(default_factory=list)
    valid_acc: list = dataclasses.field(default_factory=list)

    def save_csv(self, path: str, from_epoch: int = 0):
        fname = os.path.join(path, f"train_stats_{from_epoch}.csv")
        with open(fname, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "train_loss", "train_acc", "valid_losses", "valid_acc"])
            for i in range(len(self.train_loss)):
                w.writerow([i, self.train_loss[i], self.train_acc[i],
                            self.valid_losses[i], self.valid_acc[i]])


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, trainable: dict, state: dict, opt_state: dict, epoch: int,
                    rng_state: torch.Tensor) -> str:
    """``{path}/ckpt_{epoch}.pt``: the trainable params, the BN state, the
    optimizer's state_dict, the epoch and the generator's state (where the
    JAX package keeps its PRNG key), every tensor on the CPU. Written to a
    temporary name in ``path``, then renamed over the final one."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"ckpt_{epoch}.pt")
    tmp = f"{final}.tmp-{os.getpid()}"
    torch.save(_to_cpu({"trainable": trainable, "state": state, "opt_state": opt_state,
                        "epoch": int(epoch), "rng_state": rng_state}), tmp)
    os.replace(tmp, final)
    return final


def load_checkpoint(path: str, epoch: int | None = None) -> dict:
    """A checkpoint of ``save_checkpoint``, on the CPU; ``epoch=None`` takes
    the highest exact ``ckpt_N.pt`` in ``path`` (leftover temporary files of
    an interrupted save are not parsed)."""
    if epoch is None:
        epochs = [int(m.group(1)) for d in os.listdir(path)
                  if (m := re.fullmatch(r"ckpt_(\d+)\.pt", d))]
        if not epochs:
            raise FileNotFoundError(f"no ckpt_*.pt under {path}")
        epoch = max(epochs)
    return torch.load(os.path.join(path, f"ckpt_{epoch}.pt"), map_location="cpu",
                      weights_only=True)


def _on(tree: dict, device) -> dict:
    """{name: {key: tensor}} copied onto ``device`` (the caller's tensors are
    never trained in place)."""
    return {n: {k: v.detach().to(device).clone() for k, v in p.items()} for n, p in tree.items()}


def fit(
    specs,
    params,
    train_batches: Callable,   # () -> iterator of (wavs_or_mels, labels)
    valid_batches: Callable,   # () -> iterator of (mels, labels)
    num_epochs: int = 100,
    lr: float = 1e-4,
    momentum: float = 0.99,
    weight_decay: float = 1e-4,
    per_example_mel: MelPipeline | None = None,
    has_bn: bool = False,
    seed: int = 42,
    model_path: str | None = None,
    save_step: int = 100,
    from_epoch: int = 0,
    resume_from: str | None = None,
    verbose: bool = False,
    device=None,
):
    """Epoch loop over train and valid phases; returns (params, TrainStats).

    ``resume_from``: a checkpoint directory whose params, optimizer state
    and generator state are restored (``load_checkpoint(resume_from,
    from_epoch)``); from_epoch is then the checkpoint's. The draws of every
    step come from one generator on the device, seeded with ``seed``.
    Batches may be numpy arrays or tensors."""
    device = resolve_device(device, "fit")
    generator = torch.Generator(device=device).manual_seed(seed)
    if resume_from is not None:
        ckpt = load_checkpoint(resume_from, from_epoch)
        trainable, state = _on(ckpt["trainable"], device), _on(ckpt["state"], device)
        optimizer = make_optimizer(trainable, lr, momentum, weight_decay)
        optimizer.load_state_dict(ckpt["opt_state"])
        generator.set_state(ckpt["rng_state"])
        from_epoch = int(ckpt["epoch"])
    else:
        trainable, state = split_trainable(_on(params, device))
        optimizer = make_optimizer(trainable, lr, momentum, weight_decay)
    params = merge_params(trainable, state)
    train_step = make_train_step(specs, optimizer, per_example_mel, has_bn)
    eval_step = make_eval_step(specs)
    stats = TrainStats()

    def on_device(batch, labels):
        return torch.as_tensor(batch, device=device), torch.as_tensor(labels, device=device)

    for epoch in range(1, num_epochs + 1):
        # loss and accuracy stay on the device: one synchronisation an epoch
        losses, accs = [], []
        for batch, labels in train_batches():
            batch, labels = on_device(batch, labels)
            draws = sample_step_draws(specs, per_example_mel, batch.shape, generator)
            loss, acc = train_step(params, batch, labels, draws)
            losses.append(loss)
            accs.append(acc)
        stats.train_loss.append(torch.stack(losses).mean().item())
        stats.train_acc.append(torch.stack(accs).mean().item())

        vlosses, vaccs = [], []
        for mels, labels in valid_batches():
            loss, acc, _ = eval_step(params, *on_device(mels, labels))
            vlosses.append(loss)
            vaccs.append(acc)
        stats.valid_losses.append(torch.stack(vlosses).mean().item())
        stats.valid_acc.append(torch.stack(vaccs).mean().item())

        if verbose:
            print(f"epoch {epoch}: train {stats.train_loss[-1]:.4f}/"
                  f"{stats.train_acc[-1]*100:.1f}% valid {stats.valid_losses[-1]:.4f}/"
                  f"{stats.valid_acc[-1]*100:.1f}%", flush=True)

        if model_path and (epoch % save_step == 0 or epoch == num_epochs):
            save_checkpoint(model_path, trainable, state, optimizer.state_dict(),
                            epoch + from_epoch, generator.get_state())
            stats.save_csv(model_path, from_epoch)

    return {n: {k: v.detach() for k, v in p.items()} for n, p in params.items()}, stats
