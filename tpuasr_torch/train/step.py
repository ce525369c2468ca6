"""Train and eval steps, and the runners over a device-resident corpus
(port of ``tpuasr/train/step.py``).

The reference recipe: forward in train mode, the CTC loss per
utterance, its mean over the usable utterances, backward, the gradient
clipped to a global norm of 400 and a Nesterov SGD step with the
learning rate of the epoch. The frontend runs on the device with the
model. The per-utterance ``ok`` mask drops batch padding (``valid`` is
False, its frame count set to 0 so that no BatchNorm statistic sees
it), infeasible utterances (more labels than frames) and non-finite
losses, instead of skipping the whole batch.

Optimizer: optax's ``clip_by_global_norm`` (scale by max_norm / norm
only when norm >= max_norm, no epsilon; torch's ``clip_grad_norm_``
divides by norm + 1e-6) followed by ``torch.optim.SGD(momentum=0.9,
nesterov=True, dampening=0)``, which equals optax's
``trace(nesterov=True)`` followed by ``-lr`` from the first step on.

Augmentation runs in the step, before the loss and without gradients:
waves, ``augment_fn.waves`` (tempo or speed with gain, then noise, which
change the lengths), the frontend, ``augment_fn.feats`` (SpecAugment).
Its draws come from a generator on the batch's device seeded with
``step_seed(seed, iteration)``, the counterpart of the JAX package's
``fold_in(PRNGKey(seed), iteration)``: the stream is a function of the
global step alone, so a run resumed mid-epoch, or cut into other
chunks, draws what the continuous run drew.

Distributed (``mesh``, a ``train.mesh.Mesh``): each rank of a data
group runs its own rows of the global batch, the ranks' local batches
concatenated in data-rank order, and the step is the single-process
step on that batch. The BatchNorms take global statistics (the model's
data group), the loss divides each rank's sum by the global count of
usable utterances (all-reduced before the backward), the gradients and
the loss are summed over the data group in one flat all-reduce after
the backward, and the global norms count a replicated parameter once
and sum a sharded one's squares over the model group. Augmentation
draws for every row of the global batch and applies the rank's own.

The resident runners take a chunk of K batches of one bucket as a (K, B)
matrix of bank rows: one copy of the indices to the card, then per row a
gather from the bank and the whole step (or eval forward and decode)
with nothing read back, then one read-back for the chunk by the caller.
PyTorch has no ``lax.scan``; the host loop over the rows only queues
work, so the card runs the chunk without waiting for the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpuasr_torch.audio.frontend import FrontendConfig, log_spectrogram
from tpuasr_torch.ctc.loss import ctc_loss
from tpuasr_torch.device import to_device
from tpuasr_torch.model.ds2 import DeepSpeech2
from tpuasr_torch.parallel import all_reduce
from tpuasr_torch.train.mesh import Mesh


def _waves_to_float(waves: torch.Tensor) -> torch.Tensor:
    """int16 PCM batches are rescaled on the device; float batches pass
    through."""
    if not torch.is_floating_point(waves):
        return waves.to(torch.float32) * (1.0 / 32768.0)
    return waves


def make_eval_step(model: DeepSpeech2, frontend_cfg: FrontendConfig):
    """Returns ``eval_step(waves, wave_lengths) -> (logits, out_lengths)``
    on the model's device, eval-mode BN. Inputs may be numpy arrays or
    tensors; outputs are tensors on the device: logits (B, T', C) f32,
    out_lengths (B,) int64."""
    device = next(model.parameters()).device
    if model.config.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32

    @torch.inference_mode()
    def eval_step(waves, wave_lengths):
        waves = _waves_to_float(torch.as_tensor(waves, device=device))
        lengths = torch.as_tensor(wave_lengths, device=device).to(torch.int64)
        feats, feat_lengths = log_spectrogram(waves, lengths, frontend_cfg)
        return model(feats, feat_lengths)

    return eval_step


@dataclass(frozen=True)
class TrainConfig:
    """The reference's optimizer flags: --lr 3e-4 --momentum 0.9
    (Nesterov) --max-norm 400 --learning-anneal 1.1. ``ctc_impl`` is
    kept for the CLI and checkpoints; the port runs one CTC function."""

    lr: float = 3e-4
    momentum: float = 0.9
    nesterov: bool = True
    max_norm: float = 400.0
    learning_anneal: float = 1.1
    ctc_impl: str = "scan"

    def lr_at_epoch(self, epoch: int) -> float:
        return self.lr / (self.learning_anneal ** epoch)


def make_optimizer(model: DeepSpeech2, cfg: TrainConfig) -> torch.optim.SGD:
    return torch.optim.SGD(model.parameters(), lr=cfg.lr, momentum=cfg.momentum,
                           nesterov=cfg.nesterov, dampening=0.0)


def global_norm(tensors, sharded=(), group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm):
    of ``tensors`` (replicated: counted once) and of ``sharded`` (this
    rank's shards, whose squares are summed over the model ``group``)."""
    sq = sum(t.to(torch.float32).square().sum() for t in tensors)
    if sharded:
        sq = sq + all_reduce(sum(t.to(torch.float32).square().sum() for t in sharded), group)
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm where
    norm >= max_norm, unchanged otherwise."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def step_seed(seed: int, iteration: int) -> int:
    """The seed of global step ``iteration``'s augmentation stream: a
    fixed function of (seed, iteration), as fold_in(PRNGKey(seed),
    iteration) is in the JAX package."""
    return ((seed & 0xFFFFFFFF) << 32) | (iteration & 0xFFFFFFFF)


def step_generator(device, seed: int, iteration: int,
                   gen: torch.Generator | None = None) -> torch.Generator:
    """A generator on ``device`` (``gen``, reseeded, when given) seeded
    for global step ``iteration``. Seeding is host state only: it never
    waits for the card."""
    gen = gen if gen is not None else torch.Generator(device=device)
    return gen.manual_seed(step_seed(seed, iteration))


def batch_loss(model: DeepSpeech2, frontend_cfg: FrontendConfig, waves, wave_lengths,
               labels, label_lengths, valid, augment_fn=None, gen=None, mesh: Mesh | None = None):
    """The train step's loss on one batch, before any update: the mean
    CTC loss over the ok utterances (train-mode BatchNorm, so running
    statistics move). ``augment_fn`` (an ``audio.augment.AugmentFn``)
    draws from ``gen``, a generator on the model's device. Returns
    (loss, n_ok, n_frames), 0-d tensors on the model's device. With a
    ``mesh`` the batch is this rank's rows of the global batch: n_ok and
    n_frames are the global counts, and the loss is this rank's part of
    the global mean (its rows' sum over the global n_ok; the parts sum
    to the mean)."""
    data = mesh.data if mesh is not None else None
    b = np.shape(waves)[0]
    rows = (data.index * b, data.size * b) if data is not None else None
    device = next(model.parameters()).device
    waves = _waves_to_float(torch.as_tensor(waves, device=device))
    lengths = torch.as_tensor(wave_lengths, device=device).to(torch.int64)
    labels = torch.as_tensor(labels, device=device).to(torch.int64)
    label_lengths = torch.as_tensor(label_lengths, device=device).to(torch.int64)
    valid = torch.as_tensor(valid, device=device).to(torch.bool)
    with torch.no_grad():
        if augment_fn is not None:
            waves, lengths = augment_fn.waves(gen, waves, lengths, rows)
        feats, feat_lengths = log_spectrogram(waves, lengths, frontend_cfg)
        if augment_fn is not None:
            feats = augment_fn.feats(gen, feats, feat_lengths, rows)
    # padding rows must not enter BatchNorm statistics: length 0
    feat_lengths = torch.where(valid, feat_lengths, 0)
    logits, out_lengths = model(feats, feat_lengths, train=True)
    per_utt = ctc_loss(logits, out_lengths, labels, label_lengths)
    ok = valid & (label_lengths <= out_lengths) & torch.isfinite(per_utt) & (per_utt < 1e29)
    n_ok, n_frames = ok.sum(), (feat_lengths * valid).sum()
    if data is not None:
        n_ok, n_frames = all_reduce(torch.stack([n_ok, n_frames]), data).unbind(0)
    loss = torch.where(ok, per_utt, 0.0).sum() / n_ok.clamp(min=1)
    return loss, n_ok, n_frames


def make_train_step(model: DeepSpeech2, frontend_cfg: FrontendConfig,
                    train_cfg: TrainConfig, augment_fn=None, mesh: Mesh | None = None):
    """Returns ``train_step(waves, wave_lengths, labels, label_lengths,
    valid, lr, gen=None) -> metrics`` updating ``model`` (parameters and
    running statistics) and its optimizer in place; ``gen`` is the
    step's generator (``step_generator``), needed with ``augment_fn``.
    Inputs may be numpy arrays or tensors; metrics are 0-d tensors on
    the model's device: ``loss`` (mean over ok utterances),
    ``grad_norm`` (before clipping), ``param_norm`` (after the update),
    ``n_ok`` and ``n_frames``. The optimizer (its momentum buffers are
    the state that checkpoints keep) is ``train_step.optimizer``, the
    device ``train_step.device``. With a ``mesh`` (the model already put
    on it by ``train.mesh.shard_model_``) the inputs are this rank's
    rows and the metrics are the global step's."""
    optimizer = make_optimizer(model, train_cfg)
    params = list(model.parameters())
    mesh = mesh if mesh is not None else Mesh()
    named = list(model.named_parameters())
    replicated = [p for n, p in named if n not in model.sharded]
    sharded = [p for n, p in named if n in model.sharded]

    def norm(tensors_of):
        return global_norm([tensors_of(p) for p in replicated],
                           [tensors_of(p) for p in sharded], mesh.model)
    if model.config.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32

    def train_step(waves, wave_lengths, labels, label_lengths, valid, lr: float, gen=None):
        if augment_fn is not None and gen is None:
            raise ValueError("an augmenting train step needs the step's generator")
        loss, n_ok, n_frames = batch_loss(model, frontend_cfg, waves, wave_lengths,
                                          labels, label_lengths, valid, augment_fn, gen, mesh)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        grads = [p.grad for p in params]
        with torch.no_grad():
            loss = loss.detach()
            if mesh.data is not None:  # one flat all-reduce: the gradients and the loss
                flat = all_reduce(torch.cat([g.reshape(-1) for g in grads] + [loss[None]]),
                                  mesh.data)
                for g, part in zip(grads, flat.split([g.numel() for g in grads] + [1])):
                    g.copy_(part.view_as(g))
                loss = flat[-1]
            grad_norm = norm(lambda p: p.grad)
            clip_by_global_norm_(grads, train_cfg.max_norm, grad_norm)
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
            param_norm = norm(lambda p: p)
        return {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm,
                "n_ok": n_ok, "n_frames": n_frames}

    train_step.optimizer = optimizer
    train_step.augment_fn = augment_fn
    train_step.mesh = mesh
    train_step.device = params[0].device
    return train_step


def chunk_to_device(device: torch.device, *mats) -> tuple:
    """A chunk's (K, B) host matrices (bank rows, valid flags) on
    ``device`` as int64, in one copy that the host does not wait for."""
    return tuple(to_device(np.stack([np.asarray(m, np.int64) for m in mats]), device))


def _gather(bank, idx: torch.Tensor):
    return (bank.waves.index_select(0, idx), bank.wave_lengths.index_select(0, idx),
            bank.labels.index_select(0, idx), bank.label_lengths.index_select(0, idx))


def make_resident_epoch_runner(train_step, seed: int = 0):
    """Training over a device-resident bank (``data.resident``), a
    chunk of K batches a call, through ``train_step`` (its model,
    optimizer and augmentation). Returns ``run_epoch(bank, idx_mat
    (K, B), valid_mat (K, B), lr, k0, profiler=None) -> metrics``, each
    metric stacked over the K steps, on the device, nothing read back.
    Step k draws from ``step_generator(device, seed, k0 + k)``, so chunk
    boundaries do not move the stream; ``profiler`` (a
    ``train.profiling.StepProfiler``) sees global steps k0 + k."""
    device = train_step.device
    augment = train_step.augment_fn is not None

    def run_epoch(bank, idx_mat, valid_mat, lr: float, k0: int, profiler=None):
        idx, valid = chunk_to_device(device, idx_mat, valid_mat)
        valid = valid.to(torch.bool)
        gen = torch.Generator(device=device) if augment else None
        rows = []
        for k in range(idx.shape[0]):
            if augment:
                step_generator(device, seed, k0 + k, gen)
            if profiler is not None:
                profiler.maybe_start(k0 + k)
            rows.append(train_step(*_gather(bank, idx[k]), valid[k], lr, gen))
            if profiler is not None:
                profiler.maybe_stop(k0 + k + 1)
        return {key: torch.stack([m[key] for m in rows]) for key in rows[0]}

    return run_epoch


def make_resident_eval_runner(model: DeepSpeech2, frontend_cfg: FrontendConfig,
                              blank_id: int = 0):
    """Evaluation over a device-resident bank: ``run(bank, idx_mat
    (K, B)) -> (ids (K, B, T'), emit (K, B, T'), out_lengths (K, B))``,
    eval forward and greedy best path per row, on the device. The host
    only assembles strings from the emit masks."""
    from tpuasr_torch.decode.greedy import greedy_best_path

    eval_step = make_eval_step(model, frontend_cfg)
    device = next(model.parameters()).device

    def run(bank, idx_mat):
        (idx,) = chunk_to_device(device, idx_mat)
        outs = []
        for k in range(idx.shape[0]):
            waves, wl, _, _ = _gather(bank, idx[k])
            logits, out_lengths = eval_step(waves, wl)
            outs.append((*greedy_best_path(logits, out_lengths, blank_id=blank_id),
                         out_lengths))
        return tuple(torch.stack(x) for x in zip(*outs))

    return run


def make_resident_beam_eval_runner(model: DeepSpeech2, frontend_cfg: FrontendConfig,
                                   beam_width: int, blank_id: int, cutoff_top_n: int = 40,
                                   cutoff_prob: float = 1.0, prune_logp: float = -20.0,
                                   **lm_kw):
    """Beam-search evaluation over a device-resident bank: ``run(bank,
    idx_mat (K, B)) -> (parents (K, B, T', W), chars (K, B, T', W),
    scores (K, B, W))``, eval forward, log-softmax and K3 (``ops.beam
    .beam_scan``, with ``lm_kw``'s LM fusion: ``DeviceBeamDecoder
    .kernel_lm_kwargs``) per row, on the device. Any W and class count:
    the caller reads them back with ``DeviceBeamDecoder.to_host``, one
    packed copy where they pack into int16."""
    from tpuasr_torch.ops.beam import beam_scan

    eval_step = make_eval_step(model, frontend_cfg)
    device = next(model.parameters()).device

    def run(bank, idx_mat):
        (idx,) = chunk_to_device(device, idx_mat)
        outs = []
        for k in range(idx.shape[0]):
            waves, wl, _, _ = _gather(bank, idx[k])
            logits, out_lengths = eval_step(waves, wl)
            lp = torch.log_softmax(logits.to(torch.float32), dim=-1).contiguous()
            outs.append(beam_scan(lp, out_lengths.to(torch.int32).contiguous(),
                                  beam_width=beam_width, blank_id=blank_id,
                                  cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
                                  prune_logp=prune_logp, **lm_kw))
        return tuple(torch.stack(x) for x in zip(*outs))

    return run
