"""Epoch training loop (port of ``tpuasr/train/loop.py``).

SortaGrad epoch schedule, per-iteration loss logging with a deferred
host sync, per-epoch greedy validation WER/CER, the learning rate
annealed per epoch, per-epoch and per-batch checkpoints, best-model
tracking, ``--continue-from`` exact resume (mid-epoch too) and
``--finetune`` (weights only). Checkpoints are ``.tpuasr`` files that
the JAX package reads and resumes, and vice versa.

Augmentation (``augment_fn``) draws per step from
``step_generator(device, seed, iteration)``, a function of the global
step, so a mid-epoch resume draws what the continuous run drew. With a
device-resident corpus (a loader with ``bucket_chunks``) each bucket's
schedule trains as one chunk (``make_resident_epoch_runner``): one index
copy in, the steps queued with nothing read back, one read-back of the
chunk's metrics. ``--checkpoint-per-batch N`` caps a chunk at N steps
with a checkpoint after each; preemption is checked between chunks.
Validation stays on the per-batch loader. ``profile_dir`` traces global
steps [10, 15) with ``profiling.StepProfiler``.

Distributed (``mesh``, a ``train.mesh.Mesh`` from ``make_mesh``): the
loaders hold this rank's data shard (data index and data-group size).
Rank 0's parameters and BatchNorm statistics are broadcast to every
rank, then the model is put on the mesh (``shard_model_``; parameters
and momentum sharded by ``param_sharding_specs``) and every step is the
single-process step on the global batch. Every rank runs every
validation batch (an unsharded loader, as the JAX package's), so WER and
CER are the single-process ones. Rank 0 alone writes logs, TensorBoard
and checkpoints; a checkpoint holds the whole (single-device) layout,
its sharded leaves gathered first, so it resumes at any world size and
tp in both packages. A preemption signal stops every rank: the flag is
all-reduced (MAX, host only) where the loop checks it.

``model_path`` is written as the JAX package writes it: after a
validation whose WER is no worse than the best so far, and also after an
epoch without validation, whose WER is NaN.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.compat.weights import (
    init_train_variables,
    load_momentum,
    model_from_variables,
    momentum_buffers,
    momentum_to_opt_state,
    to_jax_variables,
)
from tpuasr_torch.data.loader import AudioBatchLoader
from tpuasr_torch.decode.greedy import GreedyDecoder
from tpuasr_torch.decode.metrics import ErrorRateMeter
from tpuasr_torch.device import resolve_device
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model.ds2 import ModelConfig
from tpuasr_torch.profiling import StepProfiler, span
from tpuasr_torch.train.checkpoint import CheckpointPackage, load_checkpoint, save_checkpoint
from tpuasr_torch.train.logging import AverageMeter, MetricsLogger
from tpuasr_torch.train.mesh import (
    Mesh,
    broadcast_module_,
    local_shard,
    shard_model_,
    whole_state,
    whole_tensors,
)
from tpuasr_torch.train.step import (
    TrainConfig,
    make_eval_step,
    make_resident_epoch_runner,
    make_train_step,
    step_generator,
)


@dataclass
class LoopConfig:
    epochs: int = 70
    seed: int = 123456
    save_folder: str | None = None
    model_path: str | None = None  # best-model path
    checkpoint_per_epoch: bool = True
    checkpoint_per_batch: int = 0  # 0 = off
    log_dir: str | None = None
    tensorboard: bool = False
    quiet: bool = False
    profile_dir: str | None = None  # a torch.profiler trace of steps 10-15
    # metrics stay on the device and are read (a blocking sync) every
    # N steps; 1 reproduces the reference's per-iteration readout
    sync_every: int = 10
    # validation every N epochs; the final epoch always evaluates, and
    # skipped epochs record NaN
    eval_every: int = 1


class _PreemptionExit(Exception):
    pass


class PreemptionGuard:
    """SIGTERM/SIGINT -> save an exact-resume checkpoint at the next step
    boundary and return, instead of dying mid-step. A second signal
    raises KeyboardInterrupt. No-op outside the main thread."""

    def __init__(self):
        self.triggered = False
        self._prev: dict = {}
        self._installed = False
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handler)
            self._installed = True

    def _handler(self, signum, frame):
        if self.triggered:
            raise KeyboardInterrupt
        self.triggered = True

    def restore(self):
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._installed = False


def evaluate(eval_step, loader: AudioBatchLoader,
             alphabet: Alphabet) -> tuple[float, float, float]:
    """Greedy-decode validation. Returns (wer, cer, 0.0) in percent."""
    decoder = GreedyDecoder(alphabet)
    meter = ErrorRateMeter()
    for batch in loader.epoch(0):
        logits, out_lengths = eval_step(batch.waves, batch.wave_lengths)
        for j, (hyp, ref) in enumerate(zip(decoder.decode(logits, out_lengths), batch.texts)):
            if batch.valid[j]:
                meter.update(hyp, ref)
    return meter.wer, meter.cer, 0.0


def read_back(metrics: dict) -> dict:
    """Metrics tensors (0-d, or stacked over a chunk) as host float64
    arrays, in one copy from the device (span ``train.read_back``: the
    wait for the card and the copy)."""
    with span("train.read_back"):
        vals = torch.stack([v.to(torch.float64) for v in metrics.values()]).cpu().numpy()
    return dict(zip(metrics, vals))


def rank_train_step(variables: dict, model_cfg: ModelConfig, frontend_cfg: FrontendConfig,
                    train_cfg: TrainConfig, device, mesh: Mesh, direction_tp: bool = False,
                    augment_fn=None):
    """This rank's (model, train step): ``variables`` as a trainable model
    on ``device``, rank 0's parameters and statistics broadcast to every
    rank, put on ``mesh`` (``shard_model_``; ``model.sharded`` names the
    sharded leaves), and its step on the global batch, whose inputs are
    this rank's rows."""
    model = model_from_variables(variables, model_cfg, device, trainable=True)
    broadcast_module_(model, mesh)
    shard_model_(model, mesh, direction_tp)
    return model, make_train_step(model, frontend_cfg, train_cfg, augment_fn, mesh)


def train(model_cfg: ModelConfig, frontend_cfg: FrontendConfig, train_cfg: TrainConfig,
          loop_cfg: LoopConfig, train_loader: AudioBatchLoader,
          val_loader: AudioBatchLoader | None, alphabet: Alphabet,
          continue_from: str | None = None, finetune: bool = False,
          device: str | torch.device = "cuda", augment_fn=None, mesh: Mesh | None = None,
          direction_tp: bool = False) -> CheckpointPackage:
    """Train on ``device`` (CUDA unless the CPU is asked for) and return
    the last checkpoint package. A fresh model is drawn from flax's init
    distributions with ``loop_cfg.seed``; ``continue_from`` adopts the
    checkpoint's model, frontend and alphabet, and unless ``finetune``
    its optimizer state, progress and histories. ``augment_fn`` (an
    ``audio.augment.AugmentFn``) augments every training batch; a
    ``data.resident.ResidentBatchLoader`` trains a chunk per bucket.
    ``mesh`` (every rank calls ``train`` with its own) runs the
    distributed step; ``direction_tp`` shards the recurrent layers by
    direction instead of by gate columns (tp = 2, bidirectional)."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else Mesh()
    main = mesh.is_main
    logger = MetricsLogger(loop_cfg.log_dir if main else None,
                           loop_cfg.tensorboard and main, loop_cfg.quiet or not main)
    start_epoch, iteration, start_batch = 0, 0, 0
    histories: dict = {"loss": [], "wer": [], "cer": []}
    best_wer = float("inf")
    pkg = None
    if continue_from:
        pkg = load_checkpoint(continue_from)
        model_cfg, frontend_cfg, alphabet = pkg.model_config, pkg.frontend_config, pkg.alphabet
        variables = pkg.variables
    else:
        variables = init_train_variables(model_cfg, seed=loop_cfg.seed)
    model, train_step = rank_train_step(variables, model_cfg, frontend_cfg, train_cfg, dev,
                                        mesh, direction_tp, augment_fn)
    sharded = model.sharded
    eval_step = make_eval_step(model, frontend_cfg)
    optimizer = train_step.optimizer
    use_epoch_scan = hasattr(train_loader, "bucket_chunks")
    if use_epoch_scan:
        epoch_runner = make_resident_epoch_runner(train_step, seed=loop_cfg.seed)
    gen = torch.Generator(device=dev) if augment_fn is not None else None
    if pkg is not None and not finetune:  # exact resume
        if pkg.opt_state is not None:
            load_momentum(model, optimizer, pkg.opt_state,
                          lambda name, t: local_shard(t, sharded[name], mesh)
                          if name in sharded else t)
        start_epoch, iteration, start_batch = pkg.epoch, pkg.iteration, pkg.epoch_batch
        histories = {"loss": list(pkg.loss_history), "wer": list(pkg.wer_history),
                     "cer": list(pkg.cer_history)}
        best_wer = pkg.best_wer

    def make_pkg(epoch: int, epoch_batch: int = 0) -> CheckpointPackage:
        """The checkpoint package in the single-device layout (every model
        rank calls it: the sharded leaves are gathered whole)."""
        return CheckpointPackage(
            model_config=model_cfg, frontend_config=frontend_cfg, labels=alphabet.labels,
            variables=to_jax_variables(model, whole_state(model, mesh)),
            opt_state=momentum_to_opt_state(
                model, optimizer,
                whole_tensors(momentum_buffers(model, optimizer), sharded, mesh)),
            epoch=epoch, iteration=iteration, epoch_batch=epoch_batch,
            loss_history=histories["loss"], wer_history=histories["wer"],
            cer_history=histories["cer"], best_wer=best_wer)

    profiler = StepProfiler(loop_cfg.profile_dir if main else None)
    guard = PreemptionGuard()

    def stop() -> bool:
        return mesh.any(guard.triggered)

    def save(path: str, package: CheckpointPackage) -> None:
        if main:
            save_checkpoint(path, package)

    pkg = make_pkg(start_epoch, start_batch)
    epoch, epoch_done = start_epoch, start_batch
    try:
        for epoch in range(start_epoch, loop_cfg.epochs):
            lr = train_cfg.lr_at_epoch(epoch)  # anneal: lr / anneal**epoch
            loss_meter = AverageMeter()
            epoch_start = t_prev = window_t0 = time.time()
            window_data = 0.0
            pending: list = []  # (iteration, batch index, metrics on the device, utterances)
            n_total = train_loader.num_batches(epoch)

            def drain():
                nonlocal window_t0, window_data
                if not pending:
                    return
                # read first: the values wait for every queued step, so
                # the window's wall time is throughput, not dispatch rate
                rows = [(it, {k: float(v) for k, v in read_back(m).items()}, n)
                        for it, _, m, n in pending]
                wall = time.time() - window_t0
                per_step, per_data = wall / len(rows), window_data / len(rows)
                for it, vals, n in rows:
                    loss_meter.update(vals["loss"], n=n)
                    logger.log(it, {**vals, "lr": lr, "epoch": epoch, "step_time": per_step,
                                    "data_time": per_data}, prefix="train/")
                utts = sum(n for *_, n in rows)
                logger.console(
                    f"Epoch {epoch} [{pending[-1][1]}/{n_total}] "
                    f"loss {loss_meter.val:.4f} (avg {loss_meter.avg:.4f}) "
                    f"step {per_step * 1e3:.0f}ms data {per_data * 1e3:.0f}ms "
                    f"({utts / max(wall, 1e-9):.1f} utt/s)")
                pending.clear()
                logger.flush()
                window_t0, window_data = time.time(), 0.0

            # mid-epoch resume: skip the batches the checkpoint consumed;
            # the schedule is a function of (seed, epoch)
            resume_skip = start_batch if epoch == start_epoch else 0
            epoch_done = resume_skip
            if use_epoch_scan:
                cap = loop_cfg.checkpoint_per_batch
                pos = 0  # batches of this epoch's schedule seen so far
                for b, bank, idx_mat, n_valid, valid_mat in train_loader.bucket_chunks(epoch):
                    n_bucket = idx_mat.shape[0]
                    # --checkpoint-per-batch N caps a chunk at N batches
                    # (saves and preemption are host events); 0 = one
                    # chunk per bucket
                    for s in range(0, n_bucket, cap) if cap else (0,):
                        e = min(s + cap, n_bucket) if cap else n_bucket
                        lo, pos = pos, pos + e - s
                        if pos <= resume_skip:
                            continue  # consumed before the resume point
                        # a checkpoint from another cap or path: slice
                        # off the consumed rows
                        r0 = s + max(resume_skip - lo, 0)
                        if stop():
                            raise _PreemptionExit
                        k = e - r0
                        t0 = time.time()
                        vals = read_back(epoch_runner(bank, idx_mat[r0:e], valid_mat[r0:e], lr,
                                                      iteration, profiler))
                        wall = time.time() - t0
                        per_step = wall / k
                        for j in range(k):
                            iteration += 1
                            loss_meter.update(float(vals["loss"][j]), n=int(n_valid[r0 + j]))
                            logger.log(iteration, {**{kk: float(v[j]) for kk, v in vals.items()},
                                                   "lr": lr, "epoch": epoch,
                                                   "step_time": per_step, "data_time": 0.0},
                                       prefix="train/")
                        epoch_done += k
                        logger.console(
                            f"Epoch {epoch} bucket {b} [{epoch_done}/{n_total}] "
                            f"loss {loss_meter.val:.4f} (avg {loss_meter.avg:.4f}) "
                            f"step {per_step * 1e3:.0f}ms "
                            f"({int(n_valid[r0:e].sum()) / max(wall, 1e-9):.1f} utt/s)")
                        logger.flush()
                        if cap and loop_cfg.save_folder:
                            save(f"{loop_cfg.save_folder}/tpuasr_e{epoch}_b{epoch_done}.ckpt",
                                 make_pkg(epoch, epoch_done))
                        if stop():
                            raise _PreemptionExit
            else:
                for i, batch in enumerate(train_loader.epoch(epoch)):
                    if i < resume_skip:
                        continue
                    if stop():
                        raise _PreemptionExit
                    window_data += time.time() - t_prev
                    if gen is not None:
                        step_generator(dev, loop_cfg.seed, iteration, gen)
                    profiler.maybe_start(iteration)
                    metrics = train_step(batch.waves, batch.wave_lengths, batch.labels,
                                         batch.label_lengths, batch.valid, lr, gen)
                    iteration += 1
                    epoch_done = i + 1
                    profiler.maybe_stop(iteration)
                    pending.append((iteration, i, metrics, batch.size))
                    t_prev = time.time()
                    if len(pending) >= max(loop_cfg.sync_every, 1):
                        drain()
                    if (loop_cfg.checkpoint_per_batch and loop_cfg.save_folder
                            and (i + 1) % loop_cfg.checkpoint_per_batch == 0):
                        drain()
                        save(f"{loop_cfg.save_folder}/tpuasr_e{epoch}_b{i + 1}.ckpt",
                             make_pkg(epoch, i + 1))
                drain()

            histories["loss"].append(loss_meter.avg)
            wer, cer = float("nan"), float("nan")
            eval_this = ((epoch + 1) % max(loop_cfg.eval_every, 1) == 0
                         or epoch + 1 == loop_cfg.epochs)
            if val_loader is not None and eval_this:
                wer, cer, _ = evaluate(eval_step, val_loader, alphabet)
            histories["wer"].append(wer)
            histories["cer"].append(cer)
            logger.log(epoch, {"loss": loss_meter.avg, "wer": wer, "cer": cer,
                               "epoch_time": time.time() - epoch_start}, prefix="epoch/")
            logger.console(
                f"Epoch {epoch} done in {time.time() - epoch_start:.1f}s: "
                f"loss {loss_meter.avg:.4f} WER {wer:.2f} CER {cer:.2f} lr {lr:.2e}")

            pkg = make_pkg(epoch + 1)
            if loop_cfg.save_folder and loop_cfg.checkpoint_per_epoch:
                save(f"{loop_cfg.save_folder}/tpuasr_{epoch + 1}.ckpt", pkg)
            if loop_cfg.model_path and (np.isnan(wer) or wer <= best_wer):
                if not np.isnan(wer):
                    best_wer = pkg.best_wer = wer
                save(loop_cfg.model_path, pkg)
    except _PreemptionExit:
        pkg = make_pkg(epoch, epoch_done)
        if loop_cfg.save_folder:
            path = f"{loop_cfg.save_folder}/tpuasr_preempt.ckpt"
            save(path, pkg)
            logger.console(f"preemption signal: saved {path}; resume with "
                           f"--continue-from {path}")
        else:
            logger.console("preemption signal: stopping (no --save-folder, "
                           "nothing persisted)")
    finally:
        guard.restore()
    profiler.close()
    logger.close()
    return pkg
