"""Train and eval steps (port of ``tpuasr/train/step.py``).

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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpuasr_torch.audio.frontend import FrontendConfig, log_spectrogram
from tpuasr_torch.ctc.loss import ctc_loss
from tpuasr_torch.model.ds2 import DeepSpeech2


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


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.to(torch.float32).square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm where
    norm >= max_norm, unchanged otherwise."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def batch_loss(model: DeepSpeech2, frontend_cfg: FrontendConfig, waves, wave_lengths,
               labels, label_lengths, valid):
    """The train step's loss on one batch, before any update: the mean
    CTC loss over the ok utterances (train-mode BatchNorm, so running
    statistics move). Returns (loss, n_ok, n_frames), 0-d tensors on
    the model's device."""
    device = next(model.parameters()).device
    waves = _waves_to_float(torch.as_tensor(waves, device=device))
    lengths = torch.as_tensor(wave_lengths, device=device).to(torch.int64)
    labels = torch.as_tensor(labels, device=device).to(torch.int64)
    label_lengths = torch.as_tensor(label_lengths, device=device).to(torch.int64)
    valid = torch.as_tensor(valid, device=device).to(torch.bool)
    with torch.no_grad():
        feats, feat_lengths = log_spectrogram(waves, lengths, frontend_cfg)
    # padding rows must not enter BatchNorm statistics: length 0
    feat_lengths = torch.where(valid, feat_lengths, 0)
    logits, out_lengths = model(feats, feat_lengths, train=True)
    per_utt = ctc_loss(logits, out_lengths, labels, label_lengths)
    ok = valid & (label_lengths <= out_lengths) & torch.isfinite(per_utt) & (per_utt < 1e29)
    n_ok = ok.sum()
    loss = torch.where(ok, per_utt, 0.0).sum() / n_ok.clamp(min=1)
    return loss, n_ok, (feat_lengths * valid).sum()


def make_train_step(model: DeepSpeech2, frontend_cfg: FrontendConfig,
                    train_cfg: TrainConfig):
    """Returns ``train_step(waves, wave_lengths, labels, label_lengths,
    valid, lr) -> metrics`` updating ``model`` (parameters and running
    statistics) and its optimizer in place. Inputs may be numpy arrays
    or tensors; metrics are 0-d tensors on the model's device: ``loss``
    (mean over ok utterances), ``grad_norm`` (before clipping),
    ``param_norm`` (after the update), ``n_ok`` and ``n_frames``.
    The optimizer (its momentum buffers are the state that checkpoints
    keep) is ``train_step.optimizer``."""
    optimizer = make_optimizer(model, train_cfg)
    params = list(model.parameters())
    if model.config.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32

    def train_step(waves, wave_lengths, labels, label_lengths, valid, lr: float):
        loss, n_ok, n_frames = batch_loss(model, frontend_cfg, waves, wave_lengths,
                                          labels, label_lengths, valid)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        grads = [p.grad for p in params]
        with torch.no_grad():
            grad_norm = global_norm(grads)
            clip_by_global_norm_(grads, train_cfg.max_norm, grad_norm)
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
            param_norm = global_norm(params)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm,
                "n_ok": n_ok, "n_frames": n_frames}

    train_step.optimizer = optimizer
    return train_step
