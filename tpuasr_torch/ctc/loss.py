"""CTC loss (port of ``tpuasr/ctc/loss.py``).

Warp-ctc semantics: unsoftmaxed logits in, log-softmax inside, the
negative log-likelihood per utterance out, blank 0, log-zero the finite
LOG_EPS = -1e30 so that no gradient is NaN. An utterance whose labels
cannot fit its frames gets a large finite loss that the train step's
``ok`` mask drops.

``ctc_loss`` builds the extended label sequence and its masks as
``_ctc_loss_pallas_local`` does and runs ``CTCFromEmit`` (the alpha
and beta kernels on CUDA, their plain versions on the CPU); it stands
for both ``--ctc-impl`` choices of the JAX package. The emissions are a
gather of the log-softmax, which equals the JAX package's one-hot
contraction exactly (one non-zero term). ``ctc_loss_autograd`` is the
scan formulation (``tpuasr/ctc/loss.py:ctc_loss``) as a plain loop
under torch autograd, an independent oracle for the tests.

Distributed training needs no collective here: the loss and both
kernels work per utterance, so each rank runs its own rows, which is
what the JAX package's ``shard_map`` over ``data`` gives each shard
(``tpuasr/ctc/loss.py:160-175``); ``train.step`` divides by the global
count of usable utterances.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops.ctc import LOG_EPS, CTCFromEmit, _lse3


def _extended(labels, label_lengths, blank_id):
    """z (B, S), s index (1, S), valid_s and allow_skip (B, S) bool."""
    b, l_max = labels.shape
    s_max = 2 * l_max + 1
    z = torch.full((b, s_max), blank_id, dtype=labels.dtype, device=labels.device)
    z[:, 1::2] = labels
    s_idx = torch.arange(s_max, device=labels.device)[None, :]
    valid_s = s_idx < (2 * label_lengths[:, None] + 1)
    z_shift2 = torch.cat([torch.full_like(z[:, :2], blank_id), z[:, :-2]], dim=1)
    allow_skip = (z != blank_id) & (z != z_shift2) & (s_idx >= 2)
    return z, s_idx, valid_s, allow_skip


def _emissions(logits, z):
    """log P_t(z_s): (B, T, C) logits, (B, S) z -> (T, B, S) f32."""
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1).transpose(0, 1)
    t_max = logprobs.shape[0]
    return torch.gather(logprobs, 2, z[None].expand(t_max, -1, -1))


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-utterance CTC NLL.

    Args:
      logits: (B, T, C) unsoftmaxed.
      logit_lengths: (B,) valid frame counts.
      labels: (B, L) target ids, padded arbitrarily past their lengths.
      label_lengths: (B,) valid label counts.
    Returns:
      (B,) f32 losses, differentiable with respect to ``logits``.
    """
    dev = logits.device
    labels = labels.to(device=dev, dtype=torch.int64)
    label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    logit_lengths = logit_lengths.to(device=dev, dtype=torch.int64)
    t_max = logits.shape[1]
    z, s_idx, valid_s, allow_skip = _extended(labels, label_lengths, blank_id)
    emit = _emissions(logits, z).contiguous()
    has_label = label_lengths > 0
    init_mask = torch.full(z.shape, LOG_EPS, dtype=torch.float32, device=dev)
    init_mask[:, 0] = 0.0
    init_mask[:, 1] = torch.where(has_label, 0.0, LOG_EPS)
    frame_valid = (torch.arange(t_max, device=dev)[:, None]
                   < logit_lengths[None, :]).to(torch.float32)
    end = 2 * label_lengths
    end_mask = ((s_idx == end[:, None])
                | ((s_idx == (end - 1).clamp(min=0)[:, None]) & has_label[:, None]))
    f32 = torch.float32
    return CTCFromEmit.apply(emit, init_mask, allow_skip.to(f32).contiguous(),
                             valid_s.to(f32).contiguous(), frame_valid.contiguous(),
                             end_mask.to(f32).contiguous())


def ctc_loss_mean(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Batch-mean CTC loss with the reference's inf/NaN guard: non-finite,
    degenerate or infeasible utterances are dropped from the mean.
    Returns (mean, ok mask)."""
    per_utt = ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id)
    label_lengths = label_lengths.to(per_utt.device)
    logit_lengths = logit_lengths.to(per_utt.device)
    feasible = (label_lengths <= logit_lengths) & (label_lengths >= 0)
    ok = torch.isfinite(per_utt) & (per_utt < -LOG_EPS / 2) & feasible
    denom = ok.sum().clamp(min=1)
    return torch.where(ok, per_utt, 0.0).sum() / denom, ok


def ctc_loss_autograd(logits, logit_lengths, labels, label_lengths,
                      blank_id: int = 0):
    """The scan formulation as a plain loop; gradients by torch autograd
    (whose adjoint of the alpha recursion is the beta recursion)."""
    dev = logits.device
    labels = labels.to(device=dev, dtype=torch.int64)
    label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    logit_lengths = logit_lengths.to(device=dev, dtype=torch.int64)
    b, t_max, _ = logits.shape
    z, _, valid_s, allow_skip = _extended(labels, label_lengths, blank_id)
    emit = _emissions(logits, z)
    has_label = label_lengths > 0
    eps = torch.full_like(emit[0], LOG_EPS)
    alpha = eps.clone()
    alpha[:, 0] = emit[0, :, 0]
    alpha[:, 1] = torch.where(has_label, emit[0, :, 1], LOG_EPS)
    for t in range(1, t_max):
        a1 = torch.cat([eps[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.where(allow_skip, torch.cat([eps[:, :2], alpha[:, :-2]], dim=1), eps)
        new = _lse3(alpha, a1, a2) + emit[t]
        new = torch.clamp(torch.where(valid_s, new, eps), min=LOG_EPS)
        alpha = torch.where((t < logit_lengths)[:, None], new, alpha)
    end = 2 * label_lengths
    a_last = alpha.gather(1, end[:, None])[:, 0]
    a_prev = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(has_label, a_prev, LOG_EPS)
    total = torch.logaddexp(a_last, a_prev)
    return -torch.clamp(total, min=LOG_EPS)
