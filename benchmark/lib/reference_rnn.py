"""The plain reference of the vanilla RNN cell (``ds2_birnn1280``):
``lib/reference.py``'s Deep Speech 2 with the recurrent layers of the
reference repository's ``--rnn-type rnn``, ``nn.RNN`` with tanh,
bidirectional and the directions summed:

    h_t = m_t tanh(x_t W + b_i + h_{t-1} U + b_h) + (1 - m_t) h_{t-1}

Plain PyTorch in float32 with TF32 off, a time loop per layer; it
imports nothing of the program. The frontend, the masked BatchNorm,
the CTC loss, the float8 rounding of the control and ``no_tf32`` are
``reference.py``'s, imported by name; ``recurrence`` adds the tanh cell
(the GRU and the LSTM stay ``reference.py``'s), and ``forward`` and
``TrainReference.step`` are ``reference.py``'s with this file's
recurrence in the layers. ``quant="fp8"`` is the same control, and
``TrainReference.step(..., rows=...)`` the same half-batch fault.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.lib import reference
from benchmark.lib.bounds import CONV_SPECS
from benchmark.lib.reference import (  # noqa: F401 (no_tf32, features: the entry's)
    F32,
    _bn,
    _identity,
    _product_fp8,
    _reverse_within,
    _StoreFP8,
    _time_mask,
    ctc_losses,
    features,
    fp8,
    no_tf32,
)


def recurrence(rnn_type: str, xg, w_h, b_h, mask, q=_identity, qg=_identity, keep=_identity):
    """xg (D, B, T, G*H), w_h (D, H, G*H), b_h (D, G*H), mask (B, T) ->
    ys (D, B, T, H); a padded step carries the state. ``rnn``: the tanh
    cell; ``gru`` and ``lstm``: ``reference.py``'s."""
    if rnn_type != "rnn":
        return reference._recurrence(rnn_type, xg, w_h, b_h, mask, q, qg, keep)
    nd, b, t_max, h_dim = xg.shape
    h = xg.new_zeros(nd, b, h_dim)
    w = q(w_h)
    ys = []
    for t in range(t_max):
        hg = qg(torch.bmm(q(h), w)) + b_h[:, None, :]
        h_new = torch.tanh(xg[:, :, t] + hg)
        m = mask[None, :, t, None].to(F32)
        h = keep(m * h_new + (1 - m) * h)
        ys.append(h)
    return torch.stack(ys, 2)


def bidirectional_layer(rnn_type: str, x, lengths, w: dict, prefix: str, q=_identity,
                        qg=_identity, keep=_identity):
    """One bidirectional layer, (B, T, H_in) -> (B, T, H): the input
    projection of each direction (direction 1 reads each row reversed
    within its length), the recurrence, and the directions' sum, zero
    past each row's frames."""
    mask = _time_mask(lengths, x.shape[1])
    xs = torch.stack([x, _reverse_within(x, lengths)])  # (2, B, T, H_in)
    xg = qg(torch.einsum("dbti,dig->dbtg", q(xs), q(w[prefix + "input_kernel"])))
    xg = keep(xg + w[prefix + "input_bias"][:, None, None, :])
    ys = recurrence(rnn_type, xg, w[prefix + "recurrent_kernel"], w[prefix + "recurrent_bias"],
                    mask, q, qg, keep)
    return keep(ys[0] + _reverse_within(ys[1], lengths)) * mask[:, :, None].to(F32)


def forward(cfg: dict, w: dict, feats, lengths, train: bool = False, quant: str | None = None):
    """(B, T, F) features and frame counts -> (B, T', C) logits (zero past
    each row's frames) and the output frame counts (``reference.forward``
    with ``bidirectional_layer``)."""
    q, qg, keep = ((fp8, _product_fp8, _StoreFP8.apply) if quant == "fp8"
                   else (_identity, _identity, _identity))
    x = feats[:, None]  # (B, 1, T, F)
    lengths = lengths.to(torch.int64)
    for i, (kt, kf, st, sf, pt, pf) in enumerate(CONV_SPECS):
        x = qg(F.conv2d(q(x), q(w[f"convs.{i}.weight"]), stride=(st, sf), padding=(pt, pf)))
        lengths = (lengths + 2 * pt - kt) // st + 1
        mask = _time_mask(lengths, x.shape[2])[:, None, :, None].to(F32)
        x = keep(_bn(keep(x), mask, w, f"convs.{i}.bn.", train, (0, 2, 3)))
        x = x.clamp(0.0, 20.0) * mask
    b, c, t_max, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, t_max, f * c)
    m3 = _time_mask(lengths, t_max)[:, :, None].to(F32)
    for i in range(cfg["hidden_layers"]):
        p = f"rnns.{i}."
        if i > 0:
            x = keep(_bn(x, m3, w, p + "bn.", train, (0, 1)))
        x = bidirectional_layer(cfg["rnn_type"], x, lengths, w, p + "bi.", q, qg, keep)
    x = keep(_bn(x, m3, w, "head_bn.", train, (0, 1)))
    return keep(qg(q(x) @ q(w["head_kernel"]))) * m3, lengths


class TrainReference(reference.TrainReference):
    """``reference.TrainReference`` on this file's ``forward``: the same
    step (mean CTC loss over the usable rows, ``rows`` a subset of the
    batch for the half-batch fault, the clip to ``max_norm``, Nesterov
    SGD from zero buffers, the first clipped gradient kept)."""

    def step(self, pcm: list, labels: list, rows=None) -> None:
        rows = list(range(len(pcm))) if rows is None else rows
        dev = next(iter(self.params.values())).device
        feats, lengths = features([pcm[j] for j in rows], device=dev)
        logits, out_len = forward(self.cfg, {**self.params, **self.stats}, feats, lengths,
                                  train=True, quant=self.quant)
        per = ctc_losses(logits, out_len, [labels[j] for j in rows])
        ok = torch.isfinite(per) & (torch.tensor([len(labels[j]) for j in rows],
                                                 device=dev) <= out_len)
        loss = torch.where(ok, per, 0.0).sum() / ok.sum().clamp(min=1)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = self.max_norm / norm if float(norm) >= self.max_norm else 1.0
        with torch.no_grad():
            grads = [g * scale for g in grads]
            if self.first_grad is None:
                self.first_grad = {n: g.clone() for n, g in zip(names, grads)}
            for n, g in zip(names, grads):
                self.buf[n] = g.clone() if n not in self.buf else self.mu * self.buf[n] + g
                self.params[n] -= self.lr * (g + self.mu * self.buf[n])
        self.losses.append(float(loss.detach()))
