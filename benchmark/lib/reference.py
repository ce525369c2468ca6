"""The plain reference of the benchmark's model: Deep Speech 2 as
deepspeech.pytorch defines it (two conv + BatchNorm + HardTanh blocks,
bidirectional GRU or LSTM layers with the directions summed and a
BatchNorm before every layer but the first, a BatchNorm + Linear head),
its log-spectrogram frontend, the CTC loss and the training step
(mean over the usable utterances, clip to a global norm, Nesterov SGD).

Plain PyTorch in float32 with TF32 off, a time loop per layer, and
``F.ctc_loss``; it imports nothing of the program. BatchNorm takes its
batch statistics over the valid positions only (the program's masked
BatchNorm; padding frames and padding rows add nothing).

``quant="fp8"`` is the control: the model computed in float8 e4m3 (one
scale a tensor, its largest magnitude at 448), the precision below the
configuration's bfloat16, wherever the program keeps bfloat16. Every
matrix product and convolution takes float8 operands (in the backward
too: the gradient that reaches a product's output is rounded, and the
operands it saved are the rounded ones), sums in float32 as a float8
GEMM does, and every activation the program stores in its compute type
(each conv's and BatchNorm's output, the input projections, the
recurrent state at every step, the direction sum, the logits) is
rounded, its gradient with it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.lib.bounds import CONV_SPECS

F32 = torch.float32
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at one scale for the tensor; the
    gradient passes through unchanged."""
    return x + (_round_fp8(x.detach()) - x).detach()


class _GradFP8(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


class _StoreFP8(torch.autograd.Function):
    """An activation stored in float8: rounded, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def _identity(x):
    return x


def _product_fp8(y):
    """A product's output: its gradient is rounded before the backward's
    products take it."""
    return _GradFP8.apply(y)


# ------------------------------------------------------------ frontend

def features(pcm: list, n_fft: int = 320, hop: int = 160, device="cpu"):
    """int16 PCM arrays -> (B, T, n_fft // 2 + 1) normalised log1p STFT
    magnitudes (hamming window, centred frames with reflection at each
    utterance's ends, mean and standard deviation over each utterance's
    cells), zero past each utterance's frames, and the frame counts."""
    window = torch.hamming_window(n_fft, periodic=True, dtype=F32, device=device)
    feats = []
    for a in pcm:
        w = torch.as_tensor(a, device=device).to(F32) / 32768.0
        spec = torch.stft(w, n_fft, hop_length=hop, win_length=n_fft, window=window,
                          center=True, pad_mode="reflect", return_complex=True)
        f = torch.log1p(spec.abs()).t()  # (T, F)
        mean = f.mean()
        std = torch.sqrt(((f * f).mean() - mean * mean).clamp(min=1e-10))
        feats.append((f - mean) / std)
    lengths = torch.tensor([f.shape[0] for f in feats], device=device)
    out = torch.zeros(len(feats), int(lengths.max()), feats[0].shape[1], device=device)
    for j, f in enumerate(feats):
        out[j, :f.shape[0]] = f
    return out, lengths


# --------------------------------------------------------------- model

def _bn(x, mask, w: dict, prefix: str, train: bool, axes: tuple):
    """BatchNorm of the channels (the axis not in ``axes``) over the valid
    positions; ``mask`` (float) broadcasts to x. Training takes the
    batch's mean and biased variance there, evaluation the statistics."""
    shape = [1] * x.dim()
    ch = next(a for a in range(x.dim()) if a not in axes)
    shape[ch] = -1
    if train:
        count = (mask.expand_as(x).sum() / x.shape[ch]).clamp(min=1)
        mean = (x * mask).sum(axes, keepdim=True) / count
        var = (((x - mean) ** 2) * mask).sum(axes, keepdim=True) / count
    else:
        mean, var = w[prefix + "mean"].view(shape), w[prefix + "var"].view(shape)
    y = (x - mean) / torch.sqrt(var + 1e-5)
    return (y * w[prefix + "scale"].view(shape) + w[prefix + "bias"].view(shape)) * mask


def _time_mask(lengths, t_max):
    return torch.arange(t_max, device=lengths.device)[None, :] < lengths[:, None]


def _reverse_within(x, lengths):
    """Each row of (B, T, ...) reversed within its own length; padding
    stays in place."""
    t_max = x.shape[1]
    t = torch.arange(t_max, device=x.device)[None, :]
    idx = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    return x.gather(1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x))


def _recurrence(rnn_type: str, xg, w_h, b_h, mask, q=_identity, qg=_identity,
                keep=_identity):
    """xg (D, B, T, G*H), w_h (D, H, G*H), b_h (D, G*H), mask (B, T) ->
    ys (D, B, T, H); a padded step carries the state."""
    nd, b, t_max, gh = xg.shape
    h_dim = w_h.shape[1]
    h = xg.new_zeros(nd, b, h_dim)
    c = xg.new_zeros(nd, b, h_dim)
    w = q(w_h)
    ys = []
    for t in range(t_max):
        hg = qg(torch.bmm(q(h), w)) + b_h[:, None, :]
        x = xg[:, :, t]
        if rnn_type == "gru":
            xr, xz, xn = x.split(h_dim, -1)
            hr, hz, hn = hg.split(h_dim, -1)
            r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
        else:
            a = x + hg
            i, f, g, o = a.split(h_dim, -1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[None, :, t, None].to(F32)
        if rnn_type != "gru":
            c = m * c_new + (1 - m) * c
        h = keep(m * h_new + (1 - m) * h)
        ys.append(h)
    return torch.stack(ys, 2)


def forward(cfg: dict, w: dict, feats, lengths, train: bool = False, quant: str | None = None):
    """(B, T, F) features and frame counts -> (B, T', C) logits (zero past
    each row's frames) and the output frame counts."""
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
    mask = _time_mask(lengths, t_max)
    m3 = mask[:, :, None].to(F32)
    for i in range(cfg["hidden_layers"]):
        p = f"rnns.{i}."
        if i > 0:
            x = keep(_bn(x, m3, w, p + "bn.", train, (0, 1)))
        xs = torch.stack([x, _reverse_within(x, lengths)])  # (2, B, T, H_in)
        xg = qg(torch.einsum("dbti,dig->dbtg", q(xs), q(w[p + "bi.input_kernel"])))
        xg = keep(xg + w[p + "bi.input_bias"][:, None, None, :])
        ys = _recurrence(cfg["rnn_type"], xg, w[p + "bi.recurrent_kernel"],
                         w[p + "bi.recurrent_bias"], mask, q, qg, keep)
        x = keep(ys[0] + _reverse_within(ys[1], lengths)) * m3
    x = keep(_bn(x, m3, w, "head_bn.", train, (0, 1)))
    return keep(qg(q(x) @ q(w["head_kernel"]))) * m3, lengths


def ctc_losses(logits, out_lengths, labels: list):
    """Per-utterance CTC negative log-likelihoods (blank 0)."""
    lp = torch.log_softmax(logits, -1).transpose(0, 1)
    targets = torch.cat([torch.as_tensor(l, dtype=torch.int64) for l in labels]).to(lp.device)
    tl = torch.tensor([len(l) for l in labels], dtype=torch.int64, device=lp.device)
    return F.ctc_loss(lp, targets, out_lengths.to(torch.int64), tl, blank=0,
                      reduction="none", zero_infinity=False)


class TrainReference:
    """The reference training step from given weights: forward in train
    mode, the mean CTC loss over the usable rows (``rows``: a subset of
    the batch, all of it by default), the gradient clipped to
    ``max_norm`` (scaled by max_norm / norm only when norm >= max_norm),
    and SGD with Nesterov momentum from zero buffers. Keeps the first
    step's clipped gradient (the first momentum buffer)."""

    def __init__(self, cfg: dict, weights: dict, lr: float, momentum: float, max_norm: float,
                 quant: str | None = None):
        self.cfg, self.lr, self.mu, self.max_norm, self.quant = cfg, lr, momentum, max_norm, quant
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
                       if not k.endswith((".mean", ".var"))}
        self.stats = {k: v for k, v in weights.items() if k.endswith((".mean", ".var"))}
        self.buf: dict = {}
        self.first_grad: dict | None = None
        self.losses: list = []

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


def greedy_gap(ref_logits, frames: int, offsets: list, chars: list, blank: int = 0) -> float:
    """The widest gap, over a request's ``frames`` frames, by which the
    served best path's logit lies below the reference's best: at a frame
    where the served text emits a character (``offsets``), that
    character; elsewhere the better of blank and the last emitted
    character (the only classes a greedy path can hold there)."""
    lg = ref_logits[:frames].to(F32)
    best = lg.max(-1).values
    allowed = torch.full((frames,), blank, dtype=torch.int64)
    alt = torch.full((frames,), blank, dtype=torch.int64)
    emit = torch.zeros(frames, dtype=torch.bool)
    last = blank
    pos = 0
    for f in range(frames):
        if pos < len(offsets) and offsets[pos] == f:
            last = chars[pos]
            allowed[f] = alt[f] = last
            emit[f] = True
            pos += 1
        else:
            alt[f] = last
    if pos != len(offsets):
        return math.inf  # an offset outside the request's frames
    got = torch.maximum(lg.gather(1, allowed[:, None].to(lg.device))[:, 0],
                        lg.gather(1, alt[:, None].to(lg.device))[:, 0])
    return float((best - got).max()) if frames else 0.0
