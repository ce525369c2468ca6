"""Deep Speech 2 acoustic model (port of ``tpuasr/model/ds2.py``).

Two masked conv + BatchNorm + HardTanh blocks, recurrent layers (GRU,
LSTM or the vanilla tanh RNN; bidirectional with the directions summed,
or unidirectional) with a BatchNorm before every layer but the first,
for a unidirectional model a Lookahead layer (a depthwise conv over the
next ``lookahead_context`` frames), then a BatchNorm + Linear head.
``forward(..., train)`` selects BatchNorm's mode: batch statistics over
valid positions (and an update of the running statistics) in training,
running statistics in evaluation. Numerics follow the JAX package's
``rnn_impl="pallas"`` path: activations in ``compute_dtype`` with f32
parameters and f32 BatchNorm math, and the time loop in a fused kernel,
through its autograd function whenever grad is enabled.

Which kernel runs the time loop:

  =====================  ==========================================
  rnn_type + rnn_impl    kernel (``tpuasr_torch.ops``)
  =====================  ==========================================
  gru + scan | pallas    K1, ``gru.bigru_forward`` / ``BiGRUFunction``
  gru + pallas2          K5, ``gru2.bigru2_forward`` / ``BiGRU2Function``
                         (gate-major projections and weights)
  lstm + any impl        K4, ``lstm.bilstm_forward`` / ``BiLSTMFunction``
  gru, unidirectional    K1 with one direction (D=1), any impl
  lstm, unidirectional   K4 with one direction (D=1)
  rnn (vanilla)          no kernel: a plain time loop in the compute
                         dtype (the JAX package runs ``lax.scan``
                         under every impl; no Pallas kernel exists)
  =====================  ==========================================

``lstm`` runs K4 under every impl and ``gru`` + ``scan`` runs K1: the
port follows the ``pallas`` numerics for every impl (the JAX package
runs ``scan``, and ``lstm`` + ``pallas2``, through ``lax.scan``). A
unidirectional GRU runs K1 at D=1 under ``pallas2`` too: JAX's
``RecurrentCore`` knows only ``pallas``, and K5 is bidirectional only.

Layout notes. Activations keep the JAX package's (B, T, F, C) order at
module boundaries: the convs run in PyTorch's (B, C, T, F) and are
permuted back before the feature-major ``f * C + c`` flatten, so
weights carry over unchanged. Parameters keep the flax names and
layouts (``compat.weights`` maps a flax tree onto them), except the
conv kernels, which are stored as PyTorch's (out, in, kT, kF) (the
Lookahead's keeps flax's (ctx, 1, H)); the pallas2 path relays the
(2, H, 3H) recurrent kernel out gate-major at each call, so its
gradient flows back to the same parameter.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tpuasr_torch.ops.gru import BiGRUFunction, bigru_forward
from tpuasr_torch.ops.gru2 import BiGRU2Function, bigru2_forward
from tpuasr_torch.ops.lstm import BiLSTMFunction, bilstm_forward

# (kernel_t, kernel_f, stride_t, stride_f, pad_t, pad_f) per conv layer.
CONV_SPECS = (
    (11, 41, 2, 2, 5, 20),
    (11, 21, 1, 2, 5, 10),
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GATES = {"gru": 3, "lstm": 4, "rnn": 1}  # gate blocks of H per recurrent weight
RNN_IMPLS = ("scan", "pallas", "pallas2")
BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


@dataclass(frozen=True)
class ModelConfig:
    """Same fields and ``to_dict`` keys as ``tpuasr.model.ds2.ModelConfig``;
    dtypes are held by name ("bfloat16", "float32")."""

    n_classes: int = 44
    n_features: int = 161
    conv_channels: int = 32
    hidden_size: int = 800
    hidden_layers: int = 5
    rnn_type: str = "gru"
    bidirectional: bool = True
    lookahead_context: int = 20
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    rnn_unroll: int = 1
    # scan | pallas: K1 for a GRU; pallas2: K5 (gate-major); K4 for an
    # LSTM under every impl (the module docstring's table)
    rnn_impl: str = "scan"
    bn_mask_mode: str = "masked"

    def to_dict(self) -> dict:
        return {
            "n_classes": self.n_classes,
            "n_features": self.n_features,
            "conv_channels": self.conv_channels,
            "hidden_size": self.hidden_size,
            "hidden_layers": self.hidden_layers,
            "rnn_type": self.rnn_type,
            "bidirectional": self.bidirectional,
            "lookahead_context": self.lookahead_context,
            "compute_dtype": self.compute_dtype,
            "param_dtype": self.param_dtype,
            "rnn_unroll": self.rnn_unroll,
            "rnn_impl": self.rnn_impl,
            "bn_mask_mode": self.bn_mask_mode,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


def conv_out_lengths(lengths):
    """Length propagation through the conv stack along time (ints or
    integer tensors; floor division as in the JAX package)."""
    out = lengths
    for (kt, _, st, _, pt, _) in CONV_SPECS:
        out = (out + 2 * pt - kt) // st + 1
    return out


def conv_out_features(n_features: int, conv_channels: int) -> int:
    f = n_features
    for (_, kf, _, sf, _, pf) in CONV_SPECS:
        f = (f + 2 * pf - kf) // sf + 1
    return f * conv_channels


def _time_mask(lengths: torch.Tensor, t_max: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask."""
    return torch.arange(t_max, device=lengths.device)[None, :] < lengths[:, None]


def _check_config(cfg: ModelConfig) -> None:
    if cfg.rnn_type not in GATES:
        raise ValueError(f"unknown rnn_type {cfg.rnn_type!r}")
    if cfg.rnn_impl not in RNN_IMPLS:
        raise ValueError(f"unknown rnn_impl {cfg.rnn_impl!r}")
    if cfg.bn_mask_mode not in ("masked", "reference"):
        raise ValueError(f"unknown bn_mask_mode {cfg.bn_mask_mode!r}")


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid positions of (B, T, ..., C), f32 math, output
    masked and cast back to the input dtype.

    Training: the mean and the biased variance over the valid positions
    (denominator max(count, 1); a padding row of length 0 adds nothing),
    and the running statistics move by momentum 0.1 (torch convention)
    with the unbiased variance. Evaluation: the running statistics."""

    def __init__(self, c: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        m = mask.to(torch.float32).reshape(
            mask.shape + (1,) * (x.dim() - mask.dim()))
        xf = x.to(torch.float32)
        if train:
            denom = m.expand(x.shape[:-1] + (1,)).sum().clamp(min=1.0)
            axes = tuple(range(x.dim() - 1))
            mean = (xf * m).sum(dim=axes) / denom
            var = ((xf - mean) ** 2 * m).sum(dim=axes) / denom
            with torch.no_grad():
                unbiased = var * (denom / (denom - 1.0).clamp(min=1.0))
                mo = BN_MOMENTUM
                self.mean.copy_((1 - mo) * self.mean + mo * mean)
                self.var.copy_((1 - mo) * self.var + mo * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return (y * m).to(x.dtype)


class MaskedConvBlock(nn.Module):
    """Conv -> masked BN -> HardTanh(0, 20) -> zero padded positions, on
    (B, T, F, C) activations."""

    def __init__(self, spec: tuple, in_channels: int, channels: int):
        super().__init__()
        self.spec = spec
        kt, kf = spec[0], spec[1]
        self.weight = nn.Parameter(torch.zeros(channels, in_channels, kt, kf))
        self.bn = MaskedBatchNorm(channels)

    def forward(self, x, lengths, mask_lengths=None, train: bool = False):
        """``mask_lengths`` overrides the lengths used for masking only
        (bn_mask_mode="reference"); ``lengths`` drives the returned
        length propagation."""
        kt, _, st, sf, pt, pf = self.spec
        x = x.permute(0, 3, 1, 2)
        if x.device.type == "cpu":
            # on the CPU, the weight gradient of a channels-last input (the
            # permuted view) takes ~150x as long as a contiguous one's
            # (32 channels, B=2, T=600: 221 s against 1.4 s on one thread)
            x = x.contiguous()
        y = F.conv2d(x, self.weight.to(x.dtype), stride=(st, sf), padding=(pt, pf))
        x = y.permute(0, 2, 3, 1)  # back to (B, T, F, C)
        out_lengths = (lengths + 2 * pt - kt) // st + 1
        ml = out_lengths if mask_lengths is None else (
            (mask_lengths + 2 * pt - kt) // st + 1)
        mask = _time_mask(ml, x.shape[1])
        x = self.bn(x, mask, train).clamp(0.0, 20.0)  # HardTanh(0, 20)
        return x * mask[:, :, None, None].to(x.dtype), out_lengths


def tanh_rnn(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """The vanilla RNN's time loop, ``h = m * tanh(xg + h @ w_h + b_h) +
    (1 - m) * h`` (``tpuasr/model/ds2.py:318-330, 523``), in xg's dtype
    with plain ops, so autograd runs through it. xg (T, D, B, H), w_h
    (D, H, H) and b_h (D, H) in the compute dtype, mask (T, D, B) ->
    ys (T, D, B, H). No Pallas kernel exists for it in the JAX package
    (``lax.scan`` under every impl), so the port has none either."""
    dt = xg.dtype
    h = xg.new_zeros(xg.shape[1:3] + (w_h.shape[1],))
    ys = []
    for t in range(xg.shape[0]):
        h_new = torch.tanh(xg[t] + torch.bmm(h, w_h) + b_h[:, None, :])
        m = mask[t].to(dt)[:, :, None]
        h = m * h_new + (1 - m) * h
        ys.append(h)
    return torch.stack(ys)


def _loop(rnn_type: str, xg, w_h, b_h, mask):
    """One fused time loop over D directions: K1 (GRU) or K4 (LSTM)
    through their autograd functions when grad is enabled, else the
    forward wrappers; the vanilla RNN's plain loop. xg (T, D, B, G*H)
    and w_h (D, H, G*H) in the compute dtype, b_h (D, G*H) (used in f32
    by the kernels, in the compute dtype by the vanilla loop), mask
    (T, D, B) f32 -> ys (T, D, B, H)."""
    grad = torch.is_grad_enabled()
    if rnn_type == "rnn":
        return tanh_rnn(xg, w_h, b_h.to(xg.dtype), mask)
    b_h = b_h.to(torch.float32).contiguous()
    if rnn_type == "lstm":  # K4
        return BiLSTMFunction.apply(xg, w_h, b_h, mask) if grad else \
            bilstm_forward(xg, w_h, b_h, mask)[0]
    return (BiGRUFunction.apply if grad else bigru_forward)(xg, w_h, b_h, mask)  # K1


class BiRecurrentCore(nn.Module):
    """Both directions in one fused time loop (the kernel of the module
    docstring's table: the wrapper, or its autograd function when grad
    is enabled); direction 1 consumes the time-flipped input."""

    def __init__(self, h_in: int, hidden: int, compute_dtype: torch.dtype,
                 rnn_type: str = "gru", rnn_impl: str = "scan"):
        super().__init__()
        g = GATES[rnn_type] * hidden
        self.dtype = compute_dtype
        self.hidden = hidden
        self.rnn_type = rnn_type
        self.gate_major = rnn_type == "gru" and rnn_impl == "pallas2"
        self.input_kernel = nn.Parameter(torch.zeros(2, h_in, g))
        self.input_bias = nn.Parameter(torch.zeros(2, g))
        self.recurrent_kernel = nn.Parameter(torch.zeros(2, hidden, g))
        self.recurrent_bias = nn.Parameter(torch.zeros(2, g))

    def forward(self, x, x_flip, mask_fwd, mask_bwd):
        dt, h = self.dtype, self.hidden
        xs = torch.stack([x, x_flip], dim=0).to(dt)  # (2, B, T, H_in)
        mask = torch.stack([mask_fwd, mask_bwd], dim=0)  # (2, B, T)
        mask_t = mask.permute(2, 0, 1).to(torch.float32).contiguous()
        if self.gate_major:  # K5: tpuasr/model/ds2.py:436-445
            w_x = self.input_kernel.to(dt).reshape(2, -1, 3, h)
            xg = (torch.einsum("dbti,digh->tdgbh", xs, w_x)
                  + self.input_bias.to(dt).reshape(2, 3, h)[None, :, :, None, :])
            w_h = self.recurrent_kernel.reshape(2, h, 3, h).permute(0, 2, 1, 3)
            ys = (BiGRU2Function.apply if torch.is_grad_enabled() else bigru2_forward)(
                xg.contiguous(), w_h.to(dt).contiguous(),
                self.recurrent_bias.reshape(2, 3, h).to(torch.float32).contiguous(),
                mask_t)  # (T, 2, B, H)
        else:
            xg = (torch.einsum("dbti,dig->tdbg", xs, self.input_kernel.to(dt))
                  + self.input_bias.to(dt)[None, :, None, :])  # (T, 2, B, G*H)
            ys = _loop(self.rnn_type, xg.contiguous(),
                       self.recurrent_kernel.to(dt).contiguous(), self.recurrent_bias, mask_t)
        ys = ys.permute(1, 2, 0, 3)  # (2, B, T, H)
        return ys[0], ys[1]


class Dense(nn.Module):
    """flax ``nn.Dense``'s parameters, ``kernel`` (in, out) and ``bias``
    (out,), applied in the compute dtype."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class RecurrentCore(nn.Module):
    """One direction (``tpuasr/model/ds2.py:238 RecurrentCore``): the
    input projection as one matmul, then the time loop with a singleton
    direction axis (xg (T, 1, B, G*H), w_h (1, H, G*H), mask (T, 1, B)),
    as the JAX package calls its fused kernels (``:281-295``): K1 for a
    GRU, K4 for an LSTM, the plain loop for the vanilla RNN."""

    def __init__(self, h_in: int, hidden: int, compute_dtype: torch.dtype,
                 rnn_type: str = "gru"):
        super().__init__()
        g = GATES[rnn_type] * hidden
        self.dtype = compute_dtype
        self.rnn_type = rnn_type
        self.input_proj = Dense(h_in, g)
        self.recurrent_kernel = nn.Parameter(torch.zeros(hidden, g))
        self.recurrent_bias = nn.Parameter(torch.zeros(g))

    def forward(self, x, mask):
        dt = self.dtype
        xg = self.input_proj(x, dt)  # (B, T, G*H)
        ys = _loop(self.rnn_type, xg.transpose(0, 1)[:, None].contiguous(),
                   self.recurrent_kernel.to(dt)[None].contiguous(), self.recurrent_bias[None],
                   mask.t().to(torch.float32)[:, None].contiguous())  # (T, 1, B, H)
        ys = ys[:, 0].transpose(0, 1)  # (B, T, H)
        return ys * mask[:, :, None].to(ys.dtype)


class BatchRNN(nn.Module):
    """BN (all but the first layer) -> the recurrent core: bidirectional
    (``bi``, directions summed) or unidirectional (``fwd``)."""

    def __init__(self, h_in: int, hidden: int, batch_norm: bool,
                 compute_dtype: torch.dtype, rnn_type: str = "gru",
                 rnn_impl: str = "scan", bidirectional: bool = True):
        super().__init__()
        self.bn = MaskedBatchNorm(h_in) if batch_norm else None
        self.bidirectional = bidirectional
        if bidirectional:
            self.bi = BiRecurrentCore(h_in, hidden, compute_dtype, rnn_type, rnn_impl)
        else:
            self.fwd = RecurrentCore(h_in, hidden, compute_dtype, rnn_type)

    def forward(self, x, lengths, train: bool = False):
        mask = _time_mask(lengths, x.shape[1])
        if self.bn is not None:
            x = self.bn(x, mask, train)
        if not self.bidirectional:
            return self.fwd(x, mask)
        t_max = x.shape[1]
        mask_bwd = (torch.arange(t_max, device=x.device)[None, :]
                    >= (t_max - lengths)[:, None])
        fwd, bwd_flip = self.bi(x, x.flip(1), mask, mask_bwd)
        out = fwd + bwd_flip.flip(1)  # direction sum, reference behavior
        return out * mask[:, :, None].to(out.dtype)


class Lookahead(nn.Module):
    """Per-feature convolution over the next ``context`` frames, no bias,
    then HardTanh(0, 20) (``tpuasr/model/ds2.py:574 Lookahead``). The
    kernel keeps flax's (ctx, 1, H) layout; it runs as a depthwise
    ``conv1d`` with right padding ctx - 1 (an XLA conv in the JAX
    package, not a Pallas kernel)."""

    def __init__(self, context: int, hidden: int, compute_dtype: torch.dtype):
        super().__init__()
        self.context = context
        self.dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(context, 1, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.kernel.to(dt).permute(2, 1, 0)  # (H, 1, ctx)
        y = F.conv1d(F.pad(x.to(dt).transpose(1, 2), (0, self.context - 1)), w,
                     groups=w.shape[0])
        return y.transpose(1, 2).clamp(0.0, 20.0)


class DeepSpeech2(nn.Module):
    """(B, T, F) log-spectrograms + frame lengths -> (B, T', n_classes)
    f32 logits + output lengths; ``train`` selects BatchNorm's mode."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        _check_config(config)
        self.config = cfg = config
        dt = cfg.torch_compute_dtype
        chans = [1] + [cfg.conv_channels] * len(CONV_SPECS)
        self.convs = nn.ModuleList(
            MaskedConvBlock(spec, chans[i], chans[i + 1])
            for i, spec in enumerate(CONV_SPECS))
        h_in = conv_out_features(cfg.n_features, cfg.conv_channels)
        self.rnns = nn.ModuleList(
            BatchRNN(h_in if i == 0 else cfg.hidden_size, cfg.hidden_size,
                     batch_norm=i > 0, compute_dtype=dt,
                     rnn_type=cfg.rnn_type, rnn_impl=cfg.rnn_impl,
                     bidirectional=cfg.bidirectional)
            for i in range(cfg.hidden_layers))
        self.lookahead = (Lookahead(cfg.lookahead_context, cfg.hidden_size, dt)
                          if not cfg.bidirectional and cfg.lookahead_context > 0 else None)
        self.head_bn = MaskedBatchNorm(cfg.hidden_size)
        self.head_kernel = nn.Parameter(torch.zeros(cfg.hidden_size, cfg.n_classes))

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                train: bool = False):
        cfg = self.config
        dt = cfg.torch_compute_dtype
        lengths = lengths.to(device=feats.device, dtype=torch.int64)
        x = feats.to(dt)[:, :, :, None]  # (B, T, F, 1)
        # bn_mask_mode="reference": masking sees the full padded axis
        # (slots of length 0 stay excluded); true lengths are returned
        ml = None
        if cfg.bn_mask_mode == "reference":
            ml = torch.where(lengths > 0, feats.shape[1], 0)
        out_lengths = lengths
        for conv in self.convs:
            kt, _, st, _, pt, _ = conv.spec
            x, out_lengths = conv(x, out_lengths, mask_lengths=ml, train=train)
            if ml is not None:
                ml = (ml + 2 * pt - kt) // st + 1
        b, t, f, c = x.shape
        x = x.reshape(b, t, f * c)
        rnn_lengths = out_lengths if ml is None else ml
        for rnn in self.rnns:
            x = rnn(x, rnn_lengths, train)
        if self.lookahead is not None:  # tpuasr/model/ds2.py:645-651
            x = self.lookahead(x)
        mask = _time_mask(rnn_lengths, x.shape[1])
        x = self.head_bn(x, mask, train)
        logits = torch.matmul(x, self.head_kernel.to(dt)).to(torch.float32)
        return logits * mask[:, :, None], out_lengths
