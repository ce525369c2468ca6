"""The yardstick's arithmetic: published peaks, model FLOPs, and the least
time of the RNN kernels at given shapes.

``rnn_bound`` is a frozen copy of the repository's ``chip_smoke.py``
function of the same name. Every count depends on shapes and lengths
only, never on what implements the work.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores

# (kernel_t, kernel_f, stride_t, stride_f, pad_t, pad_f), the reference's two convs
CONV_SPECS = ((11, 41, 2, 2, 5, 20), (11, 21, 1, 2, 5, 10))
GATES = {"gru": 3, "lstm": 4}


def frames_of_samples(n_samples, hop: int = 160):
    """Spectrogram frames of ``n_samples`` (center=True framing)."""
    return 1 + np.asarray(n_samples) // hop


def conv_out_frames(frames):
    """Frames after the conv stack (T'), elementwise."""
    out = np.asarray(frames)
    for kt, _, st, _, pt, _ in CONV_SPECS:
        out = (out + 2 * pt - kt) // st + 1
    return out


def conv_out_features(n_features: int, channels: int) -> int:
    f = n_features
    for _, kf, _, sf, _, pf in CONV_SPECS:
        f = (f + 2 * pf - kf) // sf + 1
    return f * channels


def forward_flops_per_frame(cfg: dict) -> float:
    """Model FLOPs of one output frame T' of the forward: the two convs
    (per output position of each), the recurrent layers (input
    projection and recurrence, both directions) and the head."""
    c, h = cfg["conv_channels"], cfg["hidden_size"]
    g = GATES[cfg["rnn_type"]]
    f1 = (cfg["n_features"] + 2 * CONV_SPECS[0][5] - CONV_SPECS[0][1]) // CONV_SPECS[0][3] + 1
    f2 = (f1 + 2 * CONV_SPECS[1][5] - CONV_SPECS[1][1]) // CONV_SPECS[1][3] + 1
    conv1 = 2.0 * CONV_SPECS[0][1] * CONV_SPECS[0][0] * 1 * c * f1
    conv2 = 2.0 * CONV_SPECS[1][1] * CONV_SPECS[1][0] * c * c * f2
    h_in = conv_out_features(cfg["n_features"], c)
    rnn = 0.0
    for i in range(cfg["hidden_layers"]):
        n_in = h_in if i == 0 else h
        rnn += 2 * 2.0 * n_in * g * h + 2 * 2.0 * h * g * h
    head = 2.0 * h * cfg["n_classes"]
    return conv1 + conv2 + rnn + head


def rnn_bound(t, b, h, nd, itemsize, n_gates=3, backward=False):
    """The least time of a fused RNN time loop at these shapes: K1f/K5f
    (GRU, n_gates 3) and K4f (LSTM, 4) do h @ w_h every step; K1b/K5b
    and K4b recompute it and then take dhg @ w_h^T (twice the
    operations). Bytes: xg, the per-step state inputs of the backward
    (GRU h_prev, dy; LSTM h_prev, c_prev, cs, dy), the outputs (ys; the
    LSTM's ys and cs; the backward's 4H gate gradients), w_h, b_h, mask.
    Returns (milliseconds, "operations" | "bytes")."""
    g = n_gates
    flops = (2 if backward else 1) * 2.0 * nd * t * b * h * g * h
    states = (4 if g == 4 else 2) if backward else 0
    outs = 4 * h if backward else (2 * h if g == 4 else h)
    nbytes = (t * nd * b * (g * h + states * h + outs) * itemsize
              + nd * h * g * h * itemsize + nd * g * h * 4 + t * nd * b * 4)
    by_ops, by_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"
