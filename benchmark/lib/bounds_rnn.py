"""The vanilla RNN cell's yardstick arithmetic (``ds2_birnn1280``): the
model's FLOPs at one gate, and the least time of the fused tanh RNN loops
K6f and K6b at given shapes. Every count depends on shapes and lengths
only, never on what implements the work; the peaks and the conv stack
are ``bounds.py``'s."""

from __future__ import annotations

from benchmark.lib.bounds import (
    CONV_SPECS,
    H100_BF16_FLOPS,
    H100_BYTES_PER_S,
    conv_out_features,
)

GATES = {"rnn": 1, "gru": 3, "lstm": 4}


def forward_flops_per_frame(cfg: dict) -> float:
    """Model FLOPs of one output frame T' of the forward, as
    ``bounds.forward_flops_per_frame`` counts them (the two convs per
    output position, the recurrent layers' input projection and
    recurrence in both directions, the head), with the vanilla RNN's one
    gate."""
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
    return conv1 + conv2 + rnn + 2.0 * h * cfg["n_classes"]


def tanh_rnn_bound(t, b, h, nd, itemsize, backward=False):
    """The least time of a fused tanh RNN time loop at these shapes. The
    forward (K6f) takes one (B x H) @ (H x H) product a step and
    direction; the backward (K6b) the one product d(pre) @ w_h^T, no
    recompute credited. Bytes: the forward reads xg and writes ys; the
    backward reads ys and dy and writes d(pre); both read w_h, b_h (f32)
    and the mask (f32) once. Returns (milliseconds, "operations" |
    "bytes")."""
    flops = 2.0 * nd * t * b * h * h
    per_step = (3 if backward else 2) * t * nd * b * h * itemsize
    nbytes = per_step + nd * h * h * itemsize + nd * h * 4 + t * nd * b * 4
    by_ops, by_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def tanh_bound_ms(work: dict, backward: bool) -> float:
    """Sum of ``tanh_rnn_bound`` over the window's layer calls, at each
    step's bucket shape (T' padded, B), bf16."""
    cfg = work["cfg"]
    h, n = cfg["hidden_size"], cfg["hidden_layers"]
    nd = 2 if cfg.get("bidirectional", True) else 1
    return n * sum(tanh_rnn_bound(s["t_pad"], s["b"], h, nd, 2, backward)[0]
                   for s in work["steps"])


def mfu_percent(work: dict, passes: float = 3.0):
    """100 x model FLOPs of the window's real frames (``passes`` forwards
    each: 3 for a training step) over the window at the bf16 peak."""
    t = work.get("trace") or {}
    frames = sum(s["frames"] for s in work.get("steps", ()))
    if not t.get("window_s") or not frames:
        return None
    flops = passes * forward_flops_per_frame(work["cfg"]) * frames
    return 100.0 * flops / (t["window_s"] * H100_BF16_FLOPS)
