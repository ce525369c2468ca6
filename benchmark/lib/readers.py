"""Arithmetic the per-layer readers share. A reader (``metrics/<name>.py``)
returns None where its window holds nothing to read, and the harness
then leaves the metric out of the result."""

from __future__ import annotations

from benchmark.lib import bounds
from benchmark.lib.trace import seconds_named


def idle_percent(work: dict):
    """100 x the share of the traced window in which the device ran
    nothing."""
    t = work.get("trace") or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_percent(work: dict, passes: float, per: str = "window_s"):
    """100 x model FLOPs of the real frames the window worked on
    (``passes`` forwards each: 3 for a training step) over ``per``
    seconds (the window, or the device's busy time) at the bf16 peak."""
    t = work.get("trace") or {}
    frames = frames_of(work)
    if not t.get(per) or not frames:
        return None
    flops = passes * bounds.forward_flops_per_frame(work["cfg"]) * frames
    return 100.0 * flops / (t[per] * bounds.H100_BF16_FLOPS)


def frames_of(work: dict) -> int:
    """Real output frames (T') of the work in the window."""
    if "steps" in work:
        return sum(s["frames"] for s in work["steps"])
    return sum(work.get("request_frames", ()))


def rnn_bound_ms(work: dict, backward: bool) -> float:
    """Sum of ``bounds.rnn_bound`` over the window's layer calls: at each
    step's bucket shape (T' padded, B), or, for requests whose batches
    the harness does not form, as one call over all their real frames."""
    cfg = work["cfg"]
    h, g, n = cfg["hidden_size"], bounds.GATES[cfg["rnn_type"]], cfg["hidden_layers"]
    if "steps" in work:
        calls = [(s["t_pad"], s["b"]) for s in work["steps"]]
    else:
        calls = [(frames_of(work), 1)]
    return n * sum(bounds.rnn_bound(t, b, h, 2, 2, g, backward=backward)[0] for t, b in calls)


def roofline_percent(work: dict, bound_ms: float, fragments) -> float | None:
    """100 x the bound over the device time of the kernels whose names
    hold any of ``fragments``."""
    t = work.get("trace") or {}
    spent = seconds_named(t.get("by_name", {}), fragments)
    if not spent or not bound_ms:
        return None
    return 100.0 * bound_ms / (1e3 * spent)
