"""Reading a torch.profiler Chrome trace: the device's busy time, idle
share, kernel time by name, and the host's activity in the device's
idle gaps.

The harness synchronises the card before it opens its traced window and
again before it closes it, and marks the window with a host span named
``WINDOW_SPAN``, so the device's busy time over that exact span gives
the exact idle share (``window_summary``).
"""

from __future__ import annotations

import json
from pathlib import Path

WINDOW_SPAN = "benchmark_window"
NO_HOST_OP = "host_python"  # no traced host operation covers the gap
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

def load_events(path) -> list:
    """The complete ("X") events of a Chrome trace file."""
    return [e for e in json.loads(Path(path).read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def window_summary(events: list, top: int = 10) -> dict:
    """The device's work inside the host span ``WINDOW_SPAN``: seconds
    of the window, busy seconds (the union of kernel, copy and set
    intervals, clipped to the window), device seconds by event name,
    the ``top`` device operations by time, and the ``top`` idle time by
    what the host was doing in each gap (the innermost host operation
    that covers the gap's middle, else ``NO_HOST_OP``: the host ran
    Python between operations). Times in seconds. Raises when the
    trace holds no window span."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") != "kernel"]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    dev = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e.get("name", ""))
                 for e in events if e.get("cat") in DEVICE_CATS
                 and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    busy, end, gaps = 0.0, w0, []
    by_name: dict = {}
    for s, e, n in dev:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    if w1 > end:
        gaps.append((end, w1))
    host = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                      "cuda_driver", "python_function")
                  and e.get("name") != WINDOW_SPAN)
    idle_by: dict = {}
    active, nxt = [], 0  # host events that began before the gap's middle
    for g0, g1 in gaps:  # in time order
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else NO_HOST_OP
        idle_by[name[:80]] = idle_by.get(name[:80], 0.0) + (g1 - g0) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "by_name": by_name,
            "device_ops": sorted(([n[:80], s] for n, s in by_name.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([n, s] for n, s in idle_by.items()),
                                key=lambda kv: -kv[1])[:top]}


def seconds_named(by_name: dict, fragments) -> float:
    """Device seconds of the events whose names hold any of ``fragments``."""
    return sum(s for n, s in by_name.items() if any(f in n for f in fragments))
