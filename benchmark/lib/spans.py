"""Arithmetic of the per-layer readers that read the program's own spans
and counters (``tpuasr_torch.profiling``).

The program records while a ``torch.profiler`` profile runs, and in a
traced run the harness runs one exactly over its window, so what
``recorded()`` holds once the entry has returned is the window's: its
spans (``Span``: id, name, start_ns, end_ns, parent id), its counters
and its samples (values). Every function returns
None where there is nothing to read: another entry's work, a program
without a recorder (``tpuasr_torch.profiling`` does not import), or a
recorder that holds nothing.
"""

from __future__ import annotations

from benchmark.lib.harness import percentile


def recorded_of(work: dict, entry: str):
    """The program's snapshot for ``entry``'s work, or None."""
    if work.get("entry") != entry:
        return None
    try:
        from tpuasr_torch import profiling
    except ImportError:
        return None
    rec = profiling.recorded()
    if not (rec["spans"] or rec["counters"] or rec["samples"]):
        return None
    return rec


def named(rec: dict, name: str) -> list:
    return [s for s in rec["spans"] if s.name == name]


def queue_wait_p95_ms(work: dict):
    """95th percentile of the window's queue waits (``serve.queue_wait_s``)."""
    rec = recorded_of(work, "serve")
    waits = (rec or {}).get("samples", {}).get("serve.queue_wait_s")
    return 1e3 * percentile(waits, 95) if waits else None


def counter_ratio(work: dict, entry: str, num: str, den: str, scale: float = 1.0):
    """``scale`` x the counter ``num`` over the counter ``den``."""
    rec = recorded_of(work, entry)
    counters = (rec or {}).get("counters", {})
    if not counters.get(den):
        return None
    return scale * counters.get(num, 0) / counters[den]


def span_share(work: dict, entry: str, names) -> float | None:
    """100 x the time of the spans ``names`` over the traced window
    (spans of one name do not overlap: each is a stage of one thread's
    loop, none inside another)."""
    spans = [s for s in (recorded_of(work, entry) or {"spans": []})["spans"] if s.name in names]
    window = (work.get("trace") or {}).get("window_s")
    if not spans or not window:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in spans) / 1e9 / window


def mean_span_ms(work: dict, entry: str, name: str):
    """Mean duration of the spans ``name``, in ms."""
    spans = named(recorded_of(work, entry) or {"spans": []}, name)
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def chunk_gaps_ms(rec: dict) -> list:
    """For every ``train.chunk`` but the first, the time from the end of
    the ``train.read_back`` before its first ``train.step`` to that
    step's start, in ms: the card has nothing queued through it."""
    chunks = sorted(named(rec, "train.chunk"), key=lambda s: s.start_ns)
    first_step: dict = {}
    for s in named(rec, "train.step"):
        if s.parent not in first_step or s.start_ns < first_step[s.parent]:
            first_step[s.parent] = s.start_ns
    ends = [s.end_ns for s in named(rec, "train.read_back")]
    gaps = []
    for c in chunks[1:]:
        start = first_step.get(c.id)
        before = [e for e in ends if e <= start] if start is not None else []
        if before:
            gaps.append((start - max(before)) / 1e6)
    return gaps


def chunk_gap_ms(work: dict):
    """Mean of ``chunk_gaps_ms`` over the window."""
    gaps = chunk_gaps_ms(recorded_of(work, "train") or {"spans": []})
    return sum(gaps) / len(gaps) if gaps else None
