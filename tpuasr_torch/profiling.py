"""Profiling on ``torch.profiler`` (port of ``tpuasr/train/profiling.py``),
and the program's own spans and counters.

Traces: the host's CPU activity and the card's CUDA kernels, written as
a Chrome trace (chrome://tracing or Perfetto).
``python -m tpuasr_torch.cli.train ... --profile-dir /tmp/trace`` traces
steps 10-15 of the run, or programmatically:

    with step_trace("/tmp/trace"):
        metrics = train_step(...)

Spans and counters: ``span(name)`` around a stage of the serving worker
or the training runner, ``count(name, n)`` and ``sample(name, value)``
where the work is counted. They record only while a ``torch.profiler``
profile runs (any: ``step_trace``, ``StepProfiler``, the benchmark's
traced window); otherwise ``span`` returns one shared no-op context and
the others return at once, so untraced runs pay one attribute check. A
recorded span is also a ``record_function`` range, so it lands in the
profiler's trace as a ``user_annotation`` on the device's clock where
the profile records its thread (the thread that started it, or every
thread with ``_ExperimentalConfig(profile_all_threads=True)``); it is
kept in memory in any case, with its start and end
(``time.perf_counter_ns``) and the enclosing span on its thread.
``recorded()`` reads what was kept since the last ``reset()``; spans and
samples past ``MAX_KEPT`` (together) are counted under
``profiling.dropped`` instead.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_KEPT = 1_000_000


def _activities() -> list:
    """CPU, and CUDA where this build of torch can trace it."""
    want = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    return [a for a in want if a in torch.profiler.supported_activities()]


def _export(prof, log_dir: str, name: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def step_trace(log_dir: str | None, enabled: bool = True):
    """Trace the body into ``log_dir``/trace.pt.trace.json."""
    if not (log_dir and enabled):
        yield
        return
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    _export(prof, log_dir, "trace")


class StepProfiler:
    """Trace a window of training steps [start, stop) into log_dir:
    ``maybe_start(step)`` before a step, ``maybe_stop(step)`` with the
    count of steps done after it, ``close()`` at the end of the run.
    The trace is written when the window closes (or on ``close``) as
    ``log_dir``/steps_{start}-{stop}.pt.trace.json."""

    def __init__(self, log_dir: str | None, start: int = 10, stop: int = 15):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.log_dir and self._prof is None and step == self.start:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            _export(self._prof, self.log_dir, f"steps_{self.start}-{self.stop}")
            self._prof = None


class Span(NamedTuple):
    """A recorded span: ``parent`` is the ``id`` of the span that
    enclosed it on its thread (None at the top); times in ns of
    ``time.perf_counter_ns``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None


class _Recorder:
    """What the spans, counters and samples recorded, behind one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: the open spans' ids
        self.ids = itertools.count()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans: list = []
            self.counters: dict = {}
            self.samples: dict = {}
            self.kept = 0  # spans and samples, against MAX_KEPT

    def keep(self, items: list, item) -> None:
        """Append ``item`` to ``items`` below the cap, else count it
        dropped; the caller holds the lock."""
        if self.kept < MAX_KEPT:
            items.append(item)
            self.kept += 1
        else:
            self.counters["profiling.dropped"] = self.counters.get("profiling.dropped", 0) + 1


_RECORDER = _Recorder()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "stack", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _RECORDER
        self.id = next(rec.ids)
        self.stack = getattr(rec.local, "stack", None)
        if self.stack is None:
            self.stack = rec.local.stack = []
        self.parent = self.stack[-1] if self.stack else None
        self.stack.append(self.id)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.stack.pop()
        if not _autograd_profiler._is_profiler_enabled:
            return False  # the trace stopped inside the span: neither keeps it
        rec = _RECORDER
        with rec.lock:
            rec.keep(rec.spans, Span(self.id, self.name, self.start, end, self.parent))
        return False


def tracing() -> bool:
    """True while a ``torch.profiler`` profile runs: spans, counters and
    samples record."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context that records the body as the span ``name`` while
    tracing, and the shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    rec = _RECORDER
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def sample(name: str, value: float) -> None:
    """Append ``value`` to the samples ``name`` while tracing."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    rec = _RECORDER
    with rec.lock:
        rec.keep(rec.samples.setdefault(name, []), value)


def recorded() -> dict:
    """A snapshot of what was recorded since the last ``reset()``:
    ``spans`` (a list of ``Span`` in the order they closed),
    ``counters`` {name: total} and ``samples`` {name: [value]}."""
    rec = _RECORDER
    with rec.lock:
        return {"spans": list(rec.spans), "counters": dict(rec.counters),
                "samples": {k: list(v) for k, v in rec.samples.items()}}


def reset() -> None:
    """Forget every span, counter and sample recorded so far."""
    _RECORDER.reset()
