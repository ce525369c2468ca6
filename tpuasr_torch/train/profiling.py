"""Profiling helpers (port of ``tpuasr/train/profiling.py``) on
``torch.profiler``: the host's CPU activity and the card's CUDA kernels,
written as a Chrome trace (chrome://tracing or Perfetto).

Usage: ``python -m tpuasr_torch.cli.train ... --profile-dir /tmp/trace``
traces steps 10-15 of the run, or programmatically:

    with step_trace("/tmp/trace"):
        metrics = train_step(...)
"""

from __future__ import annotations

import contextlib
import os

import torch


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
