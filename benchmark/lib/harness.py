"""What every entry of the benchmark shares: the run's context, its
result, the traced window, and the comparisons that decide ``correct``."""

from __future__ import annotations

import contextlib
import json
import math
import statistics
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.lib.trace import WINDOW_SPAN, load_events, window_summary

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
OUT_DIR = ROOT / "build" / "benchmark"  # traces; inside the checkout, ignored by git


@dataclass
class Context:
    """One run: the cell's entry of BENCHMARK.json, its configuration,
    traffic mix and limits (parsed JSON), and the command's arguments."""

    cell: dict
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # time.perf_counter() at process start

    @property
    def name(self) -> str:
        return self.cell["name"]


@dataclass
class Result:
    """What an entry measured. ``e2e``: end-to-end values by metric name;
    ``work``: what the per-layer readers read (the traced window's
    summary and the work done in it); ``checks``: (name, value, limit)
    of every number compared."""

    e2e: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: list = field(default_factory=list)
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks) and self.failed == 0


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@contextlib.contextmanager
def traced_window(enabled: bool, name: str):
    """The traced window: the card drained first, a host span named
    WINDOW_SPAN around the body, the card drained again before the span
    closes. Yields a dict that holds the window's summary
    (``trace.window_summary``) once the block has ended; with
    ``enabled`` False the block runs untraced and the dict stays empty."""
    import torch

    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield out
            torch.cuda.synchronize()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{name}.trace.json"
    prof.export_chrome_trace(str(path))
    out.update(window_summary(load_events(path)))


def leaf_gaps(prog: dict, ref: dict, skip=()) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's,
    worst first: [(gap, leaf name)]. Leaves in ``skip`` are left out."""
    norms = {k: float(ref[k].double().norm()) for k in ref if k not in skip}
    med = statistics.median(norms.values())
    return sorted(((abs(float(prog[k].double().norm()) - r) / max(r, med, 1e-30), k)
                   for k, r in norms.items()), reverse=True)


def still_leaves(first_grad: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is nought to rounding: its norm
    under ``share`` of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in first_grad.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n < share * med}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
