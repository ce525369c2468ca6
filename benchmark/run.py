#!/usr/bin/env python3
"""The benchmark of tpuasr_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` (at the checkout's root) and prints,
as the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown`` of the traced window, and last ``checks``: each
number compared for ``correct`` beside its limit. The same checks are
the last lines of its standard error.

Everything is found by name: the cell's configuration in its ``file``,
its traffic mix in ``benchmark/mixes/<traffic>.json``, the mix's entry
in ``benchmark/entries/<entry>.py``, the cell's limits in
``benchmark/limits/<cell>.json``, and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``. A new cell, configuration, mix or
metric is files and entries, and no edit here.

The run fails, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
``tpuasr`` (whole top-level module names) is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuasr")


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, found by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str):
    """(cell entry, configuration entry), or raises KeyError."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, cfg


def make_context(bench: dict, name: str, seed: int, seconds: float, trace: bool, device):
    from benchmark.lib.harness import Context, read_json

    cell, cfg_entry = find_cell(bench, name)
    mix = read_json(BENCH_DIR / "mixes" / f"{cell['traffic']}.json")
    return Context(cell=cell, cfg=read_json(ROOT / cfg_entry["file"]), mix=mix,
                   limits=read_json(BENCH_DIR / "limits" / f"{name}.json"), seed=seed,
                   seconds=seconds, trace=trace, device=device, t0=T0)


def run_entry(ctx):
    entry = load_module(BENCH_DIR / "entries" / f"{ctx.mix['entry']}.py",
                        f"benchmark_entry_{ctx.mix['entry']}")
    return entry.run(ctx)


def metrics_of(bench: dict, ctx, res) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced) as {name: {"value", "unit"}}; a reader that finds nothing
    leaves its metric out."""
    out = {}
    if not ctx.trace:
        for m in bench["end_to_end"]:
            if applies(m, ctx.name):
                out[m["name"]] = {"value": float(res.e2e[m["name"]]), "unit": m["unit"]}
        return out
    for m in bench["per_layer"]:
        if not applies(m, ctx.name):
            continue
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(res.work)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(bench: dict, ctx, res, device: dict) -> dict:
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics_of(bench, ctx, res), "device": device}
    trace = res.work.get("trace") or {}
    if ctx.trace and trace:
        line["device"] = {**device, "busy_s": trace["busy_s"], "window_s": trace["window_s"]}
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for name, v, lim in res.checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, _ = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_context(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    res = run_entry(ctx)
    return finish(bench, ctx, res, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
        "memory_peak_bytes": res.memory_peak_bytes})


def finish(bench: dict, ctx, res, device: dict) -> int:
    """Refuse a run that loaded a forbidden module (naming it on standard
    error, printing no result); otherwise print the checks as the last
    lines of standard error and the result as the last line of standard
    output."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result_line(bench, ctx, res, device)
    for name, v, lim in res.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
