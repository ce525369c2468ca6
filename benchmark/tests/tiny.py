"""Tiny CPU cells built from the benchmark's own files: the real
configuration, mix and limits, with the widths, depth and traffic cut to
what a CPU test can hold."""

from __future__ import annotations

import time

import torch

from benchmark.lib.harness import BENCH_DIR, Context, read_json

TINY_MODEL = {"hidden_size": 64, "hidden_layers": 3}
TINY_MIX = {
    "train": {"utterances": 24, "batch_size": 4, "length_median_s": 1.5, "length_max_s": 3.0},
    "serve": {"clips": 16, "rate_per_s": 10.0, "length_median_s": 1.5, "length_max_s": 3.0,
              "client_threads": 8, "check_requests": 4, "max_batch": 4, "trace_seconds": 1.0},
}


def context(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0, **model) -> Context:
    bench = read_json(BENCH_DIR.parent / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = read_json(BENCH_DIR.parent / cfg_entry["file"])
    cfg["model"].update(TINY_MODEL, **model)
    mix = read_json(BENCH_DIR / "mixes" / f"{entry['traffic']}.json")
    mix.update(TINY_MIX[mix["entry"]])
    torch.set_num_threads(2)
    return Context(cell=entry, cfg=cfg, mix=mix, limits=read_json(BENCH_DIR / "limits" / f"{cell}.json"),
                   seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
                   t0=time.perf_counter())


def entry(name: str):
    from benchmark.run import load_module

    return load_module(BENCH_DIR / "entries" / f"{name}.py", f"tiny_entry_{name}")
