#!/usr/bin/env python3
"""The knee of a serving cell: its service under open-loop streams at
several fixed rates, one after another in one process (not run by the
benchmark's own runs).

    python3 benchmark/knee.py --workload <cell> --rates 200,300,400 [--seconds 10] [--seed 1]

One JSON line a rate: requests sent and failed, latency p50/p95/p99 (ms,
from when each request was due), the rate completed, and the backlog's
growth: the median latency of the last fifth of the requests (by due
time) over that of the first fifth. A rate the service sustains keeps
that ratio near 1; past the knee the queue grows through the window.
"""

from __future__ import annotations

import argparse
import json
import gc
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.run import BENCH_DIR, load_module, make_context  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from benchmark.lib.harness import percentile
    from benchmark.lib.traffic import make_corpus, open_loop_schedule

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ctx = make_context(bench, args.workload, args.seed, args.seconds, False,
                       torch.device("cuda", 0))
    serve = load_module(BENCH_DIR / "entries" / "serve.py", "knee_serve")
    svc = serve.build_service(ctx, args.seed)
    corpus = make_corpus(ctx.mix["clips"], ctx.mix, args.seed, ctx.device)
    clips = [p.astype(np.float32) / 32768.0 for p in corpus.pcm]
    gc.collect()  # as the serving entry does before its window
    for rate in [float(r) for r in args.rates.split(",")]:
        due, which = open_loop_schedule(rate, args.seconds, len(clips), args.seed)
        out = serve.serve_window(svc, clips, due, which, ctx.mix["client_threads"])
        ok = ~np.isnan(out["latency"])
        lat = out["latency"][ok].tolist()
        by_due = out["latency"][np.argsort(due, kind="stable")]
        by_due = by_due[~np.isnan(by_due)].tolist()
        fifth = max(1, len(by_due) // 5)
        last_done = float(np.max(due[ok] + out["latency"][ok]))
        print(json.dumps({
            "rate_per_s": rate, "sent": len(due), "failed": int((~ok).sum()),
            "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
            "p99_ms": 1e3 * percentile(lat, 99), "completed_per_s": len(lat) / last_done,
            "backlog_growth": statistics.median(by_due[-fifth:]) / statistics.median(by_due[:fifth]),
            "late_max_ms": 1e3 * float(np.nanmax(out["late"])),
            "gc_full_passes": out["gc"].count, "gc_longest_ms": 1e3 * out["gc"].longest}),
            flush=True)
    svc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
