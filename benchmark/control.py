#!/usr/bin/env python3
"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 4]

For each seed, one JSON line: the program's reading of every number the
cell compares (its timed path at the cell's own sizes against the
reference) and, for the control seeds, the control's (the reference in
float8 put in the program's place) and, in training, the fault's that
leaves out half of each batch. The last line gives the largest program
reading and the smallest control and fault readings of each number.
All seeds run in one process; ``--seconds`` is the short window at the
cell's own load where the cell needs one (serving).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.run import BENCH_DIR, load_module, make_context  # noqa: E402


def summarise(lines: list) -> dict:
    out: dict = {}
    for line in lines:
        for kind, readings in line.items():
            if kind == "seed":
                continue
            for k, v in readings.items():
                if isinstance(v, (int, float)):
                    out.setdefault(kind, {}).setdefault(k, []).append(v)
    return {kind: {k: (max(v) if kind == "program" else min(v)) for k, v in d.items()}
            for kind, d in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    keep: dict = {}
    lines = []
    for seed in seeds:
        t = time.perf_counter()
        ctx = make_context(bench, args.workload, seed, args.seconds, False,
                           torch.device("cuda", 0))
        entry = load_module(BENCH_DIR / "entries" / f"{ctx.mix['entry']}.py", "control_entry")
        line = {"seed": seed, **entry.control_readings(ctx, keep, seed in controls)}
        line["seconds"] = {"run": time.perf_counter() - t}
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summarise(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
