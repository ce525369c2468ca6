"""Plot training curves from a metrics.jsonl log (a copy of
``tpuasr/cli/plot_metrics.py``).

The reference plotted live through ``--visdom``/``--tensorboard``. Here
the durable artifact is the JSONL log
(``tpuasr_torch.train.logging.MetricsLogger``; every ``--log-dir`` run
writes one), and this CLI renders it to PNG/SVG after the fact or
mid-run. matplotlib is imported only to draw, so ``--list`` works
without it. Curves survive resumes: resumed runs append to the same
metrics.jsonl, and the step axis is the global iteration/epoch, so the
plot is continuous across restarts.

Usage:
    python -m tpuasr_torch.cli.plot_metrics <log_dir-or-metrics.jsonl>
        [--out curves.png] [--keys train/loss epoch/wer epoch/cer]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_records(path: str) -> list[dict]:
    """Read metrics.jsonl (accepts the log dir or the file itself)."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a live writer
    return records


def series_of(records: list[dict], key: str) -> tuple[list, list]:
    """(steps, values) of one scalar key, NaNs dropped."""
    xs, ys = [], []
    for r in records:
        v = r.get(key)
        if v is None:
            continue
        try:
            v = float(v)
        except (TypeError, ValueError):
            continue
        if v != v:  # NaN (e.g. epochs without a val set)
            continue
        xs.append(r.get("step", len(xs)))
        ys.append(v)
    return xs, ys


def available_keys(records: list[dict]) -> list[str]:
    keys: set = set()
    for r in records:
        keys.update(k for k in r if k not in ("step", "time"))
    return sorted(keys)


DEFAULT_KEYS = ("train/loss", "epoch/loss", "epoch/wer", "epoch/cer",
                "epoch/lr")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr metrics plotter")
    p.add_argument("log", help="log dir or metrics.jsonl path")
    p.add_argument("--out", default=None,
                   help="output image (default <log_dir>/curves.png)")
    p.add_argument("--keys", nargs="*", default=None,
                   help="scalar keys to plot (default: loss/WER/CER/lr "
                   "panels that exist); use --list to see them")
    p.add_argument("--list", action="store_true",
                   help="print available keys and exit")
    args = p.parse_args(argv)

    records = load_records(args.log)
    if not records:
        print("no records found", file=sys.stderr)
        return 1
    if args.list:
        for k in available_keys(records):
            print(k)
        return 0

    keys = args.keys or [k for k in DEFAULT_KEYS
                         if any(k in r for r in records)]
    if not keys:
        keys = available_keys(records)[:6]
    if not keys:
        print("no scalar keys found", file=sys.stderr)
        return 1

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(keys)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.4 * n), sharex=False)
    if n == 1:
        axes = [axes]
    for ax, key in zip(axes, keys):
        xs, ys = series_of(records, key)
        if not xs:
            ax.set_title(f"{key} (no data)")
            continue
        ax.plot(xs, ys, linewidth=1.0)
        ax.set_title(key)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("step")
    fig.tight_layout()

    out = args.out
    if out is None:
        base = args.log if os.path.isdir(args.log) \
            else os.path.dirname(args.log) or "."
        out = os.path.join(base, "curves.png")
    fig.savefig(out, dpi=110)
    print(f"wrote {out} ({len(records)} records, keys: {', '.join(keys)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
