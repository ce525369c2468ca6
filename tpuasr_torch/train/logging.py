"""Training observability (a copy of ``tpuasr/train/logging.py``):
running meters, console lines, an always-on JSONL metrics log
(``<log_dir>/metrics.jsonl``) and TensorBoard scalars when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time


class AverageMeter:
    """ref:train.py AverageMeter: running value/avg."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricsLogger:
    """JSONL + console + optional TensorBoard scalar logging."""

    def __init__(self, log_dir: str | None = None, tensorboard: bool = False,
                 quiet: bool = False):
        self.quiet = quiet
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir=log_dir)
                except Exception:
                    self._tb = None  # gated: env may lack tensorboard

    def log(self, step: int, scalars: dict, prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({f"{prefix}{k}": _to_float(v) for k, v in scalars.items()})
        if self._jsonl is not None:
            # no per-line flush: the train loop flushes per sync window
            # (a per-step fsync stalls the device dispatch pipeline)
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(prefix + k, _to_float(v), step)

    def console(self, msg: str) -> None:
        if not self.quiet:
            print(msg, flush=True)

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
