"""Model FLOPs of the traced window's training steps (three forwards a
real frame) over the window at the bf16 peak."""
from benchmark.lib.readers import mfu_percent


def read(work: dict):
    return mfu_percent(work, 3.0) if work.get("entry") == "train" else None
