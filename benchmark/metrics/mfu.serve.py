"""Forward FLOPs of the traced window's served requests at their own
lengths over the device's busy time at the bf16 peak (the fixed rate,
not the card, sets the window)."""
from benchmark.lib.readers import mfu_percent


def read(work: dict):
    return mfu_percent(work, 1.0, per="busy_s") if work.get("entry") == "serve" else None
