"""Share of the vanilla RNN cell's traced training window in which the
device ran nothing."""
from benchmark.lib.readers import idle_percent


def read(work: dict):
    return idle_percent(work) if work.get("entry") == "train" else None
