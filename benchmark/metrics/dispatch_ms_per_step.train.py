"""The host's time per training step in the traced window, launch
back-pressure included: the mean of the program's ``train.step`` spans.
A step queues ~1,300 launches and nothing in it waits for the card, but
the card's launch queue holds about one step, so where the card's step
is the longer the host blocks in the launches and this reads the card's
step; where the host's own work is the longer (the shortest buckets) it
reads that."""
from benchmark.lib.spans import mean_span_ms


def read(work: dict):
    return mean_span_ms(work, "train", "train.step")
