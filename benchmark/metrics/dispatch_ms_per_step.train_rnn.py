"""The host's time per training step in the vanilla RNN cell's traced
window, launch back-pressure included: the mean of the program's
``train.step`` spans, read as ``dispatch_ms_per_step.train`` reads them
(its docstring says when this is the host's own work and when the
card's step)."""
from benchmark.lib.spans import mean_span_ms


def read(work: dict):
    return mean_span_ms(work, "train", "train.step")
