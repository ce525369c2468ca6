"""Share of the audio the card computes in the traced serving window
that is real: the program's ``serve.real_samples`` over
``serve.computed_samples`` (``max_batch`` rows of each batch's bucket)."""
from benchmark.lib.spans import counter_ratio


def read(work: dict):
    return counter_ratio(work, "serve", "serve.real_samples", "serve.computed_samples", 100.0)
