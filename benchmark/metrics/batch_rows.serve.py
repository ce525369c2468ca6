"""Real rows a served batch in the traced window: the program's
``serve.rows`` over ``serve.batches`` (every batch computes
``max_batch`` rows whatever this reads)."""
from benchmark.lib.spans import counter_ratio


def read(work: dict):
    return counter_ratio(work, "serve", "serve.rows", "serve.batches")
