"""95th percentile of the time the traced window's requests waited in
the service's queue, from ``transcribe_wave``'s enqueue to the close of
their batch (the program's ``serve.queue_wait_s`` samples)."""
from benchmark.lib.spans import queue_wait_p95_ms


def read(work: dict):
    return queue_wait_p95_ms(work)
