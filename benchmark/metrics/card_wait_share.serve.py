"""Share of the traced serving window that the service's worker waits for
the card: the best path's launches and its copies to the host, which
wait for the batch's forward, the program's ``greedy.readback`` spans
over the window. A second batch in flight would give the worker this
time for the next batch's host stages."""
from benchmark.lib.spans import span_share


def read(work: dict):
    return span_share(work, "serve", ("greedy.readback",))
