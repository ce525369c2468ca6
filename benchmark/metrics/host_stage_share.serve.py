"""Share of the traced serving window that the service's worker spends on
host-only work between a batch's close and the next, while the card gets
nothing from it: the program's ``serve.pad``, ``greedy.text`` and
``serve.respond`` spans over the window."""
from benchmark.lib.spans import span_share

STAGES = ("serve.pad", "greedy.text", "serve.respond")


def read(work: dict):
    return span_share(work, "serve", STAGES)
