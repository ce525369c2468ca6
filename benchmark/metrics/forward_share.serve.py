"""Share of the traced serving window that the service's worker spends
handing a batch to the card: the pageable copy of the padded batch and
the forward's launches, the program's ``serve.forward`` spans (around
the eval step, which reads nothing back) over the window."""
from benchmark.lib.spans import span_share


def read(work: dict):
    return span_share(work, "serve", ("serve.forward",))
