"""Share of the traced serving window that the service's worker holds a
batch open for more requests (``ServeConfig.batch_window_ms`` at most a
batch, less when the batch fills first): the program's
``serve.collect`` spans over the window."""
from benchmark.lib.spans import span_share


def read(work: dict):
    return span_share(work, "serve", ("serve.collect",))
