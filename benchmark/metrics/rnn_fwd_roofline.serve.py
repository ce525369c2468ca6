"""The RNN forward kernel's share of its roofline in serving: the
forward bound of the served requests' real frames (one call a layer
over all of them) over the device time of the kernels named below."""
from benchmark.lib.readers import rnn_bound_ms, roofline_percent

FRAGMENTS = ("rnn_fwd_loop",)


def read(work: dict):
    if work.get("entry") != "serve":
        return None
    return roofline_percent(work, rnn_bound_ms(work, backward=False), FRAGMENTS)
