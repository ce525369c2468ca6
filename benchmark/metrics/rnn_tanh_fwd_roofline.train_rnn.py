"""K6f's share of its roofline in the vanilla RNN cell's training: the sum
of the forward bounds of the window's layer calls at their bucket shapes
(``bounds_rnn.tanh_rnn_bound``) over the device time of the kernel named
below."""
from benchmark.lib.bounds_rnn import tanh_bound_ms
from benchmark.lib.readers import roofline_percent

FRAGMENTS = ("rnn_fwd_loop<__nv_bfloat16, 1,", "rnn_fwd_loop<float, 1,")  # the one-gate instance


def read(work: dict):
    if work.get("entry") != "train" or work["cfg"].get("rnn_type") != "rnn":
        return None
    return roofline_percent(work, tanh_bound_ms(work, backward=False), FRAGMENTS)
