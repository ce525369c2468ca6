"""The RNN backward kernels' share of their roofline in training: the
sum of the backward bounds of the window's layer calls at their bucket
shapes over the device time of the kernels named below."""
from benchmark.lib.readers import rnn_bound_ms, roofline_percent

FRAGMENTS = ("hg_gemm", "rnn_bwd_loop")


def read(work: dict):
    if work.get("entry") != "train":
        return None
    return roofline_percent(work, rnn_bound_ms(work, backward=True), FRAGMENTS)
