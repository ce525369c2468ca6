"""Model FLOPs of the vanilla RNN cell's traced training steps (three
forwards a real frame, the recurrent layers at one gate:
``bounds_rnn.forward_flops_per_frame``) over the window at the bf16
peak."""
from benchmark.lib.bounds_rnn import mfu_percent


def read(work: dict):
    if work.get("entry") != "train" or work["cfg"].get("rnn_type") != "rnn":
        return None
    return mfu_percent(work, 3.0)
