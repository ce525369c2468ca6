"""The share of the traced window's vanilla RNN layer calls that ran the
fused kernels: 100 x the program's counter ``rnn.tanh_kernel_calls`` over
it plus ``rnn.tanh_loop_calls`` (calls that ran the plain loop).

A guard, not a measure of speed: on CUDA the program runs every vanilla
layer on K6f/K6b or raises, so this reads 100 until a change lets a layer
fall back to the plain loop on the card."""
from benchmark.lib.spans import recorded_of


def read(work: dict):
    counters = (recorded_of(work, "train") or {}).get("counters", {})
    kernel = counters.get("rnn.tanh_kernel_calls", 0)
    total = kernel + counters.get("rnn.tanh_loop_calls", 0)
    return 100.0 * kernel / total if total else None
