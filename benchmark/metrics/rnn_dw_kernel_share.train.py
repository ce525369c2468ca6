"""The share of the traced training window's RNN backwards whose weight
gradients ran the bf16 kernel: 100 x the program's counter
``rnn.dw_kernel_calls`` over it plus ``rnn.dw_einsum_calls`` (backwards
that took the f32 einsum), in the GRU and LSTM training cells.

A guard, not a measure of speed: on CUDA with bf16 compute every
backward forms dw and db with ``dw_gemm_bf16`` or raises, so this reads
100 until a change lets a backward fall back to the einsum on the card. A
program without the counters (one that has no such kernel) reads
nothing."""
from benchmark.lib.spans import recorded_of


def read(work: dict):
    counters = (recorded_of(work, "train") or {}).get("counters", {})
    kernel = counters.get("rnn.dw_kernel_calls", 0)
    total = kernel + counters.get("rnn.dw_einsum_calls", 0)
    return 100.0 * kernel / total if total else None
