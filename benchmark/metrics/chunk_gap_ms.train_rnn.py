"""The gap at a chunk boundary in the vanilla RNN cell's traced training
window, while the card has nothing queued, read as ``chunk_gap_ms.train``
reads it: over every chunk but the window's first, the mean time from the
end of the program's ``train.read_back`` to the start of the chunk's
first ``train.step``."""
from benchmark.lib.spans import chunk_gap_ms


def read(work: dict):
    return chunk_gap_ms(work)
