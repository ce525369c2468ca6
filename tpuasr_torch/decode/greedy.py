"""Greedy (best-path) CTC decoding (port of ``tpuasr/decode/greedy.py``).

Per-frame argmax, collapse repeats, drop blanks, optional per-character
frame offsets. The argmax and collapse mask run on the logits' device
over the whole padded batch; the ragged strings are assembled on host.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuasr_torch.labels import Alphabet
from tpuasr_torch.profiling import span


def greedy_best_path(logits: torch.Tensor, lengths: torch.Tensor,
                     blank_id: int = 0):
    """(B, T, C) logits (or log-probs) -> per-frame best ids (B, T) and
    an emission mask (B, T), True exactly at frames that contribute a
    character after CTC collapse. Ties go to the lowest id."""
    ids = torch.argmax(logits, dim=-1)
    prev = torch.nn.functional.pad(ids, (1, 0), value=-1)[:, :-1]
    t = torch.arange(ids.shape[1], device=ids.device)[None, :]
    lengths = lengths.to(ids.device)
    emit = (ids != blank_id) & (ids != prev) & (t < lengths[:, None])
    return ids, emit


class GreedyDecoder:
    """String-level greedy decoder: ``decode(logits, lengths)`` ->
    transcripts (and per-character frame offsets)."""

    def __init__(self, alphabet: Alphabet):
        self.alphabet = alphabet
        self._blank = alphabet.blank_id

    def decode(self, logits, lengths, return_offsets: bool = False):
        """Spans: ``greedy.readback`` (the best path and its copies to
        the host, which wait for the card) and ``greedy.text``."""
        with span("greedy.readback"):
            ids, emit = greedy_best_path(torch.as_tensor(logits),
                                         torch.as_tensor(lengths),
                                         blank_id=self._blank)
            ids = ids.cpu().numpy()
            emit = emit.cpu().numpy()
        with span("greedy.text"):
            texts, offsets = [], []
            for b in range(ids.shape[0]):
                frames = np.nonzero(emit[b])[0]
                texts.append(self.alphabet.decode(ids[b, frames]))
                offsets.append(frames)
        if return_offsets:
            return texts, offsets
        return texts

    def convert_to_strings(self, label_seqs) -> list[str]:
        """Integer target sequences -> strings."""
        return [self.alphabet.decode(seq) for seq in label_seqs]
