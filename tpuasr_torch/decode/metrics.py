"""WER / CER (port of ``tpuasr/decode/metrics.py``): Levenshtein
distance over words / characters, and the reference's aggregate (sum
of distances over sum of reference lengths, x100). The distance is the
JAX package's vectorised numpy row recurrence; its native library is
not loaded.
"""

from __future__ import annotations

import numpy as np


def _lev_dp(a, b) -> int:
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    if isinstance(a, str):
        ai = np.array([ord(c) for c in a], np.int64)
        bi = np.array([ord(c) for c in b], np.int64)
    else:  # word lists: intern tokens to ids
        vocab: dict = {}
        ai = np.array([vocab.setdefault(t, len(vocab)) for t in a], np.int64)
        bi = np.array([vocab.setdefault(t, len(vocab)) for t in b], np.int64)
    ar = np.arange(len(bi) + 1, dtype=np.int64)
    prev = ar.copy()
    c = np.empty(len(bi) + 1, dtype=np.int64)
    for i in range(1, len(ai) + 1):
        # c[j] = min(prev[j-1] + subst, prev[j] + 1); c[0] = i
        np.minimum(prev[:-1] + (bi != ai[i - 1]), prev[1:] + 1, out=c[1:])
        c[0] = i
        # cur[j] = min_{k<=j} (c[k] + j - k): one accumulate pass
        prev = np.minimum.accumulate(c - ar) + ar
    return int(prev[-1])


def levenshtein(a, b) -> int:
    """Edit distance between two sequences (str or list)."""
    return _lev_dp(a, b)


def word_errors(hyp: str, ref: str) -> tuple[int, int]:
    h, r = hyp.split(), ref.split()
    return _lev_dp(h, r), len(r)


def char_errors(hyp: str, ref: str) -> tuple[int, int]:
    """Spaces count as characters, as in the reference's ``cer``."""
    return _lev_dp(hyp, ref), len(ref)


def wer(hyp: str, ref: str) -> float:
    d, n = word_errors(hyp, ref)
    return d / max(n, 1)


def cer(hyp: str, ref: str) -> float:
    d, n = char_errors(hyp, ref)
    return d / max(n, 1)


class ErrorRateMeter:
    """Accumulates the reference's aggregate WER/CER."""

    def __init__(self):
        self.word_dist = self.word_count = 0
        self.char_dist = self.char_count = 0
        self.n_utts = 0

    def update(self, hyp: str, ref: str) -> None:
        wd, wc = word_errors(hyp, ref)
        cd, cc = char_errors(hyp, ref)
        self.word_dist += wd
        self.word_count += wc
        self.char_dist += cd
        self.char_count += cc
        self.n_utts += 1

    @property
    def wer(self) -> float:
        return 100.0 * self.word_dist / max(self.word_count, 1)

    @property
    def cer(self) -> float:
        return 100.0 * self.char_dist / max(self.char_count, 1)
