"""WER / CER (port of ``tpuasr/decode/metrics.py``): Levenshtein
distance over words / characters, and the reference's aggregate (sum
of distances over sum of reference lengths, x100).

The distance runs in the port's C++ library (``tpuasr_edit_distance``
in ``decode/csrc/ctc_beam.cpp``, built at first use by
``decode/native.py``), as the JAX package runs its native one. Where
that library cannot be built (no host compiler), it falls back, as the
JAX package does, to the vectorised numpy row recurrence
(``_lev_numpy``), its plain version. Both are host arithmetic on
integers and give the same distances; neither is a device kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np

_native_dist = None


def _load_native():
    """The native distance function, or False where the library does not
    build or load (then the numpy recurrence runs)."""
    global _native_dist
    if _native_dist is None:
        try:
            from tpuasr_torch.decode.native import _load_lib

            _native_dist = _load_lib().tpuasr_edit_distance
        except (OSError, RuntimeError):
            _native_dist = False
    return _native_dist


def _ids(a, b) -> tuple[np.ndarray, np.ndarray]:
    """Tokens -> int32 codes: chars by codepoint, words interned per pair."""
    if isinstance(a, str):
        return (np.array([ord(c) for c in a], np.int32),
                np.array([ord(c) for c in b], np.int32))
    vocab: dict = {}
    return (np.array([vocab.setdefault(t, len(vocab)) for t in a], np.int32),
            np.array([vocab.setdefault(t, len(vocab)) for t in b], np.int32))


def _lev_numpy(ai: np.ndarray, bi: np.ndarray) -> int:
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


def _lev_dp(a, b) -> int:
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    ai, bi = _ids(a, b)
    fn = _load_native()
    if fn:
        i32p = ctypes.POINTER(ctypes.c_int32)
        return int(fn(ai.ctypes.data_as(i32p), len(ai), bi.ctypes.data_as(i32p), len(bi)))
    return _lev_numpy(ai, bi)


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
