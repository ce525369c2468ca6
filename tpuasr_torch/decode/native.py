"""ctypes bindings of the C++ host beam search (port of
``tpuasr/decode/native.py``).

The decoder is the port's own copy of the JAX package's C++ source,
``tpuasr_torch/decode/csrc/ctc_beam.cpp`` (ABI version 3), built at
first use into ``build/`` by ``ops/_build.py build_host`` with the host
compiler (``$CXX``, default ``c++``). It plays the role of ctcdecode's
``CTCBeamDecoder`` (``NativeBeamDecoder``, ``--decoder beam-native``)
and keeps one stateful beam per live stream (``NativeBeamSession``,
``--beam-impl native``). ``write_lm_binary`` writes the flat hash
tables the C++ side reads; its bytes equal the JAX package's, so the
``<lm>.tpuasrlm`` cache beside an ARPA file serves both packages.

Logits may be torch tensors on any device or numpy arrays; they are
normalised by an f32 log-softmax on the host before the call.
"""

from __future__ import annotations

import ctypes
import os
import struct
import tempfile
from pathlib import Path

import numpy as np
import torch

from tpuasr_torch.decode.lm import ArpaLM, HashedNGramLM
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ctc_beam.cpp"
ABI_VERSION = 3

_lib = None

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_BEAM_ARGS = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # blank space width
    ctypes.c_void_p,  # lm
    ctypes.c_float, ctypes.c_float,  # alpha beta
    ctypes.c_int, ctypes.c_float,  # cutoff_top_n cutoff_prob
    ctypes.c_float,  # prune_logp
]
_BATCH_HEAD = [
    _c_float_p,  # logprobs (B, T, C)
    _c_int_p,  # lengths
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B T C
    ctypes.POINTER(ctypes.c_char_p),  # labels
]


def _load_lib():
    """The C++ library, built from the port's source on first use;
    raises when it does not build or is not ABI version 3."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host(SOURCE)
    lib.tpuasr_abi_version.restype = ctypes.c_int
    lib.tpuasr_abi_version.argtypes = []
    if lib.tpuasr_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{SOURCE.name} built a library of ABI "
                           f"{lib.tpuasr_abi_version()}, not {ABI_VERSION}")
    lib.tpuasr_lm_load.restype = ctypes.c_void_p
    lib.tpuasr_lm_load.argtypes = [ctypes.c_char_p]
    lib.tpuasr_lm_free.restype = None
    lib.tpuasr_lm_free.argtypes = [ctypes.c_void_p]
    lib.tpuasr_beam_session_new.restype = ctypes.c_void_p
    lib.tpuasr_beam_session_new.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int] + _BEAM_ARGS  # labels C
    for fn in (lib.tpuasr_beam_session_free, lib.tpuasr_beam_session_reset,
               lib.tpuasr_beam_session_feed):
        fn.restype = None
    lib.tpuasr_beam_session_free.argtypes = [ctypes.c_void_p]
    lib.tpuasr_beam_session_reset.argtypes = [ctypes.c_void_p]
    lib.tpuasr_beam_session_feed.argtypes = [ctypes.c_void_p, _c_float_p, ctypes.c_int]
    lib.tpuasr_beam_session_prefix.restype = ctypes.c_int
    lib.tpuasr_beam_session_prefix.argtypes = [ctypes.c_void_p, _c_int_p, _c_int_p,
                                               ctypes.c_int]
    lib.tpuasr_beam_session_best.restype = ctypes.c_int
    lib.tpuasr_beam_session_best.argtypes = [ctypes.c_void_p, _c_int_p, _c_int_p,
                                             ctypes.c_int, _c_float_p]
    lib.tpuasr_beam_decode_batch.restype = ctypes.c_int
    lib.tpuasr_beam_decode_batch.argtypes = _BATCH_HEAD + _BEAM_ARGS + [
        ctypes.c_int,  # num_threads
        _c_int_p, _c_int_p, _c_int_p,  # out_ids, out_frames, out_lens (B, T)
        _c_float_p,  # out_scores (B,)
    ]
    lib.tpuasr_beam_decode_batch_nbest.restype = ctypes.c_int
    lib.tpuasr_beam_decode_batch_nbest.argtypes = _BATCH_HEAD + _BEAM_ARGS + [
        ctypes.c_int, ctypes.c_int,  # num_threads n_best
        _c_int_p, _c_int_p, _c_int_p,  # out_ids, out_frames (B, n, T), out_lens (B, n)
        _c_float_p,  # out_scores (B, n)
    ]
    lib.tpuasr_edit_distance.restype = ctypes.c_int32
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tpuasr_edit_distance.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    _lib = lib
    return lib


def write_lm_binary(lm: ArpaLM, path: str) -> None:
    """HashedNGramLM tables -> the flat binary the C++ decoder reads
    (natural-log probabilities and backoffs, one table per order)."""
    hashed = HashedNGramLM.build(lm)
    with open(path, "wb") as f:
        f.write(b"TPUASRLM")
        f.write(struct.pack("<I", hashed.order))
        for k in range(hashed.order):
            keys = np.ascontiguousarray(hashed.keys[k], dtype=np.uint64)
            f.write(struct.pack("<Q", keys.shape[0]))
            f.write(keys.tobytes())
            f.write(np.ascontiguousarray(hashed.logps[k], np.float32).tobytes())
            f.write(np.ascontiguousarray(hashed.backoffs[k], np.float32).tobytes())


def _host_inputs(logits, lengths, n_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, T, C) logits (a tensor on any device, or an array) and (B,)
    lengths -> C-ordered f32 log-probabilities and int32 lengths on the
    host, checked before the C++ side reads them."""
    x = torch.as_tensor(logits).detach().to("cpu", torch.float32)
    logprobs = np.ascontiguousarray(torch.log_softmax(x, dim=-1).numpy())
    lengths = np.ascontiguousarray(torch.as_tensor(lengths).cpu().numpy(), np.int32)
    if logprobs.ndim != 3 or logprobs.shape[2] != n_classes:
        raise ValueError(f"logits of shape {tuple(logprobs.shape)}: want (B, T, {n_classes})")
    if lengths.shape != logprobs.shape[:1] or (
            lengths.size and (lengths.min() < 0 or lengths.max() > logprobs.shape[1])):
        raise ValueError(f"lengths {lengths.tolist()} for logits of shape "
                         f"{tuple(logprobs.shape)}")
    return logprobs, lengths


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBeamSession:
    """Stateful incremental prefix beam in C++ for a live stream: the beam
    map persists across ``feed(logprob_rows)`` calls; ``prefix()``
    returns the stable common prefix of every live beam (what a stream
    may commit) and ``best()`` the finalized transcript ids. One session
    per stream (``tpuasr_torch.stream`` with ``beam_impl="native"``).

    ``lm`` may be an ArpaLM (converted once to the binary hash format
    through a temporary file, and shared by every session built from the
    same object) or None. Readout buffers grow as needed.
    """

    def __init__(self, alphabet: Alphabet, lm: ArpaLM | None = None,
                 alpha: float = 0.8, beta: float = 1.0,
                 beam_width: int = 10, cutoff_top_n: int = 40,
                 cutoff_prob: float = 1.0, prune_logp: float = -20.0):
        lib = _load_lib()
        self._lib = lib
        self.alphabet = alphabet
        self._lm = None
        if lm is not None:
            if not hasattr(lm, "_tpuasr_native_handle"):
                with tempfile.NamedTemporaryFile(suffix=".tpuasrlm", delete=False) as f:
                    bin_path = f.name
                try:
                    write_lm_binary(lm, bin_path)
                    handle = lib.tpuasr_lm_load(bin_path.encode())
                finally:
                    os.unlink(bin_path)
                if not handle:
                    raise RuntimeError("failed to load the LM for the native beam")
                # kept for the process's life: every session borrows it
                lm._tpuasr_native_handle = handle
            self._lm = lm._tpuasr_native_handle
        labels = [c.encode("utf-8") for c in alphabet.labels]
        self._labels_arr = (ctypes.c_char_p * len(labels))(*labels)
        self._handle = lib.tpuasr_beam_session_new(
            self._labels_arr, len(labels), alphabet.blank_id, alphabet.space_id,
            beam_width, self._lm, alpha, beta, cutoff_top_n, cutoff_prob, prune_logp)
        self._cap = 256
        self._out = np.zeros((self._cap,), np.int32)
        self._frames = np.zeros((self._cap,), np.int32)

    def feed(self, logprob_rows: np.ndarray) -> None:
        """Advance over (R, C) log-probability rows."""
        rows = np.ascontiguousarray(logprob_rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.alphabet.size:
            raise ValueError(f"rows of shape {rows.shape}: want (R, {self.alphabet.size})")
        self._lib.tpuasr_beam_session_feed(self._handle, _ptr(rows, ctypes.c_float),
                                           rows.shape[0])

    def _read(self, fn, *extra) -> tuple[np.ndarray, np.ndarray]:
        while True:
            n = fn(self._handle, _ptr(self._out, ctypes.c_int),
                   _ptr(self._frames, ctypes.c_int), self._cap, *extra)
            if n < self._cap:
                return self._out[:n].copy(), self._frames[:n].copy()
            self._cap *= 2
            self._out = np.zeros((self._cap,), np.int32)
            self._frames = np.zeros((self._cap,), np.int32)

    def prefix(self) -> np.ndarray:
        """ids of the stable common prefix of all live beams."""
        return self._read(self._lib.tpuasr_beam_session_prefix)[0]

    def prefix_with_frames(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, frames) of the stable common prefix; frames are the best
        beam's per-char emission frames (absolute, counted from the
        first row ever fed)."""
        return self._read(self._lib.tpuasr_beam_session_prefix)

    def best(self) -> tuple[np.ndarray, float]:
        """(ids, score) of the finalized best beam."""
        ids, _, score = self.best_with_frames()
        return ids, score

    def best_with_frames(self) -> tuple[np.ndarray, np.ndarray, float]:
        """(ids, frames, score) of the finalized best beam."""
        score = ctypes.c_float(0.0)
        ids, frames = self._read(self._lib.tpuasr_beam_session_best, ctypes.byref(score))
        return ids, frames, float(score.value)

    def reset(self) -> None:
        self._lib.tpuasr_beam_session_reset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.tpuasr_beam_session_free(self._handle)


class NativeBeamDecoder:
    """Host decoder backed by C++ (a thread pool over the batch), with
    ctcdecode's ``CTCBeamDecoder`` arguments (labels, lm_path, alpha,
    beta, cutoff_top_n, cutoff_prob, beam_width, num_processes).
    ``lm_path`` is an ARPA file, converted to the binary hash format on
    first use and cached beside it as ``<lm_path>.tpuasrlm``."""

    def __init__(self, alphabet: Alphabet, lm_path: str | None = None,
                 alpha: float = 0.8, beta: float = 1.0, beam_width: int = 10,
                 cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
                 num_processes: int = 2, prune_logp: float = -20.0):
        self.alphabet = alphabet
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        self.prune_logp = prune_logp
        self.num_threads = num_processes
        self._lib = _load_lib()
        self._lm = None
        if lm_path:
            with open(lm_path, "rb") as f:
                if f.read(8).startswith(b"mmap lm"):
                    raise ValueError(
                        "the native decoder needs enumerable n-grams to build its "
                        "hash tables; a KenLM probing binary stores only opaque "
                        "hashes — convert to ARPA or use --decoder beam (host, "
                        "reads KenLM binaries)")
            bin_path = lm_path + ".tpuasrlm"
            if not os.path.exists(bin_path) or (
                    os.path.getmtime(bin_path) < os.path.getmtime(lm_path)):
                tmp = f"{bin_path}.{os.getpid()}.tmp"
                write_lm_binary(ArpaLM.load(lm_path), tmp)
                os.replace(tmp, bin_path)  # concurrent decoders never read a torn file
            self._lm = self._lib.tpuasr_lm_load(bin_path.encode())
            if not self._lm:
                raise RuntimeError(f"failed to load LM {bin_path}")
        labels = [c.encode("utf-8") for c in alphabet.labels]
        self._labels_arr = (ctypes.c_char_p * len(labels))(*labels)

    def _search_args(self) -> tuple:
        return (self._labels_arr, self.alphabet.blank_id, self.alphabet.space_id,
                self.beam_width, self._lm, self.alpha, self.beta, self.cutoff_top_n,
                self.cutoff_prob, self.prune_logp, self.num_threads)

    def decode(self, logits, lengths, return_offsets: bool = False):
        logprobs, lengths = _host_inputs(logits, lengths, self.alphabet.size)
        b, t, c = logprobs.shape
        out_ids = np.zeros((b, t), np.int32)
        out_frames = np.zeros((b, t), np.int32)
        out_lens = np.zeros((b,), np.int32)
        out_scores = np.zeros((b,), np.float32)
        rc = self._lib.tpuasr_beam_decode_batch(
            _ptr(logprobs, ctypes.c_float), _ptr(lengths, ctypes.c_int), b, t, c,
            *self._search_args(),
            _ptr(out_ids, ctypes.c_int), _ptr(out_frames, ctypes.c_int),
            _ptr(out_lens, ctypes.c_int), _ptr(out_scores, ctypes.c_float))
        if rc != 0:
            raise RuntimeError(f"native decode failed rc={rc}")
        texts, offsets = [], []
        for i in range(b):
            frames = out_frames[i, :out_lens[i]].astype(np.int64)
            text = self.alphabet.decode(out_ids[i, :out_lens[i]])
            # drop the offsets of the characters .strip() drops
            lpad = len(text) - len(text.lstrip())
            rpad = len(text) - len(text.rstrip())
            texts.append(text.strip())
            offsets.append(frames[lpad:len(frames) - rpad])
        if return_offsets:
            return texts, offsets
        return texts

    def decode_nbest(self, logits, lengths, n_best: int | None = None):
        """Per utterance: [(text, score, offsets)] best-first — every
        beam, its score and its per-char emission frames."""
        n = n_best or self.beam_width
        logprobs, lengths = _host_inputs(logits, lengths, self.alphabet.size)
        b, t, c = logprobs.shape
        out_ids = np.zeros((b, n, t), np.int32)
        out_frames = np.zeros((b, n, t), np.int32)
        out_lens = np.zeros((b, n), np.int32)
        out_scores = np.zeros((b, n), np.float32)
        rc = self._lib.tpuasr_beam_decode_batch_nbest(
            _ptr(logprobs, ctypes.c_float), _ptr(lengths, ctypes.c_int), b, t, c,
            *self._search_args(), n,
            _ptr(out_ids, ctypes.c_int), _ptr(out_frames, ctypes.c_int),
            _ptr(out_lens, ctypes.c_int), _ptr(out_scores, ctypes.c_float))
        if rc != 0:
            raise RuntimeError(f"native nbest decode failed rc={rc}")
        results = []
        for i in range(b):
            rows = []
            for j in range(n):
                ln = int(out_lens[i, j])
                if ln == 0 and out_scores[i, j] <= -1e29:
                    continue  # fewer live beams than n
                rows.append((self.alphabet.decode(out_ids[i, j, :ln]),
                             float(out_scores[i, j]),
                             out_frames[i, j, :ln].astype(np.int64)))
            results.append(rows)
        return results

    def __del__(self):
        if getattr(self, "_lm", None):
            self._lib.tpuasr_lm_free(self._lm)
