"""Batched device CTC prefix beam search with n-gram LM fusion (port of
``tpuasr/decode/beam.py``).

The search itself is K3, the hand-written Hopper kernel behind
``tpuasr_torch.ops.beam.beam_scan``: one launch decodes the whole batch
and emits per-frame backpointers (parent beam, appended char or -1 for
a stay) plus unsorted final scores. This module holds the host half,
bit-identical to the JAX package's:

  * the rolling 2x32-bit prefix/token hashes (``_np_mix32``,
    ``_np_fmix32``, ``_np_home``, ``_np_fold_tokens``) and the reserved
    token pairs;
  * the drop-free open-addressed table packer (``_pack_table`` with
    Kuhn matching and re-salted homes), ``pack_lm_tables`` (char LM) and
    ``pack_word_lm_tables`` (word LM, ctcdecode semantics);
  * the one-transfer packing of the kernel's outputs
    (``pack_decode_outputs`` on the device, ``unpack_decode_outputs`` on
    the host) and ``_backtrack``, which turns backpointers into
    best-first prefixes and per-character frame offsets;
  * ``DeviceBeamDecoder``, the decoder API (``decode``,
    ``decode_nbest``, offsets, n-best).

The kernel probes the packed ``HashedTables`` directly (the XLA path's
``_probe``: ``n_probes`` consecutive slots from the home slot), so the
JAX package's TPU-only layouts (the dense char table and the wide
block-fetch word tables) have no counterpart here; the scores are the
same numbers.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tpuasr_torch.labels import Alphabet

NEG = -1e30
OOV_LOGP = -20.0  # natural-log floor for LM-unseen characters (char mode)
# Word mode matches the host oracle: ArpaLM returns LOG10_EPS (-99
# log10) for words absent even as <unk> unigrams.
WORD_OOV_NAT = -99.0 * np.log(10.0)

# 32-bit hash mixing constants (two independent streams)
_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA77)

# Reserved token hash pairs for words that are not character sequences.
BOS_TOK = (np.uint32(0x7F4A7C15), np.uint32(0x3C6EF372))
UNK_TOK = (np.uint32(0x9E3779B9), np.uint32(0x85EBCA6B))
EOS_TOK = (np.uint32(0x27220A95), np.uint32(0x165667B1))
PAD_TOK = (np.uint32(0x50AD50AD), np.uint32(0xDEFACED1))


def _np_mix32(h, x, mult):
    with np.errstate(over="ignore"):
        h = np.uint32((np.uint32(h) ^ np.uint32(x)) * mult)
    return np.uint32(h ^ (h >> np.uint32(15)))


def _np_hash_ids(ids, mult) -> np.uint32:
    h = np.uint32(0)
    for c in ids:
        h = _np_mix32(h, np.uint32(c), mult)
    return h


def _np_fmix32(h) -> np.uint32:
    """murmur3 fmix32: full-avalanche 32-bit finalizer (salted homes)."""
    with np.errstate(over="ignore"):
        h = np.uint32(h)
        h = np.uint32(h ^ (h >> np.uint32(16)))
        h = np.uint32(h * np.uint32(0x85EBCA6B))
        h = np.uint32(h ^ (h >> np.uint32(13)))
        h = np.uint32(h * np.uint32(0xC2B2AE35))
        h = np.uint32(h ^ (h >> np.uint32(16)))
    return h


def _np_home(h1: np.uint32, cap: int, salt: int) -> int:
    """Home slot of key h1 in a cap-slot table (cap = power of two):
    h1 % cap for salt 0, else fmix32(h1 ^ salt) % cap. The kernel and
    the plain version compute the same slot."""
    if salt:
        h1 = _np_fmix32(np.uint32(h1) ^ np.uint32(salt))
    return int(np.uint32(h1) % np.uint32(cap))


def _np_fold_tokens(pairs):
    H1, H2 = np.uint32(0), np.uint32(0)
    for t1, t2 in pairs:
        H1 = _np_mix32(H1, t1, _M1)
        H2 = _np_mix32(H2, t2, _M2)
    return H1, H2


@dataclass(frozen=True)
class BeamConfig:
    beam_width: int = 10
    blank_id: int = 0
    space_id: int | None = None
    alpha: float = 0.0  # LM weight (natural log domain)
    beta: float = 0.0  # word bonus
    # ctcdecode-parity per-frame candidate pruning (host defaults):
    cutoff_top_n: int = 40
    cutoff_prob: float = 1.0
    prune_logp: float = -20.0


class HashedTables(NamedTuple):
    """Open-addressed (2x32-bit key) -> (logp, backoff) tables, one per
    n-gram order, as host numpy arrays (uint32 keys, float32 natural-log
    values); ``tpuasr_torch.ops.beam.flat_tables`` puts them on a
    device."""

    keys1: tuple  # per order: (cap,) uint32
    keys2: tuple
    logps: tuple  # per order: (cap,) float32
    backoffs: tuple
    order: int
    n_probes: int
    salts: tuple = ()  # per order home salt (0 = h1 % cap)


# ---------------------------------------------------------------------------
# Kernel outputs -> host
# ---------------------------------------------------------------------------


def pack_decode_outputs(parents: torch.Tensor, chars: torch.Tensor,
                        scores: torch.Tensor) -> torch.Tensor:
    """Fold (parents (B,T,W), chars (B,T,W), scores (B,W) f32) into ONE
    int16 tensor (B, T*W + 2W) on their device, so that the host reads
    the search with one copy: backpointers as parent*128 + char+1 (valid
    for W <= 254 and C <= 126; the caller checks), scores as raw f32
    bits in two int16 lanes (low half first)."""
    b, t, w = parents.shape
    bp = (parents.to(torch.int32) * 128 + (chars.to(torch.int32) + 1)).to(torch.int16)
    bits = scores.to(torch.float32).contiguous().view(torch.int32)

    def as_i16(u):  # 16-bit pattern in [0, 65536) -> the int16 of those bits
        return (((u & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)

    return torch.cat([bp.reshape(b, t * w), as_i16(bits), as_i16(bits >> 16)], dim=1)


def unpack_decode_outputs(raw: np.ndarray, t: int, w: int):
    """Host-side inverse of pack_decode_outputs."""
    b = raw.shape[0]
    bp = raw[:, : t * w].astype(np.int32).reshape(b, t, w)
    parents = bp >> 7
    chars = (bp & 127) - 1
    lo = raw[:, t * w: t * w + w].view(np.uint16).astype(np.uint32)
    hi = raw[:, t * w + w:].view(np.uint16).astype(np.uint32)
    scores = ((hi << 16) | lo).view(np.float32)
    return parents, chars, scores


def _packable(beam_width: int, n_class: int) -> bool:
    return beam_width <= 254 and n_class <= 126


def _backtrack(parents: np.ndarray, chars: np.ndarray, scores: np.ndarray):
    """Backpointers -> (store (B,W,T), toff (B,W,T), blen (B,W),
    scores (B,W)), beams sorted best-first per utterance.

    Walking t = T-1..0 with the (B, W) lineage cursor records, for each
    final beam, the char appended at every frame along its own history
    (-1 where it stayed); reading those in ascending t IS the prefix,
    and the frame indices ARE the per-char offsets.
    """
    b_n, t_n, w_n = chars.shape
    bidx = np.arange(b_n)[:, None]
    cur = np.broadcast_to(np.arange(w_n), (b_n, w_n)).copy()
    lineage = np.empty((b_n, t_n, w_n), np.int32)
    for t in range(t_n - 1, -1, -1):
        lineage[:, t, :] = chars[bidx, t, cur]
        cur = parents[bidx, t, cur]
    store = np.zeros((b_n, w_n, t_n), np.int32)
    toff = np.zeros((b_n, w_n, t_n), np.int32)
    blen = np.zeros((b_n, w_n), np.int32)
    order = np.argsort(-scores, axis=1)
    out_scores = np.take_along_axis(scores, order, axis=1)
    for b in range(b_n):
        for rank, w in enumerate(order[b]):
            frames = np.nonzero(lineage[b, :, w] >= 0)[0]
            n = len(frames)
            store[b, rank, :n] = lineage[b, frames, w]
            toff[b, rank, :n] = frames
            blen[b, rank] = n
    return store, toff, blen, out_scores


# ---------------------------------------------------------------------------
# Host-side table packing (drop-free: capacity grows until every entry
# places within n_probes linear probes of its home slot)
# ---------------------------------------------------------------------------


def _assign_windows(homes, cap: int, n_probes: int):
    """Place every key in SOME slot of its probe window [home, home +
    n_probes) mod cap, or return None if impossible at this capacity.

    Every lookup compares ALL n_probes window slots (no empty-slot early
    exit), so a key's position within its window is free: placement is
    bipartite matching (key -> any window slot), solved with Kuhn's
    augmenting paths — greedy first-empty insertion, and a BFS
    augmentation that re-arranges earlier keys within their own windows
    when a key finds its window full.

    Returns an int64 array: slot index per key."""
    owner = np.full(cap, -1, np.int64)       # slot -> key index
    assigned = np.full(len(homes), -1, np.int64)  # key index -> slot

    def window(k):
        h = homes[k]
        return [(h + j) % cap for j in range(n_probes)]

    for u in range(len(homes)):
        placed = False
        for s in window(u):
            if owner[s] < 0:
                owner[s], assigned[u] = u, s
                placed = True
                break
        if placed:
            continue
        # augment: BFS over alternating (key -> window slot -> owner)
        slot_from: dict = {}
        q = deque([u])
        free = None
        while q and free is None:
            k = q.popleft()
            for s in window(k):
                if s in slot_from:
                    continue
                slot_from[s] = k
                if owner[s] < 0:
                    free = s
                    break
                q.append(int(owner[s]))
        if free is None:
            return None  # no perfect matching at this capacity
        s = free
        while True:
            k = slot_from[s]
            prev = int(assigned[k])
            owner[s], assigned[k] = k, s
            if k == u:
                break
            s = prev
    return assigned


# Home-salt schedule per capacity: salt 0 (h1 % cap) first, then
# re-mixed homes; re-salting re-rolls a layout whose one dense home
# cluster defeats the window matching, where doubling would pay 2x
# table memory forever.
_PACK_SALTS = (0, 1, 2, 3, 5, 9)


def _pack_table(items, n_probes: int):
    """items: list of (h1, h2, logp_nat, bo_nat). Returns uint32 key
    arrays + float32 value arrays + the home salt used. NEVER drops an
    entry: capacity starts at load ~0.8; when ``_assign_windows`` finds
    no placement keeping every entry within ``n_probes`` linear probes
    of its home slot, the homes are re-salted through ``_PACK_SALTS``
    before capacity doubles."""
    n = max(len(items), 1)
    cap = n_probes  # a cap below n_probes would wrap the probe window
    # onto itself and the lookup's masked sum would count a hit twice
    while cap * 4 < n * 5:  # cap >= 1.25 * n  (target load 0.8)
        cap *= 2
    keys = []
    for h1, h2, l, b in items:
        if h1 == 0 and h2 == 0:
            # (0,0) marks an empty slot; nudge (lookup of this key then
            # misses — a ~2^-64 event, vs. corrupting the table)
            h2 = np.uint32(1)
        keys.append((np.uint32(h1), np.uint32(h2), l, b))
    while True:
        for salt in _PACK_SALTS:
            homes = [_np_home(h1, cap, salt) for h1, _, _, _ in keys]
            slots = _assign_windows(homes, cap, n_probes) \
                if keys else np.zeros(0, np.int64)
            if slots is not None:
                k1 = np.zeros(cap, np.uint32)
                k2 = np.zeros(cap, np.uint32)
                lp = np.full(cap, NEG, np.float32)
                bo = np.zeros(cap, np.float32)
                for (h1, h2, l, b), s in zip(keys, slots):
                    k1[s], k2[s] = h1, h2
                    lp[s], bo[s] = l, b
                return k1, k2, lp, bo, salt
        cap *= 2


def pack_lm_tables(char_lm, alphabet: Alphabet) -> HashedTables:
    """Convert a char-level ArpaLM into hash tables keyed by the SAME
    rolling 2x32-bit hashes the kernel computes over class ids."""
    if getattr(char_lm, "ngrams", None) is None:
        raise ValueError(
            "device LM fusion needs an enumerable LM (ARPA text); a "
            "KenLM probing binary stores only opaque hashes — convert "
            "to ARPA or use the host beam decoder"
        )
    import math as _math

    ln10 = _math.log(10.0)
    n_probes = 8

    def ids_of(toks):
        out = []
        for t in toks:
            if t in (" ", "<sp>"):
                out.append(alphabet.space_id)
            else:
                enc = alphabet.encode(t)
                if len(enc) != 1:
                    return None
                out.append(enc[0])
        return out

    keys1, keys2, logps, backoffs, salts = [], [], [], [], []
    for table in char_lm.ngrams:
        items = []
        for toks, (logp, b) in table.items():
            ids = ids_of(toks)
            if ids is None:
                continue  # multi-char / non-alphabet token: unreachable by the beam
            h1 = _np_hash_ids(ids, _M1)
            h2 = _np_hash_ids(ids, _M2)
            items.append((h1, h2, logp * ln10, b * ln10))
        k1, k2, lp, bo, salt = _pack_table(items, n_probes)
        keys1.append(k1)
        keys2.append(k2)
        logps.append(lp)
        backoffs.append(bo)
        salts.append(salt)
    return HashedTables(tuple(keys1), tuple(keys2), tuple(logps),
                        tuple(backoffs), char_lm.order, n_probes,
                        tuple(salts))


def word_token_hash(word: str, alphabet: Alphabet):
    """Token hash pair for a vocabulary word = the rolling char-id hash
    the beam accumulates while typing it. Reserved tokens (<s>, </s>,
    <unk>) get fixed pairs the beam can never produce."""
    if word == "<s>":
        return BOS_TOK
    if word == "</s>":
        return EOS_TOK
    if word == "<unk>":
        return UNK_TOK
    ids = alphabet.encode(word)
    if alphabet.decode(ids) != word:
        return None  # not producible by the beam (case/charset mismatch)
    return (_np_hash_ids(ids, _M1), _np_hash_ids(ids, _M2))


def pack_word_lm_tables(word_lm, alphabet: Alphabet) -> HashedTables:
    """Convert a WORD-level ArpaLM into hash tables. Each n-gram's key
    folds the token hash pairs of its words; tokens whose characters
    don't round-trip through the alphabet (the host oracle treats those
    words as OOV too) are skipped as unreachable."""
    if getattr(word_lm, "ngrams", None) is None:
        raise ValueError(
            "device LM fusion needs an enumerable LM (ARPA text); a "
            "KenLM probing binary stores only opaque hashes — convert "
            "to ARPA or use the host beam decoder"
        )
    import math as _math

    ln10 = _math.log(10.0)
    n_probes = 8
    cache: dict = {}

    def tok(wordstr):
        if wordstr not in cache:
            cache[wordstr] = word_token_hash(wordstr, alphabet)
        return cache[wordstr]

    keys1, keys2, logps, backoffs, salts = [], [], [], [], []
    for table in word_lm.ngrams:
        items = []
        for toks, (logp, b) in table.items():
            pairs = [tok(t) for t in toks]
            if any(p is None for p in pairs):
                continue
            h1, h2 = _np_fold_tokens(pairs)
            items.append((h1, h2, logp * ln10, b * ln10))
        k1, k2, lp, bo, salt = _pack_table(items, n_probes)
        keys1.append(k1)
        keys2.append(k2)
        logps.append(lp)
        backoffs.append(bo)
        salts.append(salt)
    return HashedTables(tuple(keys1), tuple(keys2), tuple(logps),
                        tuple(backoffs), word_lm.order, n_probes,
                        tuple(salts))


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


class DeviceBeamDecoder:
    """Batched device beam decoder with the framework decoder API plus
    ctcdecode-parity features: word- OR char-level LM fusion, cutoff
    pruning, n-best, per-char frame offsets. Logits on a CUDA device
    decode through K3 at any beam width, class count and LM order (a K3
    launch that fails raises); logits on the CPU (or numpy) through its
    plain PyTorch version."""

    def __init__(self, alphabet: Alphabet, beam_width: int = 10,
                 char_lm=None, word_lm=None, alpha: float = 0.0,
                 beta: float = 0.0, cutoff_top_n: int = 40,
                 cutoff_prob: float = 1.0, prune_logp: float = -20.0,
                 impl: str = "auto"):
        if char_lm is not None and word_lm is not None:
            raise ValueError("pass char_lm or word_lm, not both")
        if impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"impl must be auto|pallas|xla, got {impl!r}")
        if beam_width < 1:
            raise ValueError(f"beam_width must be positive, got {beam_width}")
        # ``impl`` is accepted for compatibility with tpuasr: the port
        # runs K3 whatever it says
        self.alphabet = alphabet
        # raw LM objects kept for the host long-form path
        self.char_lm = char_lm
        self.word_lm = word_lm
        self._lm_tables = (
            pack_lm_tables(char_lm, alphabet) if char_lm is not None else None
        )
        self._word_tables = (
            pack_word_lm_tables(word_lm, alphabet)
            if word_lm is not None else None
        )
        self.cfg = BeamConfig(
            beam_width=beam_width,
            blank_id=alphabet.blank_id,
            space_id=alphabet.space_id,
            alpha=alpha,
            beta=beta,
            cutoff_top_n=cutoff_top_n,
            cutoff_prob=cutoff_prob,
            prune_logp=prune_logp,
        )
        self._flat: dict = {}  # device -> flat tables on that device

    def kernel_lm_kwargs(self, n_class: int, device="cpu") -> dict:
        """LM kwargs for ``tpuasr_torch.ops.beam.beam_scan``: how this
        decoder's LM rides in K3, with its tables on ``device``. Char
        fusion is off when alpha is 0 (the JAX package's rule, beta
        included); word fusion needs the alphabet's space."""
        from tpuasr_torch.ops.beam import flat_tables

        device = torch.device(device)
        if self._lm_tables is not None and self.cfg.alpha != 0.0:
            if device not in self._flat:
                self._flat[device] = flat_tables(self._lm_tables, device)
            return dict(char_tables=self._flat[device], alpha=self.cfg.alpha,
                        beta=self.cfg.beta, space_id=self.cfg.space_id)
        if self._word_tables is not None and self.cfg.space_id is not None:
            if device not in self._flat:
                self._flat[device] = flat_tables(self._word_tables, device)
            return dict(word_tables=self._flat[device], alpha=self.cfg.alpha,
                        beta=self.cfg.beta, space_id=self.cfg.space_id)
        return {}

    def logprobs(self, logits, lengths):
        """(B, T, C) logits (tensor or array) -> f32 log-probabilities
        and int32 lengths on the logits' device."""
        logits = torch.as_tensor(logits)
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1).contiguous()
        lengths = torch.as_tensor(lengths, device=lp.device).to(torch.int32).contiguous()
        return lp, lengths

    def search(self, logprobs, lengths):
        """The beam over a batch: (parents, chars, scores) on the device
        (``ops.beam.beam_scan``)."""
        from tpuasr_torch.ops.beam import beam_scan

        return beam_scan(
            logprobs, lengths, beam_width=self.cfg.beam_width,
            blank_id=self.cfg.blank_id, cutoff_top_n=self.cfg.cutoff_top_n,
            cutoff_prob=self.cfg.cutoff_prob, prune_logp=self.cfg.prune_logp,
            **self.kernel_lm_kwargs(logprobs.shape[2], logprobs.device))

    @staticmethod
    def to_host(parents, chars, scores, n_class: int):
        """The search's outputs as host numpy arrays, in one copy when
        the backpointers pack into int16."""
        t, w = parents.shape[1], parents.shape[2]
        if _packable(w, n_class):
            raw = pack_decode_outputs(parents, chars, scores).cpu().numpy()
            return unpack_decode_outputs(raw, t, w)
        return (parents.to(torch.int32).cpu().numpy(), chars.to(torch.int32).cpu().numpy(),
                scores.cpu().numpy())

    def _run(self, logits, lengths):
        lp, lengths = self.logprobs(logits, lengths)
        return _backtrack(*self.to_host(*self.search(lp, lengths), lp.shape[2]))

    def readout(self, store_row, toff_row, n):
        """Backtracked id/frame rows -> (stripped text, aligned
        offsets); the host half of any kernel readout."""
        raw = self.alphabet.decode(store_row[:n])
        frames = toff_row[:n]
        lead = len(raw) - len(raw.lstrip())
        kept = len(raw.strip())
        return raw.strip(), frames[lead:lead + kept]

    def decode(self, logits, lengths, return_offsets: bool = False):
        store, toff, blen, _ = self._run(logits, lengths)
        texts, offsets = [], []
        for b in range(store.shape[0]):
            text, offs = self.readout(store[b, 0], toff[b, 0], blen[b, 0])
            texts.append(text)
            offsets.append(offs)
        if return_offsets:
            return texts, offsets
        return texts

    def decode_nbest(self, logits, lengths, n_best: int | None = None):
        """Per utterance: [(text, score, offsets)] best-first, deduped
        (identical texts merge, keeping the best score)."""
        store, toff, blen, scores = self._run(logits, lengths)
        n_best = n_best or self.cfg.beam_width
        out = []
        for b in range(store.shape[0]):
            rows, seen = [], set()
            for w in range(store.shape[1]):
                if len(rows) >= n_best:
                    break
                text, offs = self.readout(store[b, w], toff[b, w], blen[b, w])
                if text in seen:
                    continue
                seen.add(text)
                rows.append((text, float(scores[b, w]), offs))
            out.append(rows)
        return out
