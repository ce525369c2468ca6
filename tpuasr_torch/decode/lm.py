"""n-gram language models: ARPA IO, host scoring, and training (a copy
of ``tpuasr/decode/lm.py``, pure numpy; the port keeps its own because
importing any ``tpuasr`` module loads JAX).

Reference parity: the reference links KenLM (C++, ~25 kLoC) into
ctcdecode for word-level n-gram shallow fusion during beam search
(SURVEY.md §3.2). KenLM itself is an external artifact factory (ARPA /
binary LMs); this module replaces the pieces the framework actually
needs:

  * ``ArpaLM.load`` — read the standard ARPA text format (what KenLM
    consumes/produces) into backoff tables.
  * ``ArpaLM.score_word`` / ``score_sequence`` — Katz-backoff scoring
    (log10, ARPA convention) on host, used by the host beam decoder
    and as the oracle for the device LM.
  * ``train_ngram`` — build an interpolated modified-add-k backoff LM
    from a text corpus and write ARPA, replacing the external
    ``lmplz`` step (this environment has no KenLM and no network, and
    a PT-BR user needs *some* way to get an LM).
  * ``HashedNGramLM`` — open-addressed hash tables of (context-hash,
    word-id) -> (logp, backoff) as flat arrays, with a host probe.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

LOG10_EPS = -99.0  # ARPA convention for "impossible"

UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"


class ArpaLM:
    """Word (or char) n-gram backoff LM in ARPA log10 convention.

    ``ngrams[k]`` maps a k+1-tuple of tokens -> (logp, backoff_logp).
    """

    def __init__(self, ngrams: list[dict], order: int):
        self.ngrams = ngrams
        self.order = order
        self.vocab = {w[0] for w in ngrams[0]}

    # ---------- IO ----------

    @classmethod
    def load(cls, path: str) -> "ArpaLM":
        ngrams: list[dict] = []
        order = 0
        cur = -1
        with open(path, "r", encoding="utf-8") as f:
            section = None
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = "data"
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    cur = int(line[1:].split("-")[0]) - 1
                    while len(ngrams) <= cur:
                        ngrams.append({})
                    section = "grams"
                    continue
                if line == "\\end\\":
                    break
                if section == "data":
                    if line.startswith("ngram"):
                        order = max(order, int(line.split()[1].split("=")[0]))
                    continue
                if section == "grams" and cur >= 0:
                    parts = line.split("\t")
                    if len(parts) == 1:
                        parts = line.split()
                        logp = float(parts[0])
                        toks = tuple(parts[1:])
                        bo = 0.0
                    else:
                        logp = float(parts[0])
                        toks = tuple(parts[1].split())
                        bo = float(parts[2]) if len(parts) > 2 else 0.0
                    ngrams[cur][toks] = (logp, bo)
        return cls(ngrams, order)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for k, table in enumerate(self.ngrams):
                f.write(f"ngram {k + 1}={len(table)}\n")
            f.write("\n")
            for k, table in enumerate(self.ngrams):
                f.write(f"\\{k + 1}-grams:\n")
                for toks, (logp, bo) in table.items():
                    tail = f"\t{bo:.6f}" if (k + 1 < self.order and bo != 0.0) else ""
                    f.write(f"{logp:.6f}\t{' '.join(toks)}{tail}\n")
                f.write("\n")
            f.write("\\end\\\n")

    # ---------- scoring ----------

    def score_word(self, context: tuple, word: str) -> float:
        """log10 P(word | context) with Katz backoff."""
        if word not in self.vocab:
            word = UNK
        context = tuple(
            t if t in self.vocab or t in (BOS,) else UNK for t in context
        )
        context = context[-(self.order - 1):] if self.order > 1 else ()
        while True:
            key = context + (word,)
            table = self.ngrams[len(key) - 1] if len(key) <= self.order else None
            if table is not None and key in table:
                return table[key][0]
            if not context:
                return self.ngrams[0].get((word,), (LOG10_EPS, 0.0))[0]
            bo_key = context
            bo_table = self.ngrams[len(bo_key) - 1]
            bo = bo_table.get(bo_key, (0.0, 0.0))[1]
            context = context[1:]
            if bo != 0.0:
                return bo + self._score_suffix(context, word)

    def _score_suffix(self, context: tuple, word: str) -> float:
        while True:
            key = context + (word,)
            if key in self.ngrams[len(key) - 1]:
                return self.ngrams[len(key) - 1][key][0]
            if not context:
                return self.ngrams[0].get((word,), (LOG10_EPS, 0.0))[0]
            bo = self.ngrams[len(context) - 1].get(context, (0.0, 0.0))[1]
            context = context[1:]
            if bo != 0.0:
                return bo + self._score_suffix(context, word)

    def score_sequence(self, words: list[str], bos: bool = True) -> float:
        """Sum of log10 conditional probabilities."""
        context: tuple = (BOS,) if bos else ()
        total = 0.0
        for w in words:
            total += self.score_word(context, w)
            context = (context + (w,))[-(self.order - 1):] if self.order > 1 else ()
        return total


def load_lm(path: str) -> "ArpaLM":
    """Load an n-gram LM from ARPA text or KenLM binary format
    (detected by the KenLM mmap magic — reference users pass
    ``lm.binary`` artifacts built by KenLM's build_binary)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"mmap lm"):
        from tpuasr_torch.decode.lm_binary import load_kenlm_binary

        return load_kenlm_binary(path)
    return ArpaLM.load(path)


def train_ngram(
    corpus_lines: list[str],
    order: int = 3,
    add_k: float = 0.01,
    min_count: int = 1,
) -> ArpaLM:
    """Build a PROPERLY NORMALIZED backoff n-gram LM from tokenized
    lines (words split on whitespace) — the in-framework replacement
    for KenLM's lmplz (this environment has no KenLM and no network).

    Construction: add-k conditionals at each order over the seen
    n-grams (every vocab word gets an explicit unigram, so the unigram
    row sums to exactly 1), then exact Katz backoff weights computed
    bottom-up:

        bo(h) = (1 - sum_seen p(w|h)) / (1 - sum_seen P(w|h'))

    which makes sum_w P(w|h) = 1 for EVERY context (tested), instead of
    the round-1 leftover-mass approximation.
    """
    counts = [defaultdict(int) for _ in range(order)]
    for line in corpus_lines:
        toks = [BOS] + line.split() + [EOS]
        for k in range(1, order + 1):
            for i in range(len(toks) - k + 1):
                if k == 1 and toks[i] == BOS:
                    continue
                counts[k - 1][tuple(toks[i : i + k])] += 1

    vocab = {t for (t,), c in counts[0].items() if c >= min_count}
    vocab.add(UNK)
    vocab.add(EOS)

    def norm_tok(t):
        return t if (t in vocab or t == BOS) else UNK

    # re-accumulate with UNK mapping
    counts = [defaultdict(int) for _ in range(order)]
    ctx_totals = [defaultdict(int) for _ in range(order)]
    for line in corpus_lines:
        toks = [BOS] + [norm_tok(w) for w in line.split()] + [EOS]
        for k in range(1, order + 1):
            for i in range(len(toks) - k + 1):
                if k == 1 and toks[i] == BOS:
                    continue
                key = tuple(toks[i : i + k])
                counts[k - 1][key] += 1
                ctx_totals[k - 1][key[:-1]] += 1

    v_size = len(vocab)
    ngrams: list[dict] = [dict() for _ in range(order)]
    # unigrams: explicit entry for EVERY vocab word -> the unigram row
    # sums to exactly 1 (unseen words, e.g. <unk>, get the add-k floor)
    n_total = sum(counts[0].values())
    for w in sorted(vocab):
        c = counts[0].get((w,), 0)
        p = (c + add_k) / (n_total + add_k * v_size)
        ngrams[0][(w,)] = (math.log10(p), 0.0)
    for k in range(1, order):
        for key, c in counts[k].items():
            denom = ctx_totals[k][key[:-1]] + add_k * v_size
            p = (c + add_k) / denom
            ngrams[k][key] = (math.log10(p), 0.0)

    # exact Katz backoff weights, bottom-up over context lengths so
    # each level's denominator scores through already-final lower levels
    lm = ArpaLM(ngrams, order)
    for m in range(1, order):  # context length
        by_ctx: dict = defaultdict(list)
        for key in ngrams[m]:
            by_ctx[key[:-1]].append(key[-1])
        for ctx in sorted(by_ctx):
            seen = by_ctx[ctx]
            num = 1.0 - sum(10 ** ngrams[m][ctx + (w,)][0] for w in seen)
            den = 1.0 - sum(10 ** lm.score_word(ctx[1:], w) for w in seen)
            bo = max(num, 1e-9) / max(den, 1e-9)
            if ctx in ngrams[m - 1]:
                logp, _ = ngrams[m - 1][ctx]
            else:  # context never an outcome itself, e.g. (<s>,)
                logp = LOG10_EPS
            ngrams[m - 1][ctx] = (logp, math.log10(bo))
    return lm


# ---------- device-resident hashed representation ----------

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def _mix(h: np.ndarray | int, x: np.ndarray | int):
    """64-bit splitmix-style hash combine (numpy uint64, overflow ok)."""
    with np.errstate(over="ignore"):
        h = (np.uint64(h) ^ np.uint64(x)) * _HASH_MULT
    h = h ^ (h >> np.uint64(29))
    return h


def token_hash(token: str) -> np.uint64:
    h = np.uint64(1469598103934665603)
    for ch in token.encode("utf-8"):
        h = _mix(h, ch)
    return h


def context_hash(tokens: tuple) -> np.uint64:
    h = np.uint64(0)
    for t in tokens:
        h = _mix(h, token_hash(t))
    return h


@dataclass
class HashedNGramLM:
    """Flat open-addressed hash tables for device gather-based lookup.

    keys:    (capacity,) uint64 (0 = empty)
    logps:   (capacity,) float32  (natural log, pre-scaled from log10)
    backoffs:(capacity,) float32
    One table per order; probing is linear with ``n_probes`` steps.
    """

    keys: list
    logps: list
    backoffs: list
    order: int
    n_probes: int = 8

    @classmethod
    def build(cls, lm: ArpaLM, load_factor: float = 0.5) -> "HashedNGramLM":
        keys, logps, backoffs = [], [], []
        ln10 = math.log(10.0)
        for k, table in enumerate(lm.ngrams):
            n = max(len(table), 1)
            cap = 1 << int(math.ceil(math.log2(n / load_factor + 1)))
            K = np.zeros(cap, np.uint64)
            P = np.full(cap, -30.0, np.float32)
            B = np.zeros(cap, np.float32)
            for toks, (logp, bo) in table.items():
                h = context_hash(toks)
                if h == 0:
                    h = np.uint64(1)
                slot = int(h % np.uint64(cap))
                while K[slot] != 0:
                    slot = (slot + 1) % cap
                K[slot] = h
                P[slot] = logp * ln10
                B[slot] = bo * ln10
            keys.append(K)
            logps.append(P)
            backoffs.append(B)
        return cls(keys, logps, backoffs, lm.order)

    def lookup_np(self, toks: tuple):
        """Host-side probe (oracle for the device kernel):
        returns (found, logp_e, backoff_e)."""
        k = len(toks) - 1
        h = context_hash(toks)
        if h == 0:
            h = np.uint64(1)
        cap = len(self.keys[k])
        slot = int(h % np.uint64(cap))
        for _ in range(cap):
            if self.keys[k][slot] == h:
                return True, float(self.logps[k][slot]), float(self.backoffs[k][slot])
            if self.keys[k][slot] == 0:
                return False, 0.0, 0.0
            slot = (slot + 1) % cap
        return False, 0.0, 0.0
