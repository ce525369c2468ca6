"""Host CTC prefix beam search with n-gram LM shallow fusion (a copy of
``tpuasr/decode/beam_host.py``; the batch decoder's log-softmax runs in
torch).

Reference parity: the ctcdecode C++ extension (parlance) the reference
wraps as ``BeamCTCDecoder`` (ref:decoder.py; SURVEY.md §3.2) — CTC
prefix beam search (Hannun et al. 2014) over per-frame posteriors with
word-level KenLM fusion: score = log P_ctc + alpha*log P_lm + beta*|words|,
LM applied as each word completes (space emitted) and once at the end.

This pure-Python implementation is the correctness oracle for the
device decoder (tpuasr_torch.decode.beam) and the long-form decoder.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

import torch

from tpuasr_torch.decode.lm import ArpaLM, BOS
from tpuasr_torch.labels import Alphabet

LOG0 = -1e30
LN10 = math.log(10.0)


def _lse(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= LOG0 / 2:
        return a
    return a + math.log1p(math.exp(b - a))


def prefix_beam_search(
    logprobs: np.ndarray,
    alphabet: Alphabet,
    beam_width: int = 10,
    lm: ArpaLM | None = None,
    alpha: float = 0.8,
    beta: float = 1.0,
    cutoff_top_n: int = 40,
    cutoff_prob: float = 1.0,
    prune_logp: float = -20.0,
) -> list[tuple[str, float]]:
    """Decode one utterance.

    Args:
      logprobs: (T, C) natural-log posteriors (log_softmax of logits).
      alphabet: label mapping; blank = alphabet.blank_id; word
        delimiter = space.
      lm: optional word ArpaLM for shallow fusion.
    Returns:
      beams as (text, total_score) sorted best-first.
    """
    beams = beam_init()
    for t in range(logprobs.shape[0]):
        beams = beam_step(beams, logprobs[t], alphabet, beam_width, lm,
                          alpha, beta, cutoff_top_n, cutoff_prob,
                          prune_logp, t=t)
    return beam_results(beams, alphabet, lm, alpha, beta)


def beam_init() -> dict:
    """Fresh beam state: prefix tuple -> [log_pb, log_pnb, lm_score,
    n_words, frames]. ``frames`` is a tuple of each prefix char's
    emission frame (the dominant alignment's — see beam_step). The
    state is a plain dict so callers (the streaming transcriber) can
    carry it across logit chunks."""
    return {(): [0.0, LOG0, 0.0, 0, ()]}


def beam_step(beams: dict, lp: np.ndarray, alphabet: Alphabet,
              beam_width: int, lm: ArpaLM | None = None,
              alpha: float = 0.8, beta: float = 1.0,
              cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
              prune_logp: float = -20.0, t: int = -1) -> dict:
    """Advance the beam state by ONE frame of (C,) log-posteriors.

    ``t`` is the absolute frame index recorded as newly-emitted chars'
    emission frame. When a stay (blank/repeat) and an extension merge
    into the same prefix, the DOMINANT contributor (extension mass
    strictly above the stay mass) donates the frames — identical to
    the device kernel's stay<->extend absorption rule and the C++
    decoder, so offsets agree across all three implementations."""
    blank = alphabet.blank_id
    space = alphabet.space_id
    n_class = lp.shape[0]
    # candidate chars: top-n / cumulative cutoff pruning (ctcdecode's
    # cutoff_top_n / cutoff_prob)
    order = np.argsort(-lp)
    if cutoff_prob < 1.0:
        cum = np.cumsum(np.exp(lp[order]))
        keep = int(np.searchsorted(cum, cutoff_prob) + 1)
    else:
        keep = n_class
    cand = [c for c in order[: min(keep, cutoff_top_n)]
            if lp[c] > prune_logp or c == blank]

    nxt: dict = defaultdict(lambda: [LOG0, LOG0, 0.0, 0, ()])
    # per-frame scratch for the dominant-alignment frames rule: mass
    # arriving with the prefix unchanged vs via extension (parent + c);
    # each has a unique source, so plain assignment of frames is safe.
    stay_acc: dict = defaultdict(lambda: LOG0)
    ext_acc: dict = defaultdict(lambda: LOG0)
    stay_frames: dict = {}
    ext_frames: dict = {}

    for prefix, (pb, pnb, lms, nw, frames) in beams.items():
        p_tot = _lse(pb, pnb)
        last = prefix[-1] if prefix else None

        for c in cand:
            lpc = float(lp[c])
            if c == blank:
                e = nxt[prefix]
                e[0] = _lse(e[0], p_tot + lpc)
                e[2], e[3] = lms, nw
                stay_acc[prefix] = _lse(stay_acc[prefix], p_tot + lpc)
                stay_frames[prefix] = frames
                continue
            if c == last:
                # repeat without blank: stays same prefix
                e = nxt[prefix]
                e[1] = _lse(e[1], pnb + lpc)
                e[2], e[3] = lms, nw
                stay_acc[prefix] = _lse(stay_acc[prefix], pnb + lpc)
                stay_frames[prefix] = frames
                # with blank in between: extends
                contrib = pb + lpc
            else:
                contrib = p_tot + lpc
            new_prefix = prefix + (c,)
            lms_new, nw_new = lms, nw
            if lm is not None and c == space:
                word = _last_word(prefix, alphabet, space)
                if word:
                    ctx = _context(prefix, alphabet, space)
                    lms_new = lms + alpha * LN10 * lm.score_word(ctx, word) + beta
                    nw_new = nw + 1
            e = nxt[new_prefix]
            e[1] = _lse(e[1], contrib)
            e[2], e[3] = lms_new, nw_new
            ext_acc[new_prefix] = _lse(ext_acc[new_prefix], contrib)
            if new_prefix not in ext_frames:  # unique (parent, c) source
                ext_frames[new_prefix] = frames + (t,)

    # resolve merged candidates' frames (dominant contributor wins)
    for p, e in nxt.items():
        ef = ext_frames.get(p)
        sf = stay_frames.get(p)
        if ef is not None and (sf is None or ext_acc[p] > stay_acc[p]):
            e[4] = ef
        else:
            e[4] = sf if sf is not None else ()

    # keep top beams by ctc + lm score
    scored = sorted(
        nxt.items(),
        key=lambda kv: -(_lse(kv[1][0], kv[1][1]) + kv[1][2]),
    )
    return dict(scored[:beam_width])


def beam_results(beams: dict, alphabet: Alphabet,
                 lm: ArpaLM | None = None, alpha: float = 0.8,
                 beta: float = 1.0,
                 with_offsets: bool = False) -> list[tuple]:
    """Finalize a beam state: close partial words against the LM
    (ctcdecode finish_decoding) and return (text, score) best-first —
    or (text, score, frames) with ``with_offsets`` (each char's
    emission frame, ctcdecode's "timesteps")."""
    space = alphabet.space_id
    results = []
    for prefix, (pb, pnb, lms, nw, frames) in beams.items():
        total = _lse(pb, pnb) + lms
        if lm is not None:
            word = _last_word(prefix, alphabet, space)
            if word:
                ctx = _context(prefix + (space,), alphabet, space)
                total += alpha * LN10 * lm.score_word(ctx, word) + beta
        if with_offsets:
            results.append((alphabet.decode(prefix), total,
                            np.asarray(frames, np.int64)))
        else:
            results.append((alphabet.decode(prefix), total))
    results.sort(key=lambda x: -x[1])
    return results


def _last_word(prefix: tuple, alphabet: Alphabet, space: int) -> str:
    """Characters since the previous space (the word just completed)."""
    chars = []
    for c in reversed(prefix):
        if c == space:
            break
        chars.append(c)
    return alphabet.decode(reversed(chars))


def _context(prefix: tuple, alphabet: Alphabet, space: int) -> tuple:
    """Completed words before the word being closed, BOS-prefixed."""
    text = alphabet.decode(prefix).strip()
    words = text.split()
    return (BOS,) + tuple(words[:-1]) if words else (BOS,)


def _log_softmax(logits) -> np.ndarray:
    """(B, T, C) logits (tensor on any device, or array) -> host f32
    log-probabilities."""
    lg = torch.as_tensor(logits).float()
    return torch.log_softmax(lg, dim=-1).cpu().numpy()


class BeamCTCDecoder:
    """Reference-API beam decoder (ref:decoder.py BeamCTCDecoder):
    wraps prefix_beam_search over a batch of logits."""

    def __init__(
        self,
        alphabet: Alphabet,
        lm_path: str | None = None,
        alpha: float = 0.8,
        beta: float = 1.0,
        beam_width: int = 10,
        cutoff_top_n: int = 40,
        cutoff_prob: float = 1.0,
        num_processes: int = 1,
    ):
        from tpuasr_torch.decode.lm import load_lm

        self.alphabet = alphabet
        self.lm = load_lm(lm_path) if lm_path else None  # ARPA or KenLM binary
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob

    def decode(self, logits, lengths, return_offsets: bool = False):
        logprobs = _log_softmax(logits)
        lengths = np.asarray(lengths)
        texts, offsets = [], []
        for b in range(logprobs.shape[0]):
            beams = beam_init()
            for t in range(int(lengths[b])):
                beams = beam_step(beams, logprobs[b, t], self.alphabet,
                                  self.beam_width, self.lm, self.alpha,
                                  self.beta, self.cutoff_top_n,
                                  self.cutoff_prob, t=t)
            res = beam_results(beams, self.alphabet, self.lm, self.alpha,
                               self.beta, with_offsets=True)
            text, _, frames = res[0] if res else ("", 0.0,
                                                  np.array([], np.int64))
            # .strip() parity: drop the stripped chars' offsets too
            lpad = len(text) - len(text.lstrip())
            rpad = len(text) - len(text.rstrip())
            texts.append(text.strip())
            offsets.append(frames[lpad: len(frames) - rpad]
                           if rpad else frames[lpad:])
        if return_offsets:
            return texts, offsets
        return texts

    def decode_nbest(self, logits, lengths, n_best: int | None = None):
        """Per utterance: [(text, score, offsets)] best-first — every
        live beam (ctcdecode's full output; mirrors the native and
        device decoders' decode_nbest)."""
        n = n_best or self.beam_width
        logprobs = _log_softmax(logits)
        lengths = np.asarray(lengths)
        results = []
        for b in range(logprobs.shape[0]):
            beams = beam_init()
            for t in range(int(lengths[b])):
                beams = beam_step(beams, logprobs[b, t], self.alphabet,
                                  self.beam_width, self.lm, self.alpha,
                                  self.beta, self.cutoff_top_n,
                                  self.cutoff_prob, t=t)
            res = beam_results(beams, self.alphabet, self.lm, self.alpha,
                               self.beta, with_offsets=True)
            results.append(res[:n])
        return results
