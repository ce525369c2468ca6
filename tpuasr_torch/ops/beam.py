"""Fused CTC prefix beam search, K3 (port of ``tpuasr/ops/beam.py``).

``beam_scan`` wraps the hand-written Hopper kernel ``csrc/beam.cu``,
which replaces ``tpuasr/ops/beam.py:_beam_kernel`` and the XLA search
that ``tpuasr`` falls back to past its limits: one launch decodes a
whole batch, a thread block per utterance running the time loop with
the beam state in shared memory. ``beam_scan_reference`` is its plain
PyTorch version with the same arithmetic, vectorised over the batch,
one frame per iteration. The wrapper runs the plain version only for
CPU tensors; on a CUDA tensor it launches the kernel or raises.

Per frame, in the TPU kernel's order: rank-form cutoff pruning
(``cutoff_top_n``; ``cutoff_prob`` as the exclusive better-ranked mass;
the ``prune_logp`` floor, which the blank is exempt from), stay
candidates, extend candidates in the pool layout stays (W) then extends
(W*C, parent-major), exact stay<->extend absorption by the two 32-bit
prefix hashes (K3 finds each stay's one match through its parent's
hash: the same pairs, but for a 64-bit collision) with the
representative swap (the strongest absorbed extend, lowest flat index
among equal maxima, takes the backpointer when it outweighs the stay),
then top-W by W rounds of (max, lowest index, mask to -3e38; K3 finds
the same W in the same order by a radix select). Frames at or past an
utterance's length keep its state and emit identity backpointers.

LM fusion probes the packed ``HashedTables`` (``flat_tables``): the
char LM by the XLA path's ``_char_lm_scores`` recursion over the last
order - 1 classes of each beam, the word LM by ``_word_lm_score`` with
the per-beam partial-word hash, completed-word ring and length. Both
carry the char context as the class ids of each beam's last
max(1, order - 1) chars, oldest first, as the XLA search does. Stateful
mode (``state=`` / ``return_state=True``) carries the beam state in and
out in ``_state_dtypes`` order, so chunked calls equal one call over the
concatenation; the returned scores include the word LM's final close,
which the carried state does not.

Both take any beam width, class count and LM order. Backpointers are
int8 when W <= 127 and C <= 126, else int32. K3 keeps the arrays that
grow with W x C in shared memory when they fit beside the beam state,
else in a global workspace the wrapper allocates (``_k3_plan``; the beam
state too when it does not fit).

Hash arithmetic: torch's uint32 has almost no arithmetic, so the plain
version computes in int64 and masks to 32 bits after every product
(each product split in 16-bit halves, so nothing overflows).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpuasr_torch.decode.beam import (
    BOS_TOK,
    NEG,
    OOV_LOGP,
    PAD_TOK,
    UNK_TOK,
    WORD_OOV_NAT,
    HashedTables,
    _M1,
    _M2,
)
from tpuasr_torch.ops import _build

PICKED = -3.0e38  # below NEG: a picked candidate never ties a live one

_MASK = 0xFFFFFFFF
_MODES = {"none": 0, "char": 1, "word": 2}


# ---------------------------------------------------------------- hashing

def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for int64 a in [0, 2**32), without overflow."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _MASK


def _mix32(h, x, mult) -> torch.Tensor:
    h = _mul32(h ^ x, int(mult))
    return h ^ (h >> 15)


def _fmix32(h) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _lse(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG)
    return torch.clamp(m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe)), min=NEG)


# ----------------------------------------------------------------- tables

class FlatTables(NamedTuple):
    """``HashedTables`` on one device, all orders concatenated: keys as
    int32 bit patterns, values f32; ``meta`` holds (offset, cap, salt)
    per order as Python ints, ``meta_rows`` the same as an (order, 3)
    int32 tensor on the device (salts as their bit patterns), which K3
    reads."""

    keys1: torch.Tensor
    keys2: torch.Tensor
    logps: torch.Tensor
    backoffs: torch.Tensor
    meta: tuple
    meta_rows: torch.Tensor
    order: int
    n_probes: int


def flat_tables(tables: HashedTables, device) -> FlatTables:
    caps = [len(k) for k in tables.keys1]
    for cap in caps:
        if cap & (cap - 1) or cap < tables.n_probes:
            raise ValueError(f"table cap {cap} must be a power of two >= n_probes")
    offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(int).tolist()
    salts = list(tables.salts) or [0] * tables.order

    def keys(arrs):  # uint32 -> int32 bit patterns
        return torch.from_numpy(np.concatenate(
            [np.asarray(a, np.uint32) for a in arrs]).view(np.int32)).to(device)

    def vals(arrs):
        return torch.from_numpy(np.concatenate(
            [np.asarray(a, np.float32) for a in arrs])).to(device)

    meta = tuple((o, c, int(s)) for o, c, s in zip(offs, caps, salts))
    rows = np.array([[o, c, s & _MASK] for o, c, s in meta], np.int64).reshape(-1, 3)
    return FlatTables(keys(tables.keys1), keys(tables.keys2), vals(tables.logps),
                      vals(tables.backoffs), meta,
                      torch.from_numpy(rows.astype(np.uint32).view(np.int32)).to(device),
                      int(tables.order), int(tables.n_probes))


def _probe(tab: FlatTables, k: int, q1, q2):
    """Order-k lookup of int64 key pairs (any shape): (found, logp or
    NEG, backoff), from the ``n_probes`` consecutive slots at the home
    slot; a hit needs both keys equal and the slot not empty (0, 0)."""
    off, cap, salt = tab.meta[k]
    h = _fmix32(q1 ^ salt) if salt else q1
    slot = h & (cap - 1)
    probes = torch.arange(tab.n_probes, device=q1.device)
    idx = off + (slot[..., None] + probes) % cap
    k1 = tab.keys1[idx].to(torch.int64) & _MASK
    k2 = tab.keys2[idx].to(torch.int64) & _MASK
    hit = (k1 == q1[..., None]) & (k2 == q2[..., None]) & ((k1 != 0) | (k2 != 0))
    found = hit.any(-1)
    val = torch.where(found, torch.where(hit, tab.logps[idx], 0.0).sum(-1), NEG)
    bo = torch.where(hit, tab.backoffs[idx], 0.0).sum(-1)
    return found, val, bo


def _fold(pairs, like):
    h1 = torch.zeros_like(like)
    h2 = torch.zeros_like(like)
    for t1, t2 in pairs:
        h1 = _mix32(h1, t1, _M1)
        h2 = _mix32(h2, t2, _M2)
    return h1, h2


def _word_lm_score(wt: FlatTables, wh1, wh2, wc1s, wc2s):
    """Natural-log P(word | word context) per beam with Katz backoff
    (OOV -> <unk>; the -99 log10 floor), and the effective token hash
    pair that enters the context ring — the XLA path's
    ``_word_lm_score``."""
    ring = len(wc1s)
    uf, _, _ = _probe(wt, 0, *_fold([(wh1, wh2)], wh1))
    eff1 = torch.where(uf, wh1, int(UNK_TOK[0]))
    eff2 = torch.where(uf, wh2, int(UNK_TOK[1]))
    score = torch.zeros(wh1.shape, dtype=torch.float32, device=wh1.device)
    resolved = torch.zeros(wh1.shape, dtype=torch.bool, device=wh1.device)
    bo_acc = torch.zeros_like(score)
    for m in range(min(wt.order - 1, ring), -1, -1):
        ctx_pairs = [(wc1s[ring - m + i], wc2s[ring - m + i]) for i in range(m)]
        f, v, _ = _probe(wt, m, *_fold(ctx_pairs + [(eff1, eff2)], wh1))
        score = torch.where(f & ~resolved, bo_acc + v, score)
        resolved = resolved | f
        if m > 0:
            bf, _, bbo = _probe(wt, m - 1, *_fold(ctx_pairs, wh1))
            bo_acc = torch.where(resolved, bo_acc, bo_acc + torch.where(bf, bbo, 0.0))
    oov = torch.tensor(WORD_OOV_NAT, dtype=torch.float32, device=wh1.device)
    return torch.where(resolved, score, bo_acc + oov), eff1, eff2


def _char_lm_scores(ct: FlatTables, ctx, c_num: int):
    """(B, W, C) natural-log P(c | context) with the full Katz backoff
    chain — the XLA path's ``_char_lm_scores``; ``ctx`` (B, W, k) holds
    the last k = max(1, order-1) chars of each beam, oldest first."""
    k_ctx = ctx.shape[-1]
    chars = ctx.unbind(-1)
    cls = torch.arange(c_num, dtype=torch.int64, device=ctx.device)
    score = torch.full(chars[0].shape + (c_num,), NEG, dtype=torch.float32, device=ctx.device)
    resolved = torch.zeros(score.shape, dtype=torch.bool, device=ctx.device)
    bo_acc = torch.zeros_like(score)
    for m in range(ct.order - 1, -1, -1):
        h1, h2 = _fold([(x, x) for x in chars[k_ctx - m:]] if m else [], chars[0])
        found, val, _ = _probe(ct, m, _mix32(h1[..., None], cls, _M1),
                               _mix32(h2[..., None], cls, _M2))
        score = torch.where(found & ~resolved, bo_acc + val, score)
        resolved = resolved | found
        if m > 0:
            bfound, _, bbo = _probe(ct, m - 1, h1[..., None], h2[..., None])
            bo_acc = torch.where(resolved, bo_acc, bo_acc + torch.where(bfound, bbo, 0.0))
    return torch.where(resolved, score, OOV_LOGP)


# ------------------------------------------------------------------ state

def _state_dtypes(lm_mode: str, ring_len: int) -> list:
    """Beam-state field dtypes for ``make_beam_state`` and stateful
    calls, in K3's order: pb, pnb, h1, h2, last, [lm],
    [ctx_0 .. ctx_{k-1}], [wh1, wh2, wlen, wc1_0.., wc2_0..]; ctx_i is
    the class id of each beam's i-th last context char, oldest first
    (k = ring_len for a char LM)."""
    dts = [torch.float32, torch.float32, torch.uint32, torch.uint32, torch.int32]
    if lm_mode in ("char", "word"):
        dts.append(torch.float32)  # lm
    if lm_mode == "char":
        dts += [torch.int32] * ring_len  # ctx, oldest first
    if lm_mode == "word":
        dts += [torch.uint32, torch.uint32, torch.int32]  # wh1, wh2, wlen
        dts += [torch.uint32] * (2 * ring_len)  # wc1_k then wc2_k
    return dts


def make_beam_state(b: int, beam_width: int, *, lm_mode: str = "none",
                    ring_len: int = 0, device="cpu") -> tuple:
    """Fresh (stream-start) beam state: a tuple of (B, W) tensors equal
    to K3's own initial values, so a stateful call from it equals a
    stateless one. ``lm_mode``: "none" | "char" | "word"; ``ring_len``
    = max(1, order - 1) for both LMs: the word LM's completed-word ring,
    or the char LM's context (class ids, oldest first)."""
    if lm_mode in ("char", "word") and ring_len < 1:
        raise ValueError(f"a {lm_mode}-LM state needs ring_len = max(1, order - 1) >= 1")
    w = beam_width
    pb = np.full((b, w), NEG, np.float32)
    pb[:, 0] = 0.0
    pnb = np.full((b, w), NEG, np.float32)
    h0 = np.where(np.arange(w) == 0, 0, np.arange(w) + 1).astype(np.uint32)
    h0 = np.broadcast_to(h0, (b, w)).copy()
    state = [pb, pnb, h0, h0.copy(), np.full((b, w), -1, np.int32)]
    if lm_mode in ("char", "word"):
        state.append(np.zeros((b, w), np.float32))  # lm
    if lm_mode == "char":
        state += [np.zeros((b, w), np.int32) for _ in range(ring_len)]  # ctx
    if lm_mode == "word":
        state += [np.zeros((b, w), np.uint32), np.zeros((b, w), np.uint32),
                  np.zeros((b, w), np.int32)]
        for tok_i in (0, 1):  # wc1 ring, then wc2; newest (BOS) last
            for k in range(ring_len):
                tok = BOS_TOK if k == ring_len - 1 else PAD_TOK
                state.append(np.full((b, w), tok[tok_i], np.uint32))
    return tuple(torch.from_numpy(s).to(device) for s in state)


def _check_state(state, b, w, lm_mode, ring_len, device) -> list:
    dts = _state_dtypes(lm_mode, ring_len)
    if len(state) != len(dts):
        raise ValueError(f"state has {len(state)} fields; this LM mode "
                         f"({lm_mode}, ring_len={ring_len}) needs {len(dts)}")
    out = []
    for i, (arr, dt) in enumerate(zip(state, dts)):
        arr = torch.as_tensor(arr)
        if tuple(arr.shape) != (b, w):
            raise ValueError(f"state field {i} shape {tuple(arr.shape)} != ({b}, {w})")
        if arr.dtype != dt:
            raise TypeError(f"state field {i} must be {dt}, got {arr.dtype}")
        if arr.device != device:
            raise ValueError(f"state field {i} is on {arr.device}, not {device}")
        out.append(arr)
    return out


def _lm_mode(char_tables, word_tables, space_id):
    if char_tables is not None and word_tables is not None:
        raise ValueError("pass char_tables or word_tables, not both")
    if word_tables is not None:
        if space_id is None:
            raise ValueError("word-LM fusion needs space_id")
        return "word", max(1, word_tables.order - 1)
    if char_tables is not None:
        return "char", max(1, char_tables.order - 1)
    return "none", 0


def _check_shapes(logprobs, lengths, beam_width):
    if logprobs.dim() != 3:
        raise ValueError(f"logprobs must be (B, T, C), got {tuple(logprobs.shape)}")
    b, _, c_num = logprobs.shape
    if beam_width < 1:
        raise ValueError(f"beam_width must be positive, got {beam_width}")
    if c_num < 1:
        raise ValueError(f"logprobs need at least one class, got {c_num}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")


def _out_dtype(beam_width: int, c_num: int):
    # backpointers fit int8 (parent < W, char in [-1, C)), as the TPU
    # kernel's wrapper emits them
    return torch.int8 if beam_width <= 127 and c_num <= 126 else torch.int32


# ---------------------------------------------------------- plain version

def beam_scan_reference(logprobs, lengths, *, beam_width, blank_id,
                        cutoff_top_n=40, cutoff_prob=1.0, prune_logp=-20.0,
                        char_tables=None, word_tables=None, alpha=0.0,
                        beta=0.0, space_id=None, state=None,
                        return_state=False):
    """Plain PyTorch K3 on any device; arguments and results as
    ``beam_scan``."""
    lm_mode, ring = _lm_mode(char_tables, word_tables, space_id)
    _check_shapes(logprobs, lengths, beam_width)
    b, t_n, c_num = logprobs.shape
    w, dev = beam_width, logprobs.device
    e_num = w * c_num
    f32 = dict(dtype=torch.float32, device=dev)
    alpha_t, beta_t = torch.tensor(alpha, **f32), torch.tensor(beta, **f32)
    if state is None:
        state = make_beam_state(b, w, lm_mode=lm_mode, ring_len=ring, device=dev)
    fields = [f.to(torch.int64) if f.dtype in (torch.uint32, torch.int32) else f
              for f in _check_state(state, b, w, lm_mode, ring, dev)]
    pb, pnb, h1, h2, last = fields[:5]
    rest = fields[5:]
    lm = rest.pop(0) if lm_mode != "none" else None
    if lm_mode == "char":  # the last k_ctx chars of each beam, oldest first
        ctx = torch.stack(rest[:ring], -1)
    if lm_mode == "word":
        wh1, wh2, wlen = rest[:3]
        wc1s, wc2s = list(rest[3:3 + ring]), list(rest[3 + ring:])

    iota_c = torch.arange(c_num, device=dev)
    iota_w = torch.arange(w, device=dev)
    iota_e = torch.arange(e_num, device=dev)
    iota_p = torch.arange(w + e_num, device=dev)
    ext_last = iota_c.repeat(w)
    ext_parent = iota_w.repeat_interleave(c_num)
    n_top = min(cutoff_top_n, c_num)
    lengths = lengths.to(dev)
    parents = torch.empty((b, t_n, w), dtype=torch.int64, device=dev)
    chars = torch.empty((b, t_n, w), dtype=torch.int64, device=dev)

    for t in range(t_n):
        lp = logprobs[:, t].to(torch.float32)  # (B, C)
        alive = (t < lengths)[:, None]  # (B, 1)
        if lm_mode == "word":
            wscore, weff1, weff2 = _word_lm_score(word_tables, wh1, wh2, wc1s, wc2s)
            word_bonus = torch.where(wlen > 0, alpha_t * wscore + beta_t, 0.0)

        # ---- ctcdecode candidate pruning, rank form ----
        better = (lp[:, :, None] > lp[:, None, :]) | (
            (lp[:, :, None] == lp[:, None, :]) & (iota_c[:, None] < iota_c[None, :]))
        keep = better.sum(1) < n_top
        if cutoff_prob < 1.0:
            excl = torch.where(better, torch.exp(lp)[:, :, None], 0.0).sum(1)
            keep = keep & (excl < cutoff_prob)
        keep = keep & ((lp > prune_logp) | (iota_c == blank_id))

        p_tot = _lse(pb, pnb)
        # ---- stay candidates ----
        stay_pb = torch.where(keep[:, blank_id:blank_id + 1],
                              p_tot + lp[:, blank_id:blank_id + 1], NEG)
        last_c = last.clamp(min=0)
        lp_last = torch.where(last >= 0, lp.gather(1, last_c), 0.0)
        last_kept = (last >= 0) & keep.gather(1, last_c)
        stay_pnb = torch.where(last_kept, pnb + lp_last, NEG)

        # ---- extend candidates, flat (B, W*C) parent-major ----
        base = torch.where(last[:, :, None] == iota_c, pb[:, :, None], p_tot[:, :, None])
        ext_mask = (iota_c == blank_id) | ~keep
        ext = torch.where(ext_mask[:, None, :], NEG, base + lp[:, None, :]).reshape(b, e_num)
        eh1 = _mix32(h1[:, :, None], iota_c, _M1).reshape(b, e_num)
        eh2 = _mix32(h2[:, :, None], iota_c, _M2).reshape(b, e_num)
        if lm_mode == "char":
            lm_add = alpha_t * _char_lm_scores(char_tables, ctx, c_num)
            if space_id is not None and beta != 0.0:
                lm_add = lm_add + torch.where(iota_c == space_id, beta_t, 0.0)
            ext_lm = (lm[:, :, None] + lm_add).reshape(b, e_num)
            k_ctx = ctx.shape[-1]
            ext_ctx = torch.cat([ctx[:, :, None, 1:].expand(b, w, c_num, k_ctx - 1),
                                 iota_c.view(1, 1, c_num, 1).expand(b, w, c_num, 1)],
                                -1).reshape(b, e_num, k_ctx)
        elif lm_mode == "word":
            ext_lm = (lm[:, :, None] + torch.where(iota_c == space_id, word_bonus[:, :, None],
                                                   0.0)).reshape(b, e_num)

        # ---- exact stay<->extend absorption dedup ----
        match = (h1[:, :, None] == eh1[:, None, :]) & (h2[:, :, None] == eh2[:, None, :])
        k_max = torch.clamp(ext.max(1, keepdim=True).values, min=-1e20)
        exp_ext = torch.where(ext > NEG / 2, torch.exp(ext - k_max), 0.0)
        absorbed = torch.where(match, exp_ext[:, None, :], 0.0).sum(2)
        absorbed_log = torch.where(absorbed > 0.0, torch.log(absorbed) + k_max, NEG)
        stay_score_pre = _lse(stay_pb, stay_pnb)
        stay_pnb = _lse(stay_pnb, absorbed_log)
        masked_ext = torch.where(match, ext[:, None, :], NEG)
        best_val = masked_ext.max(2).values
        best_flat = torch.where(masked_ext == best_val[:, :, None], iota_e, e_num).min(2).values
        take_ext = best_val > stay_score_pre
        stay_parent = torch.where(take_ext, best_flat // c_num, iota_w)
        stay_new = torch.where(take_ext, best_flat % c_num, -1)
        ext = torch.where(match.any(1), NEG, ext)

        # ---- candidate pool: stays then extends ----
        cand = {
            "pb": torch.cat([stay_pb, torch.full((b, e_num), NEG, **f32)], 1),
            "pnb": torch.cat([stay_pnb, ext], 1),
            "h1": torch.cat([h1, eh1], 1), "h2": torch.cat([h2, eh2], 1),
            "last": torch.cat([last, ext_last.expand(b, -1)], 1),
            "parent": torch.cat([stay_parent, ext_parent.expand(b, -1)], 1),
            "new": torch.cat([stay_new, ext_last.expand(b, -1)], 1),
        }
        score = _lse(cand["pb"], cand["pnb"])
        if lm_mode != "none":
            cand["lm"] = torch.cat([lm, ext_lm], 1)
            score = score + cand["lm"]
        if lm_mode == "char":
            cand["ctx"] = torch.cat([ctx, ext_ctx], 1)

        # ---- top-W: W rounds of (max, lowest index, mask) ----
        picks = []
        for _ in range(w):
            m = score.max(1, keepdim=True).values
            idx = torch.where(score == m, iota_p, w + e_num).min(1, keepdim=True).values
            picks.append(idx)
            score = score.scatter(1, idx, PICKED)
        sel_idx = torch.cat(picks, 1)
        sel = {k: v.gather(1, sel_idx if v.dim() == 2 else
                           sel_idx[..., None].expand(-1, -1, v.shape[-1]))
               for k, v in cand.items()}

        # ---- freeze state past each utterance's length ----
        pb = torch.where(alive, sel["pb"], pb)
        pnb = torch.where(alive, sel["pnb"], pnb)
        if lm_mode == "word":
            par = sel["parent"]
            p_wc1 = [a.gather(1, par) for a in wc1s]
            p_wc2 = [a.gather(1, par) for a in wc2s]
            pe1, pe2 = weff1.gather(1, par), weff2.gather(1, par)
            p_wh1, p_wh2, p_wlen = wh1.gather(1, par), wh2.gather(1, par), wlen.gather(1, par)
            newc = sel["new"]
            extended = newc >= 0
            is_space = extended & (newc == space_id)
            closes = is_space & (p_wlen > 0)
            n_wc1 = [torch.where(closes, p_wc1[k + 1] if k + 1 < ring else pe1, p_wc1[k])
                     for k in range(ring)]
            n_wc2 = [torch.where(closes, p_wc2[k + 1] if k + 1 < ring else pe2, p_wc2[k])
                     for k in range(ring)]
            grows = extended & (newc != space_id)
            cu = newc.clamp(min=0)
            n_wh1 = torch.where(is_space, 0, torch.where(grows, _mix32(p_wh1, cu, _M1), p_wh1))
            n_wh2 = torch.where(is_space, 0, torch.where(grows, _mix32(p_wh2, cu, _M2), p_wh2))
            n_wlen = torch.where(is_space, 0, torch.where(grows, p_wlen + 1, p_wlen))
            wh1 = torch.where(alive, n_wh1, wh1)
            wh2 = torch.where(alive, n_wh2, wh2)
            wlen = torch.where(alive, n_wlen, wlen)
            wc1s = [torch.where(alive, n, o) for n, o in zip(n_wc1, wc1s)]
            wc2s = [torch.where(alive, n, o) for n, o in zip(n_wc2, wc2s)]
        h1 = torch.where(alive, sel["h1"], h1)
        h2 = torch.where(alive, sel["h2"], h2)
        last = torch.where(alive, sel["last"], last)
        if lm_mode != "none":
            lm = torch.where(alive, sel["lm"], lm)
        if lm_mode == "char":
            ctx = torch.where(alive[..., None], sel["ctx"], ctx)
        parents[:, t] = torch.where(alive, sel["parent"], iota_w)
        chars[:, t] = torch.where(alive, sel["new"], -1)

    scores = _lse(pb, pnb)
    if lm_mode != "none":
        scores = scores + lm
    state_out = [pb, pnb, h1, h2, last]
    if lm_mode != "none":
        state_out.append(lm)
    if lm_mode == "char":
        state_out += list(ctx.unbind(-1))
    if lm_mode == "word":
        # close the final partial word (ctcdecode finish_decoding); the
        # carried state does not include it
        fscore, _, _ = _word_lm_score(word_tables, wh1, wh2, wc1s, wc2s)
        scores = scores + torch.where(wlen > 0, alpha_t * fscore + beta_t, 0.0)
        state_out += [wh1, wh2, wlen] + wc1s + wc2s
    out_dt = _out_dtype(w, c_num)
    result = (parents.to(out_dt), chars.to(out_dt), scores)
    if return_state:
        state_out = tuple(f.to(dt) for f, dt in zip(state_out, _state_dtypes(lm_mode, ring)))
        return result + (state_out,)
    return result


# ---------------------------------------------------------------- kernel

# The C side's frame-timer columns: clock64 spans of thread 0 summed over
# an utterance's live frames (the wait for the prefetched lp row and the
# frame's last barrier, pruning + per-beam LM state, extends with their
# pool scores, absorption with the stays' pool scores, top-W, survivors +
# backpointers), the whole loop, the barriers passed and the frames.
K3_PARTS = ("row", "prune_lm", "extend", "absorb", "topw", "survive", "loop", "barriers",
            "frames")
# A list to split K3's frame: each launch appends {"timer": (B,
# len(K3_PARTS)) int64 tensor, "lengths": the call's lengths}; None: no
# timer (the main path).
k3_parts: list | None = None


@functools.cache
def _lib() -> ctypes.CDLL:
    """K3's library (built on first use) with its C signature."""
    lib = _build.load("beam")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.tpuasr_beam_scan.argtypes = (
        [p, p] + [i] * 6 + [f, f]  # lp, lengths; B T C W blank top_n; cutoff, prune
        + [i] + [p] * 4 + [p, i, i]  # lm_mode; k1 k2 lp bo; meta, order, n_probes
        + [f, f, i, i, i, i]  # alpha, beta, space, has_beta, ring, k_ctx
        + [p, p, p, p, p, i]  # state_in, state_out, parents, chars, scores, out8
        + [i, p, ll, p, p])  # min_place, work, work_stride, timer, stream
    lib.tpuasr_beam_scan.restype = ctypes.c_int
    lib.tpuasr_beam_plan.argtypes = [i] * 7 + [ctypes.POINTER(i), ctypes.POINTER(ll)]
    lib.tpuasr_beam_plan.restype = ctypes.c_int
    lib.tpuasr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpuasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


@functools.cache
def _k3_plan(beam_width: int, c_num: int, ring: int, k_ctx: int, order: int, lm_mode: str,
             min_place: int, device: torch.device) -> tuple[int, int]:
    """(where K3 keeps its arrays: 0 all in shared memory, 1 the pool in
    the workspace, 2 the state too; the workspace a block needs, in
    bytes), from the C side for this card."""
    lib = _lib()
    place, work = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):
        err = lib.tpuasr_beam_plan(beam_width, c_num, ring, k_ctx, order, _MODES[lm_mode],
                                   min_place, ctypes.byref(place), ctypes.byref(work))
    _raise_on(lib, err, "tpuasr_beam_plan")
    return place.value, work.value


def _stack_state(fields):
    """State fields -> one contiguous (n_fields, B, W) int32 tensor of
    their bit patterns (K3 reads the f32 and uint32 fields through it)."""
    return torch.stack([f.contiguous().view(torch.int32) for f in fields]).contiguous()


def _unstack_state(rows, dtypes) -> tuple:
    """``_stack_state``'s inverse; every row needs its dtype."""
    return tuple(r.view(dt) for r, dt in zip(rows, dtypes, strict=True))


def beam_scan(logprobs, lengths, *, beam_width, blank_id, cutoff_top_n=40,
              cutoff_prob=1.0, prune_logp=-20.0, char_tables=None,
              word_tables=None, alpha=0.0, beta=0.0, space_id=None,
              state=None, return_state=False, _min_place=0):
    """Fused prefix beam search over a batch: no LM, char LM or word LM.

    Args:
      logprobs: (B, T, C) f32 log-probabilities, contiguous.
      lengths: (B,) int32 valid frame counts.
      char_tables / word_tables: optional ``FlatTables`` on the same
        device (``flat_tables``); ``space_id`` is needed for the word LM
        and for the char LM's ``beta`` space bonus.
      state / return_state: stateful mode (``make_beam_state``).
    Returns:
      parents (B, T, W) and chars (B, T, W) (-1 = stay; int8 when
      W <= 127 and C <= 126, else int32), scores (B, W) f32 unsorted;
      with ``return_state`` the post-scan state tuple appended.

    CUDA tensors run K3 (one launch, counted in ``beam_scan.launches``)
    at any width, class count and LM order, or raise for arguments it
    does not take (device, dtype, shape, contiguity) or a failed launch;
    CPU tensors run ``beam_scan_reference``. ``_min_place`` (tests only)
    forces K3's arrays out of shared memory: 1 the W x C pool into the
    global workspace, 2 the beam state too."""
    kw = dict(beam_width=beam_width, blank_id=blank_id, cutoff_top_n=cutoff_top_n,
              cutoff_prob=cutoff_prob, prune_logp=prune_logp, char_tables=char_tables,
              word_tables=word_tables, alpha=alpha, beta=beta, space_id=space_id,
              state=state, return_state=return_state)
    if logprobs.device.type == "cpu":
        return beam_scan_reference(logprobs, lengths, **kw)
    if logprobs.device.type != "cuda":
        raise ValueError(f"beam_scan runs on cuda or cpu, not {logprobs.device}")
    lm_mode, ring = _lm_mode(char_tables, word_tables, space_id)
    _check_shapes(logprobs, lengths, beam_width)
    b, t_n, c_num = logprobs.shape
    w, dev = beam_width, logprobs.device
    if logprobs.dtype != torch.float32 or not logprobs.is_contiguous():
        raise ValueError("logprobs must be contiguous float32")
    if lengths.dtype != torch.int32 or lengths.device != dev:
        raise ValueError(f"lengths must be int32 on {dev}")
    if not 0 <= blank_id < c_num:
        raise ValueError(f"blank_id {blank_id} outside [0, {c_num})")
    if lm_mode == "word" and not 0 <= space_id < c_num:
        raise ValueError(f"space_id {space_id} outside [0, {c_num})")
    tabs = char_tables if char_tables is not None else word_tables
    if tabs is not None and tabs.keys1.device != dev:
        raise ValueError(f"LM tables are on {tabs.keys1.device}, not {dev}")
    if tabs is not None and tabs.keys1.data_ptr() % 16:
        raise ValueError("LM tables' keys1 must be 16-byte aligned (K3 reads them 4 keys at a "
                         "time); flat_tables allocates them so")
    state_in = None
    if state is not None:
        state_in = _stack_state(_check_state(state, b, w, lm_mode, ring, dev))
    dtypes = _state_dtypes(lm_mode, ring)
    state_out = (torch.empty((len(dtypes), b, w), dtype=torch.int32, device=dev)
                 if return_state else None)
    out_dt = _out_dtype(w, c_num)
    parents = torch.empty((b, t_n, w), dtype=out_dt, device=dev)
    chars = torch.empty((b, t_n, w), dtype=out_dt, device=dev)
    scores = torch.empty((b, w), dtype=torch.float32, device=dev)
    if tabs is not None:
        tab_ptrs = [tabs.keys1.data_ptr(), tabs.keys2.data_ptr(), tabs.logps.data_ptr(),
                    tabs.backoffs.data_ptr(), tabs.meta_rows.data_ptr()]
        order, n_probes = tabs.order, tabs.n_probes
    else:
        tab_ptrs, order, n_probes = [None] * 5, 0, 0
    ring_arg = ring if lm_mode == "word" else 0
    k_ctx = ring if lm_mode == "char" else 0
    _, work_bytes = _k3_plan(w, c_num, ring_arg, k_ctx, order, lm_mode, _min_place, dev)
    work = (torch.empty((b * work_bytes,), dtype=torch.uint8, device=dev)
            if work_bytes and b else None)
    has_beta = int(lm_mode == "char" and space_id is not None and beta != 0.0)
    timer = (None if k3_parts is None else
             torch.zeros((b, len(K3_PARTS)), dtype=torch.int64, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpuasr_beam_scan(
            logprobs.data_ptr(), lengths.data_ptr(), b, t_n, c_num, w, blank_id,
            min(cutoff_top_n, c_num), cutoff_prob, prune_logp, _MODES[lm_mode],
            *tab_ptrs, order, n_probes, alpha, beta,
            -1 if space_id is None else space_id, has_beta, ring_arg, k_ctx,
            None if state_in is None else state_in.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            parents.data_ptr(), chars.data_ptr(), scores.data_ptr(),
            int(out_dt == torch.int8), _min_place,
            None if work is None else work.data_ptr(), work_bytes,
            None if timer is None else timer.data_ptr(), stream)
    _raise_on(lib, err, "tpuasr_beam_scan kernel launch")
    beam_scan.launches += 1
    if timer is not None:
        k3_parts.append({"timer": timer, "lengths": lengths})
    if return_state:
        return parents, chars, scores, _unstack_state(state_out, dtypes)
    return parents, chars, scores


beam_scan.launches = 0
