"""Device-resident incremental beam search for streaming serving (port of
``tpuasr/decode/device_stream.py``).

Each stream slot's beam state (prefix probabilities, prefix hashes, the
word LM's ring) stays on the device across ticks, carried in and out of
K3's stateful mode (``ops.beam.beam_scan(..., state=...,
return_state=True)``) the way the acoustic RNN's carries are: one K3
launch a tick advances every slot, and slots with no new frames this
tick (length 0) keep their state and emit identity backpointers.
Chunked stateful calls give the same backpointers as one call over the
concatenation, so the final readout equals the batch decoder's.

The host keeps the cheap part: each chunk's backpointers are walked back
(O(T_chunk * W) numpy) and composed into per-beam suffix sequences, and
the longest common prefix of the live beams is committed, the same
stable-prefix rule as the host engine (``stream._beam_emit``).

Two parts of the JAX module work around Mosaic and are not copied: its
one-hot time matmul, which shifts each slot's window [lo, lo + len) to
frame 0, is a gather here with the same result, and its batch padding to
8 rows is not needed (K3 takes any batch). K3 probes the packed hashed
tables at any size, so nothing the port's K3 decodes is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuasr_torch.decode.beam import NEG, DeviceBeamDecoder

_LIVE = NEG / 2  # scores above this are real beams, not dead fillers


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 32-bit state field as int32 bit patterns (torch's uint32 has
    almost no operations)."""
    return t.view(torch.int32)


class _SlotDecode:
    """Host-side incremental decode state of one stream slot."""

    __slots__ = ("committed_ids", "committed_frames", "suffixes",
                 "scores", "frames_seen", "taken")

    def __init__(self, beam_width: int):
        self.committed_ids: list[int] = []
        self.committed_frames: list[int] = []
        # per-beam (id, frame) sequences past the committed point
        self.suffixes: list[list] = [[] for _ in range(beam_width)]
        self.scores = np.full((beam_width,), NEG, np.float32)
        self.frames_seen = 0
        self.taken = 0  # committed chars already handed to the caller


class DeviceBeamStreams:
    """Batched device-resident incremental beam over ``max_streams``
    stream slots, on ``device`` (K3 on a card, its plain version on the
    CPU). The decoder supplies the beam configuration and the LM K3
    fuses (word or char n-gram)."""

    def __init__(self, decoder: DeviceBeamDecoder, max_streams: int,
                 n_class: int, time_frames: int, device="cpu"):
        from tpuasr_torch.ops.beam import make_beam_state

        self.dec = decoder
        self.w = decoder.cfg.beam_width
        self.s = max_streams
        self.c = n_class
        self.t = time_frames
        self.device = torch.device(device)
        self._lm_kw = decoder.kernel_lm_kwargs(n_class, self.device)
        if "word_tables" in self._lm_kw:
            lm_mode, ring = "word", max(1, self._lm_kw["word_tables"].order - 1)
        elif "char_tables" in self._lm_kw:
            lm_mode, ring = "char", max(1, self._lm_kw["char_tables"].order - 1)
        else:
            lm_mode, ring = "none", 0
        self._state0 = make_beam_state(max_streams, self.w, lm_mode=lm_mode,
                                       ring_len=ring, device=self.device)
        self.state = tuple(_bits(f).clone().view(f.dtype) for f in self._state0)
        self._slots = [_SlotDecode(self.w) for _ in range(max_streams)]

    # ---- lifecycle ----

    def reset_slot(self, i: int) -> None:
        """Slot ``i``'s beam rows back to ``make_beam_state``'s initial
        values on the device (a newly opened stream)."""
        keep = torch.ones((self.s, 1), dtype=torch.bool)
        keep[i] = False
        keep = keep.to(self.device)
        with torch.inference_mode():  # a select of bit patterns: exact for every field
            self.state = tuple(torch.where(keep, _bits(cur), _bits(init)).view(cur.dtype)
                               for cur, init in zip(self.state, self._state0))
        self._slots[i] = _SlotDecode(self.w)

    # ---- data plane ----

    def _advance(self, logits: torch.Tensor, lo, lens, state):
        """K3's stateful advance of every slot: ``logits`` (S, T, C) raw
        logits on the device, ``lo``/``lens`` (S,) int32 tensors of each
        slot's valid window [lo, lo + len). The window is shifted to
        frame 0 (frames past the logits are zeros, as the JAX package's
        one-hot shift leaves them; frames past ``len`` are frozen by K3)
        and log-softmaxed. Returns (parents, chars, scores, state')."""
        from tpuasr_torch.ops.beam import beam_scan

        s_n, t_n, c_n = logits.shape
        t_in = lo.to(torch.int64)[:, None] + torch.arange(t_n, device=logits.device)[None, :]
        inside = (t_in < t_n)[:, :, None]
        shifted = torch.gather(logits, 1, t_in.clamp(max=t_n - 1)[:, :, None]
                               .expand(s_n, t_n, c_n))
        shifted = torch.where(inside, shifted, 0.0)
        lp = torch.log_softmax(shifted.to(torch.float32), dim=-1).contiguous()
        cfg = self.dec.cfg
        return beam_scan(lp, lens, beam_width=self.w, blank_id=cfg.blank_id,
                         cutoff_top_n=cfg.cutoff_top_n, cutoff_prob=cfg.cutoff_prob,
                         prune_logp=cfg.prune_logp, state=state, return_state=True,
                         **self._lm_kw)

    def advance_queued(self, logits: torch.Tensor, lo: np.ndarray, lens: np.ndarray):
        """One tick's device half: queue K3's advance behind whatever
        made ``logits`` (they stay on the device), then read parents,
        chars and scores back in one copy. Returns ((parents, chars,
        scores) host arrays, the new state); the caller adopts the state
        (``self.state = ...``) after the read-back, so a failed tick
        leaves the old state in place, and then calls ``fold``."""
        from tpuasr_torch.device import to_device

        with torch.inference_mode():
            lo_d = to_device(np.asarray(lo, np.int32), self.device)
            lens_d = to_device(np.asarray(lens, np.int32), self.device)
            parents, chars, scores, state1 = self._advance(logits, lo_d, lens_d, self.state)
            fetched = DeviceBeamDecoder.to_host(parents, chars, scores, self.c)
        return fetched, state1

    def advance(self, logits, lo: np.ndarray, lens: np.ndarray) -> None:
        """One batched tick from (S, T, C) logits (tensor or array):
        advance, adopt the new state, fold."""
        logits = torch.as_tensor(logits).to(self.device)
        fetched, self.state = self.advance_queued(logits, lo, lens)
        self.fold(*fetched, lens)

    def fold(self, parents: np.ndarray, chars: np.ndarray,
             scores: np.ndarray, lens: np.ndarray) -> None:
        """Host half of a tick: compose the fetched backpointers into
        per-slot suffixes and commits. ``parents``/``chars`` (S, T, W),
        ``scores`` (S, W), ``lens`` (S,)."""
        parents = np.asarray(parents)
        chars = np.asarray(chars)
        scores_all = np.asarray(scores)
        for i in range(self.s):
            n = int(lens[i])
            if n <= 0:
                continue
            self._fold_chunk(i, parents[i, :n], chars[i, :n], scores_all[i])

    def _fold_chunk(self, i: int, parents: np.ndarray, chars: np.ndarray,
                    scores: np.ndarray) -> None:
        """Compose one chunk's backpointers into slot ``i``'s per-beam
        suffix sequences and commit the live beams' common prefix."""
        sl = self._slots[i]
        t_n, w = chars.shape
        cur = np.arange(w)
        appends: list[list] = [[] for _ in range(w)]
        base = sl.frames_seen
        # chunk-local lineage walk (the batch _backtrack over one chunk)
        for t in range(t_n - 1, -1, -1):
            ch = chars[t, cur]
            for j in np.nonzero(ch >= 0)[0]:
                appends[j].append((int(ch[j]), base + t))
            cur = parents[t, cur]
        for j in range(w):
            appends[j].reverse()
        sl.suffixes = [sl.suffixes[int(cur[j])] + appends[j] for j in range(w)]
        sl.scores = scores
        sl.frames_seen += t_n
        # stable commit: the LCP of the live beams' id sequences
        live = np.nonzero(scores > _LIVE)[0]
        if len(live) == 0:
            return
        seqs = [[p[0] for p in sl.suffixes[j]] for j in live]
        lcp = seqs[0]
        for s2 in seqs[1:]:
            n = 0
            for a, b2 in zip(lcp, s2):
                if a != b2:
                    break
                n += 1
            lcp = lcp[:n]
            if not lcp:
                break
        if not lcp:
            return
        best = int(live[np.argmax(scores[live])])
        take = sl.suffixes[best][:len(lcp)]
        sl.committed_ids.extend(p[0] for p in take)
        sl.committed_frames.extend(p[1] for p in take)
        sl.suffixes = [s2[len(lcp):] for s2 in sl.suffixes]

    # ---- results ----

    def committed(self, i: int) -> tuple[list, list]:
        sl = self._slots[i]
        return list(sl.committed_ids), list(sl.committed_frames)

    def take_committed(self, i: int) -> tuple[list, list]:
        """Newly committed (ids, frames) since the last take."""
        sl = self._slots[i]
        ids = sl.committed_ids[sl.taken:]
        frames = sl.committed_frames[sl.taken:]
        sl.taken = len(sl.committed_ids)
        return ids, frames

    def finalize(self, i: int) -> tuple[list, list, float]:
        """The best beam's full (ids, frames, score): the flush readout.
        Equal to the batch decoder's best row, because chunked stateful
        calls emit the same backpointers and the last tick's scores
        include the word LM's close."""
        sl = self._slots[i]
        best = int(np.argmax(sl.scores))
        ids = sl.committed_ids + [p[0] for p in sl.suffixes[best]]
        frames = sl.committed_frames + [p[1] for p in sl.suffixes[best]]
        return ids, frames, float(sl.scores[best])
