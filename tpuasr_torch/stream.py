"""Streaming (incremental) transcription for unidirectional models (port
of ``tpuasr/stream.py``).

One step function with static shapes processes a fixed-size audio chunk
per call and carries exact model state between calls, as in the JAX
package:

  * The convolutions are stateless: each step recomputes conv1 and conv2
    over a small carried window of past frames (kernel-minus-stride
    overlaps: 9 feature frames, 10 conv1 frames), so their outputs equal
    the offline model's by construction.
  * The true state is what the offline model carries along time: each
    layer's RNN hidden state (exact), the Lookahead delay buffer
    (``context - 1`` frames) and the causal normalization accumulators.
  * Every chunk emits ``chunk_frames // 2`` logit frames (conv1 halves
    time). Positions outside a stream are masked by absolute-index
    comparisons against per-row ``k``/``t_f``/``t1``, so one step serves
    start-up, steady state and flush.

The carry keeps JAX's dtypes: the feature window and the hidden states
in the compute dtype, the conv1 window, the Lookahead buffer and the
accumulators in f32. The chunk's recurrence (``_rnn_chunk``) is a
``lax.scan`` in the JAX package, not a Pallas kernel, so here it is a
plain PyTorch loop over the chunk's frames from the carried h (the
offline K1f/K4f take no initial state), its step product rounded to the
compute dtype as ``preferred_element_type=dtype`` does. The frontend's
DFT runs in full f32 (``resolve_device`` keeps TF32 off).

Exactness: with ``normalize=False`` the streamed logits equal the
offline model's for the same wave. With ``normalize=True`` streaming
normalizes each chunk with the statistics of everything heard so far
(causal), optionally primed with corpus statistics (``prime_stats``,
``audio.frontend.corpus_feature_stats``).

Beam engines (``beam_impl``): ``"device"`` carries each stream's beam
state across chunks on the device in K3's stateful mode
(``decode.device_stream.DeviceBeamStreams``): a tick queues the acoustic
step and K3's advance back to back, and the host reads back the
backpointers and scores in one copy; ``"native"`` feeds the read-back
rows to one C++ beam session per stream (``decode.native
.NativeBeamSession``, kept across ``reset`` and slot reuse); ``"host"``
runs ``decode.beam_host.beam_step`` over them. ``"auto"`` follows the
JAX package's order (device, then native, then host): ``"device"`` on a
CUDA device and ``"native"`` on the CPU. An engine that cannot be built
(K3, or the C++ library) raises; nothing falls back quietly, where the
JAX package falls back to the next engine.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuasr_torch.audio.frontend import FrontendConfig, _device_consts
from tpuasr_torch.compat.weights import model_from_variables
from tpuasr_torch.decode.native import NativeBeamSession
from tpuasr_torch.device import resolve_device, to_device
from tpuasr_torch.model.ds2 import CONV_SPECS, DeepSpeech2, ModelConfig

__all__ = ["StreamingTranscriber", "MultiStreamTranscriber"]

BEAM_IMPLS = ("auto", "host", "native", "device")


def _first_lead(take: np.ndarray, hop: int) -> np.ndarray:
    """Chunk 0's lead: frame 0 left-reflects (librosa center=True)."""
    lead = np.zeros((hop,), np.float32)
    n = min(hop, len(take) - 1)
    if n > 0:
        lead[-n:] = take[1:n + 1][::-1]
    return lead


def _reflect_tail(recent: np.ndarray, l: int, t_f: int, hop: int,
                  half: int, tail_len: int) -> np.ndarray:
    """End-of-stream extension: right-reflect the last samples so the
    final frame reads its offline center=True window (the offline
    frontend's one-frame fixup), zeros beyond."""
    tail = np.zeros((tail_len,), np.float32)
    end = (t_f - 1) * hop + half
    base = l - len(recent)
    for i in range(l, end):
        p = 2 * (l - 1) - i
        if 0 <= p - base < len(recent):
            tail[i - l] = recent[p - base]
    return tail


def _init_carry(cfg: ModelConfig, fe: FrontendConfig, b: int, device,
                prime_stats: tuple | None = None):
    """Zero streaming carry for ``b`` streams on ``device``: (fbuf,
    c1buf, labuf, hs, n_cnt, n_sum, n_sq).

    ``prime_stats`` = (mean, var, weight_frames) seeds the causal
    normalization accumulators with ``weight_frames`` pseudo-frames of
    corpus statistics, so a stream's first frames are normalized near
    what the offline (whole-utterance) frontend would use; the running
    estimate still converges to the utterance's own statistics."""
    kt1, kf1, st1, sf1, _, pf1 = CONV_SPECS[0]
    kt2, _, st2, _, _, _ = CONV_SPECS[1]
    f1 = (fe.n_features + 2 * pf1 - kf1) // sf1 + 1
    h, dt = cfg.hidden_size, cfg.torch_compute_dtype
    f32 = dict(dtype=torch.float32, device=device)
    shape = (2, b, h) if cfg.rnn_type == "lstm" else (b, h)
    hs = [torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.hidden_layers)]
    n_cnt = n_sum = n_sq = torch.zeros((b,), **f32)
    if prime_stats is not None:
        mean, var, w_frames = (float(x) for x in prime_stats)
        cells = w_frames * fe.n_features  # the accumulators count cells
        n_cnt = torch.full((b,), cells, **f32)
        n_sum = torch.full((b,), cells * mean, **f32)
        n_sq = torch.full((b,), cells * (var + mean * mean), **f32)
    return (
        torch.zeros((b, kt1 - st1, fe.n_features), dtype=dt, device=device),
        torch.zeros((b, kt2 - st2, f1, cfg.conv_channels), **f32),
        torch.zeros((b, max(cfg.lookahead_context - 1, 1), h), **f32),
        hs,
        n_cnt,
        n_sum,
        n_sq,
    )


def _greedy_emit(rows: np.ndarray, lo: int, hi: int, last_id: int,
                 labels, blank_id: int,
                 base_w: int = 0) -> tuple[str, int, list[int]]:
    """CTC greedy collapse over finalized logit rows [lo, hi); also
    reports each emitted character's absolute conv-frame offset
    (base_w + row index, the offline GreedyDecoder's offsets)."""
    parts: list[str] = []
    offs: list[int] = []
    for j in range(lo, hi):
        cid = int(np.argmax(rows[j]))
        if cid != blank_id and cid != last_id:
            parts.append(labels[cid])
            offs.append(base_w + j)
        last_id = cid
    return "".join(parts), last_id, offs


def _beam_emit(beams, committed: tuple, rows: np.ndarray, lo: int,
               hi: int, alphabet, beam_kw: dict, base_w: int = 0):
    """Advance an incremental host prefix beam over finalized logit rows
    [lo, hi) and emit the newly stable text (the common prefix of every
    live beam past what was committed). Returns (frag, beams,
    committed, offs); offs are the newly committed chars' emission
    frames under the best beam's alignment."""
    from tpuasr_torch.decode.beam_host import beam_step

    for j in range(lo, hi):
        row = rows[j].astype(np.float64)
        lp = row - np.log(np.sum(np.exp(row - row.max()))) - row.max()
        beams = beam_step(beams, lp, alphabet, t=base_w + j, **beam_kw)
    keys = list(beams.keys())
    lcp = keys[0]
    for k2 in keys[1:]:
        n = 0
        for a, b2 in zip(lcp, k2):
            if a != b2:
                break
            n += 1
        lcp = lcp[:n]
    frag = ""
    offs: list[int] = []
    if len(lcp) > len(committed) and lcp[:len(committed)] == committed:
        frag = alphabet.decode(lcp[len(committed):])
        best = max(beams.items(),
                   key=lambda kv: _lse_pair(kv[1][0], kv[1][1]) + kv[1][2])
        offs = list(best[1][4][len(committed):len(lcp)])
        committed = lcp
    return frag, beams, committed, offs


def _lse_pair(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= -5e29:
        return a
    return a + float(np.log1p(np.exp(b - a)))


def _beam_final(beams, committed_text: str, alphabet, beam_kw: dict):
    """Finalize an incremental host beam: the best beam's text, closing
    the last partial word against the LM. Returns (extra_text,
    full_text, frames); on a retraction (the final text does not extend
    the committed prefix) extra == full and the caller replaces its
    committed text."""
    from tpuasr_torch.decode.beam_host import beam_results

    final, _, frames = beam_results(beams, alphabet, lm=beam_kw["lm"],
                                    alpha=beam_kw["alpha"],
                                    beta=beam_kw["beta"],
                                    with_offsets=True)[0]
    if final.startswith(committed_text):
        return final[len(committed_text):], final, frames
    return final, final, frames


def _native_emit(session, committed: tuple, rows: np.ndarray, lo: int, hi: int,
                 alphabet):
    """Advance a NativeBeamSession over finalized logit rows [lo, hi) and
    emit the newly stable text (``_beam_emit``'s contract; the session
    counts frames from the first row it was fed, which is conv frame 0,
    since a stream feeds its rows contiguously from there)."""
    r = rows[lo:hi].astype(np.float64)  # normalised in f64 as the host
    m = r.max(axis=-1, keepdims=True)  # beam does; feed casts to f32
    session.feed(r - m - np.log(np.sum(np.exp(r - m), axis=-1, keepdims=True)))
    lcp_ids, lcp_frames = session.prefix_with_frames()
    lcp = tuple(int(x) for x in lcp_ids)
    frag = ""
    offs: list[int] = []
    if len(lcp) > len(committed) and lcp[:len(committed)] == committed:
        frag = alphabet.decode(list(lcp[len(committed):]))
        offs = [int(x) for x in lcp_frames[len(committed):]]
        committed = lcp
    return frag, committed, offs


def _resolve_beam_impl(decoder: str, beam_impl: str, device: torch.device) -> str:
    if beam_impl not in BEAM_IMPLS:
        raise ValueError(f"beam_impl must be auto|host|native|device, got {beam_impl!r}")
    if decoder != "beam":
        return "none"
    if beam_impl == "auto":
        return "device" if device.type == "cuda" else "native"
    return beam_impl


def _device_engine(alphabet, beam_kw: dict, max_streams: int, delta: int, device):
    """DeviceBeamStreams over K3 for ``max_streams`` slots; raises when
    K3 cannot be built (no fallback)."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.device_stream import DeviceBeamStreams

    dec = DeviceBeamDecoder(
        alphabet, beam_width=beam_kw["beam_width"], word_lm=beam_kw["lm"],
        alpha=beam_kw["alpha"], beta=beam_kw["beta"],
        cutoff_top_n=beam_kw["cutoff_top_n"], cutoff_prob=beam_kw["cutoff_prob"],
        prune_logp=beam_kw["prune_logp"])
    return DeviceBeamStreams(dec, max_streams, alphabet.size, delta, device=device)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _bn_eval(x, bn, eps=1e-5):
    """MaskedBatchNorm in eval mode: a per-position affine from the
    running statistics, in f32."""
    scale, bias, mean, var = bn
    return (x.to(torch.float32) - mean) * torch.rsqrt(var + eps) * scale + bias


def _conv_block(x, weight, bn, spec, mask, dtype):
    """One MaskedConvBlock (eval) over a frame window of (B, T, F, C)
    with no time padding (the window holds the context) and the offline
    symmetric freq padding. ``mask`` (B, T_out): validity of each
    output's absolute position. Returns f32."""
    _, _, st, sf, _, pf = spec
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight, stride=(st, sf),
                 padding=(0, pf)).permute(0, 2, 3, 1)
    y = _bn_eval(y, bn).clamp(0.0, 20.0)
    return y * mask[:, :, None, None]


def _rnn_chunk(x, h0, p, rnn_type, mask, dtype):
    """RecurrentCore's math over a chunk: the input projection as one
    matmul, then a masked loop from the carried ``h0`` (for an LSTM the
    stacked (h, c)). Every product and gate in ``dtype``, as
    ``tpuasr/stream.py:269 _rnn_chunk`` computes them. Returns (ys
    (B, D, H), h1)."""
    w_x, b_x, w_h, b_h = p
    xg = torch.matmul(x.to(dtype), w_x) + b_x  # (B, D, G*H)
    m = mask.to(dtype)[:, :, None]
    if rnn_type == "lstm":
        hc, cc = h0[0], h0[1]
    else:
        hc = h0
    ys = []
    for s in range(xg.shape[1]):
        xg_s, m_s = xg[:, s], m[:, s]
        hg = torch.matmul(hc, w_h) + b_h
        if rnn_type == "lstm":
            i_, f_, g_, o_ = (xg_s + hg).chunk(4, dim=-1)
            c_new = torch.sigmoid(f_) * cc + torch.sigmoid(i_) * torch.tanh(g_)
            h_new = torch.sigmoid(o_) * torch.tanh(c_new)
            cc = m_s * c_new + (1 - m_s) * cc
        elif rnn_type == "gru":
            xr, xz, xn = xg_s.chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n_ = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n_ + z * hc
        else:
            h_new = torch.tanh(xg_s + hg)
        hc = m_s * h_new + (1 - m_s) * hc
        ys.append(hc)
    ys = torch.stack(ys, dim=1) * m
    return ys, (torch.stack([hc, cc]) if rnn_type == "lstm" else hc)


def _carry_rows_select(keep, carry_new, carry_old, lstm: bool):
    """Per-row select between two streaming carries: row b of the
    result takes ``carry_new`` where ``keep[b]`` else ``carry_old``. The
    hidden states hold the batch on axis 0 (GRU, RNN: (B, H)) or axis 1
    (LSTM: (2, B, H)), everything else on axis 0. Used by the step's
    idle-row freeze and by slot reuse; both read the old rows from a
    carry that nothing writes in place."""
    def sel(new, old, axis=0):
        m = keep.reshape((1,) * axis + (-1,) + (1,) * (new.dim() - 1 - axis))
        return torch.where(m, new, old)

    h_axis = 1 if lstm else 0
    return (
        sel(carry_new[0], carry_old[0]), sel(carry_new[1], carry_old[1]),
        sel(carry_new[2], carry_old[2]),
        [sel(n, o, axis=h_axis) for n, o in zip(carry_new[3], carry_old[3])],
        sel(carry_new[4], carry_old[4]), sel(carry_new[5], carry_old[5]),
        sel(carry_new[6], carry_old[6]),
    )


class _Step:
    """The streaming step of ``tpuasr/stream.py:314 _build_step`` for a
    frozen ``DeepSpeech2``: weights cast to the compute dtype once.

    ``step(carry, window, k, t_f, t1, active=None) -> (logits (B, D, C)
    f32, carry')`` with D = chunk_frames // 2. ``window`` (B,
    (chunk_frames + 1) * hop) holds the hop blocks [lead | chunk] of
    feature frames [k * chunk_frames, (k + 1) * chunk_frames); ``k``,
    ``t_f`` and ``t1`` are (B,) integer tensors (``t_f``/``t1`` the true
    total feature and conv frame counts, a large sentinel while the
    stream is open); ``active`` (B,) bool freezes the carry of idle rows
    bit for bit. Logits are for absolute conv frames base_w(k) + [0, D);
    the caller keeps rows with 0 <= w < t1."""

    def __init__(self, model: DeepSpeech2, fe: FrontendConfig, chunk_frames: int):
        cfg = model.config
        if cfg.bidirectional:
            raise ValueError("streaming needs a unidirectional model "
                             "(bidirectional=False); the backward direction "
                             "is anti-causal by definition")
        if chunk_frames % 2 or chunk_frames < 2:
            raise ValueError("chunk_frames must be a positive multiple of 2")
        if fe.n_fft != 2 * fe.hop:
            raise ValueError("streaming framing assumes n_fft == 2*hop "
                             "(the reference 20ms/10ms configuration)")
        (kt1, _, st1, _, pt1, _), (kt2, _, st2, _, pt2, _) = CONV_SPECS
        self.cfg, self.fe, self.chunk_frames = cfg, fe, chunk_frames
        self.delta = chunk_frames // st1  # conv frames emitted a step
        self.d1 = (kt1 - st1 - pt1) // st1  # conv1 start-up lead (2)
        self.d2 = kt2 - st2 - pt2  # conv2 start-up lead (5)
        self.keep1, self.keep2 = kt1 - st1, kt2 - st2
        dev = next(model.parameters()).device
        self.device = dev
        dt = self.dtype = cfg.torch_compute_dtype
        if dt == torch.float32:
            torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32
        with torch.no_grad():
            self.window, self.dft = _device_consts(fe.window, fe.n_fft, dev)

            def bn(m):
                return tuple(t.detach().to(torch.float32)
                             for t in (m.scale, m.bias, m.mean, m.var))

            self.convs = [(c.weight.detach().to(dt), bn(c.bn)) for c in model.convs]
            self.rnns = []
            for r in model.rnns:
                core = r.fwd
                self.rnns.append((
                    None if r.bn is None else bn(r.bn),
                    (core.input_proj.kernel.detach().to(dt),
                     core.input_proj.bias.detach().to(dt),
                     core.recurrent_kernel.detach().to(dt),
                     core.recurrent_bias.detach().to(dt))))
            self.lookahead = (None if model.lookahead is None else
                              model.lookahead.kernel.detach().to(dt).permute(2, 1, 0)
                              .contiguous())  # (H, 1, ctx)
            self.head_bn = bn(model.head_bn)
            self.head = model.head_kernel.detach().to(dt)

    def __call__(self, carry, window, k, t_f, t1, active=None):
        with torch.inference_mode():
            return self._step(carry, window, k, t_f, t1, active)

    def _step(self, carry, window, k, t_f, t1, active):
        cfg, fe, dt = self.cfg, self.fe, self.dtype
        cf, delta, hop = self.chunk_frames, self.delta, fe.hop
        (fbuf, c1buf, labuf, hs, n_cnt, n_sum, n_sq) = carry
        b = window.shape[0]
        dev = window.device
        kv, t_f_v, t1_v = k[:, None], t_f[:, None], t1[:, None]

        # ---- frontend: frames -> |DFT| -> log1p -> causal normalize
        blocks = window.reshape(b, cf + 1, hop)
        frames = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=-1) * self.window
        z = torch.matmul(frames, self.dft)
        n_f = fe.n_features
        re, im = z[..., :n_f], z[..., n_f:]
        feats = torch.log1p(torch.sqrt(re * re + im * im + 1e-30))  # (B, cf, F)
        t_abs = kv * cf + torch.arange(cf, device=dev)[None, :]
        f_valid = (t_abs < t_f_v).to(torch.float32)
        if fe.normalize:
            m3 = f_valid[:, :, None]
            n_cnt = n_cnt + f_valid.sum(dim=1) * n_f
            n_sum = n_sum + (feats * m3).sum(dim=(1, 2))
            n_sq = n_sq + (feats * feats * m3).sum(dim=(1, 2))
            cnt = n_cnt.clamp(min=1.0)
            mean = n_sum / cnt
            var = (n_sq / cnt - mean * mean).clamp(min=1e-10)
            feats = (feats - mean[:, None, None]) * torch.rsqrt(var)[:, None, None]
        feats = feats * f_valid[:, :, None]

        # ---- conv1 over [9-frame carry | chunk], u = k*D - d1 + [0, D)
        ar = torch.arange(delta, device=dev)[None, :]
        fwin = torch.cat([fbuf, feats.to(dt)], dim=1)
        base_u = kv * delta - self.d1
        u_abs = base_u + ar
        u_ok = ((u_abs >= 0) & (u_abs < t1_v)).to(torch.float32)
        w0, bn0 = self.convs[0]
        c1 = _conv_block(fwin[:, :, :, None], w0, bn0, CONV_SPECS[0], u_ok, dt)

        # ---- conv2 over [10-frame carry | new], v = base_u - d2 + [0, D)
        c1win = torch.cat([c1buf, c1], dim=1)
        base_v = base_u - self.d2
        v_abs = base_v + ar
        v_ok = ((v_abs >= 0) & (v_abs < t1_v)).to(torch.float32)
        w1, bn1 = self.convs[1]
        x = _conv_block(c1win, w1, bn1, CONV_SPECS[1], v_ok, dt).reshape(b, delta, -1)

        # ---- RNN stack from the carried hidden states
        new_hs = []
        for i, (bn, p) in enumerate(self.rnns):
            if bn is not None:
                x = _bn_eval(x, bn) * v_ok[:, :, None]
            x, h1 = _rnn_chunk(x, hs[i], p, cfg.rnn_type, v_ok, dt)
            new_hs.append(h1)
        x = x.to(torch.float32)

        # ---- Lookahead over [ctx-1 carry | new], w = v - (ctx - 1)
        ctx = cfg.lookahead_context
        if ctx > 0:
            lwin = torch.cat([labuf[:, :ctx - 1], x], dim=1)
            y = F.conv1d(lwin.to(dt).transpose(1, 2), self.lookahead,
                         groups=lwin.shape[-1]).transpose(1, 2)
            y = y.clamp(0.0, 20.0).to(torch.float32)
            base_w = base_v - (ctx - 1)
            new_labuf = lwin[:, -(ctx - 1):] if ctx > 1 else labuf
        else:
            y, base_w, new_labuf = x, base_v, labuf

        w_abs = base_w + ar
        w_ok = ((w_abs >= 0) & (w_abs < t1_v)).to(torch.float32)
        y = _bn_eval(y, self.head_bn) * w_ok[:, :, None]
        logits = torch.matmul(y.to(dt), self.head).to(torch.float32) * w_ok[:, :, None]

        carry1 = (fwin[:, -self.keep1:], c1win[:, -self.keep2:], new_labuf, new_hs,
                  n_cnt, n_sum, n_sq)
        if active is not None:
            # freeze idle rows bit for bit; the old rows come from the
            # input carry tuple (n_cnt, n_sum, n_sq were rebound above)
            carry1 = _carry_rows_select(active, carry1, carry,
                                        lstm=cfg.rnn_type == "lstm")
        return logits, carry1


def _as_model(variables, cfg: ModelConfig, device) -> DeepSpeech2:
    """A frozen ``DeepSpeech2`` on the device: ``variables`` is either
    one already (shared with a ``TranscriptionService``) or a
    flax-shaped ``{"params", "batch_stats"}`` tree."""
    if isinstance(variables, DeepSpeech2):
        return variables
    return model_from_variables(variables, cfg, resolve_device(device))


def _tick_inputs(device, windows, *ints):
    """The tick's host arrays on the device, queued from pinned memory
    (no wait for the card)."""
    return (to_device(windows, device),) + tuple(
        to_device(np.asarray(a, np.int64), device) for a in ints)


class StreamingTranscriber:
    """Incremental transcription of one live sample stream.

    >>> st = StreamingTranscriber(variables, model_cfg, frontend_cfg,
    ...                           alphabet, chunk_frames=32)
    >>> for block in mic:            # float32 blocks of any size
    ...     print(st.feed(block), end="", flush=True)
    >>> print(st.flush())

    ``feed`` returns newly finalized text (greedy emissions are final as
    soon as their lookahead context is complete); ``flush`` drains the
    pipeline at the end of the stream and returns the rest. ``variables``
    is a flax-shaped tree or a ``DeepSpeech2`` already on ``device``.

    ``decoder="beam"`` runs an incremental prefix beam (optionally with
    word-LM fusion through ``lm``): ``feed`` returns the stable common
    prefix of all beams as it grows, ``flush`` finalizes with the best
    beam; on the rare retraction ``flush`` returns the corrected full
    text and ``.text`` is the authoritative transcript. ``beam_impl``:
    see the module docstring. ``prime_stats`` = (mean, var,
    weight_frames) seeds the causal normalization (``_init_carry``).
    """

    _SENTINEL = 1 << 30

    def __init__(self, variables, model_cfg: ModelConfig,
                 frontend_cfg: FrontendConfig, alphabet,
                 chunk_frames: int = 32,
                 collect_logits: bool = False,
                 decoder: str = "greedy", lm=None, alpha: float = 0.8,
                 beta: float = 1.0, beam_width: int = 10,
                 cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
                 prune_logp: float = -20.0, beam_impl: str = "auto",
                 prime_stats: tuple | None = None, device: str = "cuda"):
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder must be greedy|beam, got {decoder!r}")
        self.cfg = model_cfg
        self.fe = frontend_cfg
        self.alphabet = alphabet
        self.blank_id = alphabet.blank_id
        self.chunk_frames = chunk_frames
        self.collect_logits = collect_logits
        self.decoder = decoder
        self._beam_kw = dict(beam_width=beam_width, lm=lm, alpha=alpha,
                             beta=beta, cutoff_top_n=cutoff_top_n,
                             cutoff_prob=cutoff_prob, prune_logp=prune_logp)
        self.prime_stats = prime_stats
        self.model = _as_model(variables, model_cfg, device)
        self._step = _Step(self.model, frontend_cfg, chunk_frames)
        self.device = self._step.device
        self._delta, self._d1, self._d2 = self._step.delta, self._step.d1, self._step.d2
        self.beam_impl = _resolve_beam_impl(decoder, beam_impl, self.device)
        self._dev_engine = (_device_engine(alphabet, self._beam_kw, 1, self._delta,
                                           self.device)
                            if self.beam_impl == "device" else None)
        self._native = (NativeBeamSession(alphabet, **self._beam_kw)
                        if self.beam_impl == "native" else None)
        self.reset()

    # ---- state management -------------------------------------------------

    def reset(self) -> None:
        self._carry = _init_carry(self.cfg, self.fe, 1, self.device, self.prime_stats)
        self._pending = np.zeros((0,), np.float32)
        self._lead = None  # the previous window's last hop samples
        self._recent = np.zeros((0,), np.float32)  # for the flush reflection
        self._n_samples = 0
        self._k = 0
        self._last_id = self.blank_id
        self._text_parts: list[str] = []
        self._offsets: list[int] = []  # per-char conv-frame offsets
        self._emitted = 0  # conv frames finalized so far
        self._closed = False
        self._rows: list[np.ndarray] = []  # logits rows when collecting
        if self.decoder == "beam":
            self._committed: tuple = ()
            self._beams = None
            if self._dev_engine is not None:
                self._dev_engine.reset_slot(0)
            elif self._native is not None:
                self._native.reset()  # the C++ session is reused
            else:
                from tpuasr_torch.decode.beam_host import beam_init

                self._beams = beam_init()

    # ---- streaming --------------------------------------------------------

    @property
    def text(self) -> str:
        return "".join(self._text_parts)

    @property
    def offsets(self) -> np.ndarray:
        """Per-character conv-frame offsets. Greedy: the offline
        decoder's. Beam: each committed char's emission frame under the
        best beam's alignment at commit time (frozen like the text;
        flush replaces them on a retraction)."""
        return np.asarray(self._offsets, np.int64)

    def logits(self) -> np.ndarray:
        """(T1, C) assembled logits (needs collect_logits=True)."""
        if not self.collect_logits:
            raise RuntimeError("constructed with collect_logits=False")
        return np.concatenate(self._rows, axis=0) if self._rows else \
            np.zeros((0, self.cfg.n_classes), np.float32)

    def feed(self, samples: np.ndarray) -> str:
        """Append samples, run every full chunk available, return newly
        finalized text."""
        if self._closed:
            raise RuntimeError("stream is closed; call reset()")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._pending = np.concatenate([self._pending, samples])
        self._n_samples += len(samples)
        self._recent = np.concatenate([self._recent, samples])[
            -(2 * self.fe.hop + 2):]
        return self._run_chunks(self._SENTINEL, self._SENTINEL)

    def flush(self) -> str:
        """End of stream: drain the pipeline, close, return the rest."""
        if self._closed:
            return ""
        hop = self.fe.hop
        l, t_f = self._n_samples, 1 + self._n_samples // self.fe.hop
        t1 = (t_f - 1) // 2 + 1
        # extend the stream so the final frame reads its offline
        # right-reflected samples and enough zero frames follow to drain
        # the conv and lookahead delays (masked frames only read them)
        tail = _reflect_tail(self._recent, l, t_f, hop, self.fe.n_fft // 2,
                             4 * self.chunk_frames * hop)
        self._pending = np.concatenate([self._pending, tail])
        drained = []
        while self._emitted < t1:
            drained.append(self._run_chunks(t_f, t1, max_steps=1))
            if len(self._pending) < (self.chunk_frames * hop):
                self._pending = np.concatenate([
                    self._pending, np.zeros((self.chunk_frames * hop,), np.float32)])
        extra = ""
        if self.decoder == "beam":
            committed = "".join(self._text_parts)  # includes the drained text
            if self._dev_engine is not None or self._native is not None:
                ids, frames, _ = (self._dev_engine.finalize(0) if self._native is None
                                  else self._native.best_with_frames())
                final = self.alphabet.decode([int(x) for x in ids])
                extra = final[len(committed):] if final.startswith(committed) else final
            else:
                extra, final, frames = _beam_final(self._beams, committed, self.alphabet,
                                                   self._beam_kw)
            if extra and final.startswith(committed):
                self._text_parts.append(extra)
                self._offsets.extend(int(x) for x in frames[len(committed):])
            elif not final.startswith(committed):
                # rare retraction: the final text is authoritative
                self._text_parts = [final]
                self._offsets = [int(x) for x in frames]
                drained = []
        self._closed = True
        return "".join(drained) + extra

    def _run_chunks(self, t_f: int, t1: int, max_steps: int = 10 ** 9) -> str:
        hop = self.fe.hop
        s_chunk = self.chunk_frames * hop
        new_text: list[str] = []
        steps = 0
        dev = self._dev_engine
        while len(self._pending) >= s_chunk and steps < max_steps:
            take = self._pending[:s_chunk]
            lead = self._lead if self._lead is not None else _first_lead(take, hop)
            window = np.concatenate([lead, take])[None, :]
            base_w = self._k * self._delta - self._d1 - self._d2 \
                - max(self.cfg.lookahead_context - 1, 0)
            lo = max(0, -base_w)
            hi = min(self._delta, t1 - base_w)
            win_d, k_d, t_f_d, t1_d = _tick_inputs(self.device, window, [self._k], [t_f],
                                                   [t1])
            logits, carry1 = self._step(self._carry, win_d, k_d, t_f_d, t1_d)
            if dev is not None:
                # the beam advance is queued right behind the acoustic
                # step; the logits stay on the device
                len_v = np.asarray([max(hi - lo, 0)], np.int32)
                fetched, state1 = dev.advance_queued(logits, np.asarray([lo], np.int32),
                                                     len_v)
                rows = logits[0].cpu().numpy() if self.collect_logits else None
                # replace the carry and the beam state only after the
                # read-back succeeded: a failed tick can be retried
                self._carry, dev.state = carry1, state1
                dev.fold(*fetched, len_v)
                ids, frames = dev.take_committed(0)
                if ids:
                    self._committed = self._committed + tuple(ids)
                    self._offsets.extend(int(f) for f in frames)
                    new_text.append(self.alphabet.decode(ids))
            else:
                rows = logits[0].cpu().numpy()
                self._carry = carry1
                if self._native is not None and hi > lo:
                    frag0, self._committed, offs = _native_emit(
                        self._native, self._committed, rows, lo, hi, self.alphabet)
                elif self.decoder == "beam" and hi > lo:
                    frag0, self._beams, self._committed, offs = _beam_emit(
                        self._beams, self._committed, rows, lo, hi, self.alphabet,
                        self._beam_kw, base_w=base_w)
                else:
                    frag0, self._last_id, offs = _greedy_emit(
                        rows, lo, hi, self._last_id, self.alphabet.labels, self.blank_id,
                        base_w=base_w)
                self._offsets.extend(offs)
                if frag0:
                    new_text.append(frag0)
            self._pending = self._pending[s_chunk:]
            self._lead = window[0, -hop:].copy()
            self._k += 1
            if hi > lo:
                self._emitted = base_w + hi
                if self.collect_logits:
                    self._rows.append(rows[lo:hi])
            steps += 1
        frag = "".join(new_text)
        if frag:
            self._text_parts.append(frag)
        return frag


# ---------------------------------------------------------------------------
# Multi-stream serving: many live streams share one batched step
# ---------------------------------------------------------------------------


class _StreamSlot:
    """Host-side state of one live stream in a MultiStreamTranscriber."""

    __slots__ = ("pending", "lead", "recent", "n_samples", "k", "last_id",
                 "parts", "fresh", "emitted", "draining", "t_f", "t1",
                 "closed", "beams", "native", "committed", "offsets")

    def __init__(self):
        self.pending = np.zeros((0,), np.float32)
        self.lead = None
        self.recent = np.zeros((0,), np.float32)
        self.n_samples = 0
        self.k = 0
        self.last_id = -1  # set by the owner (blank_id)
        self.parts: list[str] = []
        self.fresh: list[str] = []
        self.emitted = 0
        self.draining = False
        self.t_f = 0
        self.t1 = 0
        self.closed = False
        self.beams = None  # beam mode, host engine: the live beam dict
        self.native = None  # beam mode, native engine: the slot's C++ session
        self.committed: tuple = ()  # beam mode: the stable emitted prefix
        self.offsets: list[int] = []  # per-char conv-frame offsets


class MultiStreamTranscriber:
    """Up to ``max_streams`` concurrent live streams decoded by one
    batched step a tick.

    Each stream advances on its own: per-row absolute positions (the
    ``k``/``t_f``/``t1`` vectors) drive the step's masks, and an
    ``active`` row mask freezes the carries of streams with no data this
    tick bit for bit, so each stream's results equal a single-stream
    ``StreamingTranscriber``'s.

    >>> mst = MultiStreamTranscriber(variables, cfg, fe, alphabet)
    >>> a, b = mst.open(), mst.open()
    >>> mst.feed(a, wave_a); mst.feed(b, wave_b)
    >>> while mst.tick(): pass
    >>> mst.flush(a); mst.text(a)

    Decoding is greedy or an incremental prefix beam per stream
    (``decoder="beam"``, optional word LM ``lm``; engines as
    ``StreamingTranscriber``'s). Thread safety is the caller's job
    (``serve.StreamSessionService`` holds one lock around every call).
    """

    _SENTINEL = 1 << 30

    def __init__(self, variables, model_cfg: ModelConfig,
                 frontend_cfg: FrontendConfig, alphabet,
                 max_streams: int = 8, chunk_frames: int = 32,
                 decoder: str = "greedy", lm=None, alpha: float = 0.8,
                 beta: float = 1.0, beam_width: int = 10,
                 cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
                 prune_logp: float = -20.0, beam_impl: str = "auto",
                 prime_stats: tuple | None = None, device: str = "cuda"):
        if model_cfg.bidirectional:
            raise ValueError("streaming needs a unidirectional model")
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder must be greedy|beam, got {decoder!r}")
        self.cfg = model_cfg
        self.fe = frontend_cfg
        self.alphabet = alphabet
        self.blank_id = alphabet.blank_id
        self.chunk_frames = chunk_frames
        self.max_streams = max_streams
        self.decoder = decoder
        self._beam_kw = dict(beam_width=beam_width, lm=lm, alpha=alpha,
                             beta=beta, cutoff_top_n=cutoff_top_n,
                             cutoff_prob=cutoff_prob, prune_logp=prune_logp)
        self.model = _as_model(variables, model_cfg, device)
        self._step = _Step(self.model, frontend_cfg, chunk_frames)
        self.device = self._step.device
        self._delta, self._d1, self._d2 = self._step.delta, self._step.d1, self._step.d2
        self.beam_impl = _resolve_beam_impl(decoder, beam_impl, self.device)
        self._dev_engine = (_device_engine(alphabet, self._beam_kw, max_streams,
                                           self._delta, self.device)
                            if self.beam_impl == "device" else None)
        # one C++ session per slot, reset when a stream opens on it
        self._natives = ([NativeBeamSession(alphabet, **self._beam_kw)
                          for _ in range(max_streams)]
                         if self.beam_impl == "native" else None)
        self._lahead = max(model_cfg.lookahead_context - 1, 0)
        self._init0 = _init_carry(model_cfg, frontend_cfg, max_streams, self.device,
                                  prime_stats)
        self._carry = self._init0
        self._slots: list[_StreamSlot | None] = [None] * max_streams

    # ---- session lifecycle ------------------------------------------------

    def open(self) -> int:
        """Claim a free stream slot and return its id; RuntimeError when
        all ``max_streams`` slots are live. The slot's carry rows (and
        beam rows) start from the initial values, the ``prime_stats``
        template included, as a fresh transcriber's would."""
        for i, s in enumerate(self._slots):
            if s is None:
                slot = _StreamSlot()
                slot.last_id = self.blank_id
                if self.decoder == "beam":
                    if self._dev_engine is not None:
                        self._dev_engine.reset_slot(i)
                    elif self._natives is not None:
                        slot.native = self._natives[i]
                        slot.native.reset()
                    else:
                        from tpuasr_torch.decode.beam_host import beam_init

                        slot.beams = beam_init()
                self._slots[i] = slot
                keep = torch.ones((self.max_streams,), dtype=torch.bool)
                keep[i] = False
                with torch.inference_mode():
                    self._carry = _carry_rows_select(
                        keep.to(self.device), self._carry, self._init0,
                        lstm=self.cfg.rnn_type == "lstm")
                return i
        raise RuntimeError(f"all {self.max_streams} stream slots in use")

    def close(self, sid: int) -> None:
        self._slots[sid] = None

    # ---- data plane -------------------------------------------------------

    def feed(self, sid: int, samples: np.ndarray) -> None:
        """Buffer samples for stream ``sid`` (no device work; tick()
        advances every stream holding a full chunk)."""
        s = self._require(sid)
        if s.closed or s.draining:
            raise RuntimeError("stream is closed; open() a new slot")
        samples = np.asarray(samples, np.float32).reshape(-1)
        s.pending = np.concatenate([s.pending, samples])
        s.n_samples += len(samples)
        s.recent = np.concatenate([s.recent, samples])[-(2 * self.fe.hop + 2):]

    def tick(self) -> bool:
        """Run one batched step over every stream holding a full chunk.
        Returns False (no device work) when none is ready."""
        hop = self.fe.hop
        s_chunk = self.chunk_frames * hop
        ready = []
        for i, s in enumerate(self._slots):
            if s is None or s.closed:
                continue
            if len(s.pending) < s_chunk and s.draining and s.emitted < s.t1:
                # draining slots pad themselves so the shared ticker
                # drives the drain; the zeros lie past t1 (masked), and
                # padding again after a failed step is a no-op
                s.pending = np.concatenate(
                    [s.pending, np.zeros((s_chunk - len(s.pending),), np.float32)])
            if len(s.pending) >= s_chunk:
                ready.append(i)
        if not ready:
            return False
        n = self.max_streams
        windows = np.zeros((n, s_chunk + hop), np.float32)
        k = np.zeros((n,), np.int64)
        t_f = np.full((n,), self._SENTINEL, np.int64)
        t1 = np.full((n,), self._SENTINEL, np.int64)
        active = np.zeros((n,), np.int64)
        lo_v = np.zeros((n,), np.int32)
        len_v = np.zeros((n,), np.int32)
        bounds = {}
        for i in ready:
            # no slot changes before the device step succeeds: a failed
            # step (retried by the serving ticker) must not consume audio
            # or desync lead/k/carry
            s = self._slots[i]
            lead = s.lead if s.lead is not None else _first_lead(s.pending[:s_chunk], hop)
            windows[i, :hop] = lead
            windows[i, hop:] = s.pending[:s_chunk]
            k[i] = s.k
            active[i] = 1
            if s.draining:
                t_f[i], t1[i] = s.t_f, s.t1
            base_w = s.k * self._delta - self._d1 - self._d2 - self._lahead
            cap = s.t1 if s.draining else self._SENTINEL
            lo = max(0, -base_w)
            hi = min(self._delta, cap - base_w)
            lo_v[i], len_v[i] = lo, max(hi - lo, 0)
            bounds[i] = (base_w, lo, hi)
        win_d, k_d, t_f_d, t1_d, act_d = _tick_inputs(self.device, windows, k, t_f, t1,
                                                      active)
        logits, carry1 = self._step(self._carry, win_d, k_d, t_f_d, t1_d, act_d.bool())
        dev = self._dev_engine
        if dev is not None:
            # one read-back a tick (backpointers and scores); the carry
            # and the beam state change only after it succeeded
            fetched, state1 = dev.advance_queued(logits, lo_v, len_v)
            self._carry, dev.state = carry1, state1
            dev.fold(*fetched, len_v)
        else:
            rows_all = logits.cpu().numpy()
            self._carry = carry1
        for i in ready:
            s = self._slots[i]
            s.pending = s.pending[s_chunk:]
            s.lead = windows[i, -hop:].copy()
            s.k += 1
            base_w, lo, hi = bounds[i]
            if hi <= lo:
                continue
            if dev is not None:
                ids, frames = dev.take_committed(i)
                frag = self.alphabet.decode(ids) if ids else ""
                s.committed = s.committed + tuple(ids)
                offs = [int(f) for f in frames]
            elif s.native is not None:
                frag, s.committed, offs = _native_emit(s.native, s.committed, rows_all[i],
                                                       lo, hi, self.alphabet)
            elif self.decoder == "beam":
                frag, s.beams, s.committed, offs = _beam_emit(
                    s.beams, s.committed, rows_all[i], lo, hi, self.alphabet,
                    self._beam_kw, base_w=base_w)
            else:
                frag, s.last_id, offs = _greedy_emit(
                    rows_all[i], lo, hi, s.last_id, self.alphabet.labels,
                    self.blank_id, base_w=base_w)
            s.offsets.extend(offs)
            if frag:
                s.parts.append(frag)
                s.fresh.append(frag)
            s.emitted = base_w + hi
        return True

    # ---- results ----------------------------------------------------------

    def text(self, sid: int) -> str:
        return "".join(self._require(sid).parts)

    def offsets(self, sid: int) -> np.ndarray:
        """Per-character conv-frame offsets (as StreamingTranscriber's)."""
        return np.asarray(self._require(sid).offsets, np.int64)

    def take_text(self, sid: int) -> str:
        """Newly finalized text since the last take_text."""
        s = self._require(sid)
        frag = "".join(s.fresh)
        s.fresh = []
        return frag

    def flush(self, sid: int) -> str:
        """End of stream ``sid``: drain its pipeline (other ready streams
        advance on the same ticks) and return its remaining text. The
        slot stays readable through text()/take_text() until close().
        It is begin_flush, tick until flush_done, then the final
        readout, so a serving layer can let its ticker drive the drain."""
        s = self._require(sid)
        if s.closed:
            return ""
        before = len(s.parts)
        self.begin_flush(sid)
        while not self.flush_done(sid):
            self.tick()
        return self._finalize(sid, s, before)

    def begin_flush(self, sid: int) -> None:
        """Mark the end of the stream: fix t_f/t1 from the samples fed so
        far and queue the reflected tail. Idempotent; later tick()s pad
        and advance the drain until flush_done()."""
        s = self._require(sid)
        if s.closed or s.draining:
            return
        hop = self.fe.hop
        s.t_f = 1 + s.n_samples // hop
        s.t1 = (s.t_f - 1) // 2 + 1
        s.draining = True
        tail = _reflect_tail(s.recent, s.n_samples, s.t_f, hop, self.fe.n_fft // 2,
                             4 * self.chunk_frames * hop)
        s.pending = np.concatenate([s.pending, tail])

    def flush_done(self, sid: int) -> bool:
        """True once every frame up to t1 was emitted (or the slot is
        finalized)."""
        s = self._require(sid)
        return s.closed or (s.draining and s.emitted >= s.t1)

    def finalize_flush(self, sid: int) -> str:
        """The final readout after the drain; returns the full final
        text. Idempotent once closed."""
        s = self._require(sid)
        if not s.closed:
            self._finalize(sid, s, 0)
        return "".join(s.parts)

    def _finalize(self, sid: int, s: _StreamSlot, before: int) -> str:
        """Beam readout and close; returns the text final since
        ``before`` (the full text on a beam retraction)."""
        if self.decoder == "beam":
            committed_text = "".join(s.parts)
            if self._dev_engine is not None or s.native is not None:
                ids, frames, _ = (self._dev_engine.finalize(sid) if s.native is None
                                  else s.native.best_with_frames())
                final = self.alphabet.decode([int(x) for x in ids])
                extra = (final[len(committed_text):]
                         if final.startswith(committed_text) else final)
            else:
                extra, final, frames = _beam_final(s.beams, committed_text, self.alphabet,
                                                   self._beam_kw)
            if final.startswith(committed_text):
                if extra:
                    s.parts.append(extra)
                    s.fresh.append(extra)
                    s.offsets.extend(int(x) for x in frames[len(committed_text):])
            else:  # rare retraction: the final text is authoritative
                s.parts = [final]
                s.fresh = [final]
                s.offsets = [int(x) for x in frames]
                s.closed = True
                return final
        s.closed = True
        return "".join(s.parts[before:])

    def _require(self, sid: int) -> _StreamSlot:
        s = self._slots[sid] if 0 <= sid < self.max_streams else None
        if s is None:
            raise KeyError(f"no open stream {sid}")
        return s
