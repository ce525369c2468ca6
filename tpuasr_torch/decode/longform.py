"""Long-form audio decoding (port of ``tpuasr/decode/longform.py``).

Every utterance is padded up to the static bucket ladder
(``pad_to_ladder``); audio longer than the last bucket is decoded as
overlapping ladder-sized chunks whose center-cut logits are stitched on
host (``longform_logits``) and decoded by a host decoder: the numpy
greedy collapse, or the host prefix beam with word-LM fusion for every
beam decoder. Each interior
boundary is cut at the overlap's midpoint, so every output frame comes
from a chunk where it sits at least overlap/2 from a chunk edge. The
chunks share the serving batch shapes, so long audio adds no new
shapes.
"""

from __future__ import annotations

import numpy as np

from tpuasr_torch.data.buckets import BucketSpec
from tpuasr_torch.decode.beam import DeviceBeamDecoder
from tpuasr_torch.decode.beam_host import BeamCTCDecoder, beam_init, beam_results, beam_step
from tpuasr_torch.decode.greedy import GreedyDecoder
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model.ds2 import CONV_SPECS


def pad_to_ladder(wave: np.ndarray, spec: BucketSpec) -> tuple[np.ndarray, int]:
    """Pad one wave UP to the smallest ladder bucket that fits (never
    truncates). Returns (padded wave, true length)."""
    n = len(wave)
    cap = spec.bucket_samples(spec.n_buckets - 1)
    if n > cap:
        raise ValueError(
            f"wave of {n} samples exceeds the bucket ladder cap {cap}; "
            "use the long-form chunked path (decode/longform.py)"
        )
    b = spec.bucket_of(n / spec.sample_rate)
    out = np.zeros((spec.bucket_samples(b),), wave.dtype)
    out[:n] = wave
    return out, n


def samples_per_frame(frontend_cfg=None) -> int:
    """Samples per model OUTPUT frame: frontend hop x total conv time
    stride."""
    if frontend_cfg is None:
        hop = 160  # 10 ms at 16 kHz
    else:
        hop = int(round(frontend_cfg.window_stride * frontend_cfg.sample_rate))
    stride = 1
    for (_, _, st, _, _, _) in CONV_SPECS:
        stride *= st
    return hop * stride


def chunk_plan(n: int, spec: BucketSpec, overlap_seconds: float = 2.0,
               spf: int = 320) -> list[tuple[int, int, int, int]]:
    """Split an n-sample wave into last-bucket-sized overlapping chunks.
    Returns [(start, length, keep_lo, keep_hi)] with keep_* local sample
    offsets; the kept regions tile [0, n) exactly. The overlap is
    quantized to an even multiple of ``spf`` so every chunk start and
    cut point is frame-aligned with the full-length run."""
    sr = spec.sample_rate
    l_max = spec.bucket_samples(spec.n_buckets - 1)
    if n <= l_max:
        return [(0, n, 0, n)]
    l_eff = (l_max // spf) * spf  # frame-aligned chunk length
    ov = int(round(overlap_seconds * sr / (2 * spf))) * 2 * spf
    if not 0 < ov < l_eff // 2:
        raise ValueError(
            f"overlap {overlap_seconds}s must quantize to a positive "
            f"multiple of {2 * spf} samples under half the "
            f"{l_eff / sr:.1f}s chunk"
        )
    hop = l_eff - ov
    half = ov // 2
    plans = []
    for i, s in enumerate(range(0, n - ov, hop)):
        e = min(s + l_eff, n)
        lo = half if i > 0 else 0
        hi = (e - s) if e == n else l_eff - half
        plans.append((s, e - s, lo, hi))
        if e == n:
            break
    return plans


def eval_chunks(eval_step, chunks: list[np.ndarray], spec: BucketSpec,
                batch_size: int = 1) -> list[tuple[int, np.ndarray]]:
    """Run the eval step over wave chunks, padded up to static
    (batch_size, ladder-bucket) shapes. Returns per chunk
    (out_length, logits (T', C) float32 numpy sliced to out_length)."""
    out: list = [None] * len(chunks)
    by_bucket: dict = {}
    for i, w in enumerate(chunks):
        b = spec.bucket_of(len(w) / spec.sample_rate)
        by_bucket.setdefault(b, []).append(i)
    for b, idxs in by_bucket.items():
        l_bucket = spec.bucket_samples(b)
        for s in range(0, len(idxs), batch_size):
            group = idxs[s: s + batch_size]
            arr = np.zeros((batch_size, l_bucket), np.float32)
            lens = np.zeros((batch_size,), np.int32)
            for j, i in enumerate(group):
                arr[j, : len(chunks[i])] = chunks[i]
                lens[j] = len(chunks[i])
            logits, out_lengths = eval_step(arr, lens)
            logits = logits.float().cpu().numpy()
            out_lengths = out_lengths.cpu().numpy()
            for j, i in enumerate(group):
                t = int(out_lengths[j])
                out[i] = (t, logits[j, :t])
    return out


def longform_logits(eval_step, wave: np.ndarray, spec: BucketSpec,
                    overlap_seconds: float = 2.0, batch_size: int = 1,
                    spf: int = 320) -> np.ndarray:
    """Assembled (T_total, C) float32 logits for a wave of ANY length."""
    plan = chunk_plan(len(wave), spec, overlap_seconds, spf)
    chunks = [np.asarray(wave[s: s + n], np.float32) for s, n, _, _ in plan]
    outs = eval_chunks(eval_step, chunks, spec, batch_size)
    pieces = []
    for (s, n, lo, hi), (t, lg) in zip(plan, outs):
        # cut points are spf-aligned, so sample -> frame is x // spf
        f_lo = min(lo // spf, t)
        f_hi = t if hi == n else min(hi // spf, t)
        pieces.append(lg[f_lo:f_hi])
    return np.concatenate(pieces, axis=0)


def greedy_decode_host(logits: np.ndarray, alphabet: Alphabet):
    """Numpy argmax-collapse of one (T, C) sequence. Returns (text,
    frame offsets)."""
    ids = logits.argmax(axis=-1)
    prev = np.concatenate(([-1], ids[:-1]))
    emit = (ids != alphabet.blank_id) & (ids != prev)
    frames = np.nonzero(emit)[0]
    return alphabet.decode(ids[frames]), frames


def _log_softmax_np(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return x - m - np.log(e.sum(axis=-1, keepdims=True))


def _host_beam_with_offsets(logprobs: np.ndarray, alphabet: Alphabet,
                            **kw) -> tuple[str, np.ndarray]:
    """Host prefix-beam over assembled (T, C) logprobs returning
    (stripped text, per-char emission frames)."""
    beams = beam_init()
    for t in range(logprobs.shape[0]):
        beams = beam_step(beams, logprobs[t], alphabet, t=t, **kw)
    res = beam_results(beams, alphabet, lm=kw.get("lm"),
                       alpha=kw.get("alpha", 0.8), beta=kw.get("beta", 1.0),
                       with_offsets=True)
    if not res:
        return "", np.array([], np.int64)
    text, _, frames = res[0]
    lpad = len(text) - len(text.lstrip())
    rpad = len(text) - len(text.rstrip())
    return text.strip(), (frames[lpad: len(frames) - rpad]
                          if rpad else frames[lpad:])


def host_decode(decoder, logits: np.ndarray, alphabet: Alphabet):
    """Decode assembled long-form logits (T, C) with the host analogue
    of the configured decoder. Returns (text, per-char frame offsets)
    for greedy and every beam decoder: the device beam's long-form
    analogue is the host beam it is tested against."""
    if decoder is None or isinstance(decoder, GreedyDecoder):
        return greedy_decode_host(logits, alphabet)

    logprobs = _log_softmax_np(logits.astype(np.float64)).astype(np.float32)
    if isinstance(decoder, BeamCTCDecoder):
        return _host_beam_with_offsets(
            logprobs, alphabet, beam_width=decoder.beam_width,
            lm=decoder.lm, alpha=decoder.alpha, beta=decoder.beta,
            cutoff_top_n=decoder.cutoff_top_n,
            cutoff_prob=decoder.cutoff_prob,
        )
    if isinstance(decoder, DeviceBeamDecoder):
        if decoder._lm_tables is not None:
            raise ValueError(
                "long-form decode with a char-level device LM is not "
                "supported; use --device-lm-level word, --decoder beam, "
                "or greedy for long audio"
            )
        return _host_beam_with_offsets(
            logprobs, alphabet, beam_width=decoder.cfg.beam_width,
            lm=decoder.word_lm,
            alpha=decoder.cfg.alpha, beta=decoder.cfg.beta,
            cutoff_top_n=decoder.cfg.cutoff_top_n,
            cutoff_prob=decoder.cfg.cutoff_prob,
            prune_logp=decoder.cfg.prune_logp,
        )
    raise TypeError(f"no host long-form path for {type(decoder).__name__}")


def transcribe_longform(eval_step, wave: np.ndarray, alphabet: Alphabet,
                        spec: BucketSpec, decoder=None,
                        overlap_seconds: float = 2.0, batch_size: int = 1,
                        spf: int = 320):
    """One wave of any length -> (text, frame offsets)."""
    logits = longform_logits(eval_step, wave, spec, overlap_seconds,
                             batch_size, spf)
    return host_decode(decoder, logits, alphabet)
