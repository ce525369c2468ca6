"""Batch-serving entry: ``serve.TranscriptionService.transcribe_wave``
in-process at the mix's ``ServeConfig``, greedy decoding, under an
open-loop Poisson stream of requests at the mix's fixed rate.

Set-up builds the service, puts the seed's weights into its model, warms
every bucket the mix's lengths reach, makes the clip pool, and collects
the garbage that set-up left (``gc.collect``), so that the window does
not pay for it. The window sends each request when it is due, from a
dispatcher thread to a pool of client threads, and times it from when
it was due until its text returns; it closes when the last request is
due and then waits for every request (a minute at most). The harness
keeps nothing per request that the collector tracks: times go into
preallocated arrays, and only the requests drawn for the check keep
their text. ``--trace 1`` traces the mix's ``trace_seconds`` of the same
stream instead.

``correct``: a sample of the requests drawn from the seed before the
window, the longest clip's among them, goes through the reference
(``lib/reference.py``) in float32 once they have finished; the widest
gap by which a served frame's class lies below the reference's best
logit (``reference.greedy_gap``) is compared.
"""

from __future__ import annotations

import gc
import queue
import sys
import threading
import time

import numpy as np

from benchmark.lib import bounds
from benchmark.lib.harness import Context, Result, percentile, traced_window
from benchmark.lib.traffic import make_corpus, open_loop_schedule, rng_of
from benchmark.lib.weights import make_weights

WAIT_AFTER_CLOSE_S = 60.0
SLICE_S = 10.0  # the tail is also printed by slices of the window


def build_service(ctx: Context, seed: int):
    """The program's service with the seed's weights, every bucket the
    mix reaches warmed."""
    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.compat.weights import to_jax_variables
    from tpuasr_torch.data.buckets import BucketSpec
    from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
    from tpuasr_torch.serve import ServeConfig, TranscriptionService
    from tpuasr_torch.train.checkpoint import CheckpointPackage

    mix = ctx.mix
    model_cfg = ModelConfig(**ctx.cfg["model"])
    pkg = CheckpointPackage(model_cfg, FrontendConfig(), ctx.cfg["labels"],
                            to_jax_variables(DeepSpeech2(model_cfg)))
    svc = TranscriptionService(None, ServeConfig(
        max_batch=mix["max_batch"], batch_window_ms=mix["batch_window_ms"],
        max_seconds=mix["max_seconds"]), package=pkg, device=ctx.device)
    set_weights(svc, ctx, seed)
    spec = BucketSpec()
    lo, hi = spec.bucket_of(mix["length_min_s"]), spec.bucket_of(mix["length_max_s"])
    for b in range(lo, hi + 1):
        svc.warmup(spec.seconds[b])
    return svc


def set_weights(svc, ctx: Context, seed: int) -> dict:
    shapes = {k: tuple(v.shape) for k, v in svc.model.state_dict().items()}
    weights = make_weights(shapes, seed, ctx.device, ctx.mix.get("head_gain", 1.0))
    svc.model.load_state_dict(weights)
    return weights


def check_requests(which: np.ndarray, samples: np.ndarray, n: int, seed: int) -> list:
    """The requests whose text the check reads: ``n`` drawn from the
    seed, and a request of the longest clip among them."""
    pick = [int(i) for i in rng_of(seed, 13).permutation(len(which))[:n]]
    longest = int(np.argmax(samples[which]))
    if longest not in pick:
        pick[-1] = longest
    return pick


class FullPasses:
    """The collector's full passes (generation 2) while registered: how
    many, the longest and their sum, in seconds."""

    def __init__(self):
        self.count, self.longest, self.total, self._start = 0, 0.0, 0.0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._start = time.perf_counter()
            return
        d = time.perf_counter() - self._start
        self.count, self.total, self.longest = self.count + 1, self.total + d, max(self.longest, d)


def serve_window(svc, clips: list, due: np.ndarray, which: np.ndarray, threads: int,
                 keep=()) -> dict:
    """Send request i (clip ``which[i]``) at ``due[i]`` seconds after the
    start. Returns arrays over the requests: ``late`` (s from due to
    the call) and ``latency`` (s from due to the text, NaN where it
    failed), ``kept`` {i: (text, offsets)} for the requests in ``keep``,
    and the collector's full passes in the window (``gc``)."""
    n = len(due)
    late, latency = np.full(n, np.nan), np.full(n, np.nan)
    keep, kept = frozenset(keep), {}
    todo: queue.SimpleQueue = queue.SimpleQueue()
    t0 = 0.0

    def client() -> None:
        while (i := todo.get()) is not None:
            late[i] = time.perf_counter() - t0 - due[i]
            try:
                text, offsets = svc.transcribe_wave(clips[which[i]], timeout=WAIT_AFTER_CLOSE_S)
            except (TimeoutError, RuntimeError, ValueError):
                continue
            latency[i] = time.perf_counter() - t0 - due[i]
            if i in keep:
                kept[i] = (text, offsets)

    workers = [threading.Thread(target=client, daemon=True) for _ in range(threads)]
    for w in workers:
        w.start()
    passes = FullPasses()
    gc.callbacks.append(passes)
    try:
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            todo.put(i)
        for _ in workers:
            todo.put(None)
        for w in workers:
            w.join()
    finally:
        gc.callbacks.remove(passes)
    return {"late": late, "latency": latency, "kept": kept, "gc": passes}


def run(ctx: Context) -> Result:
    import torch

    mix, res = ctx.mix, Result()
    svc = build_service(ctx, ctx.seed)
    weights = {k: v.detach().clone() for k, v in svc.model.state_dict().items()}
    corpus = make_corpus(mix["clips"], mix, ctx.seed, ctx.device)
    clips = [p.astype(np.float32) / 32768.0 for p in corpus.pcm]
    seconds = mix["trace_seconds"] if ctx.trace else ctx.seconds
    due, which = open_loop_schedule(mix["rate_per_s"], seconds, len(clips), ctx.seed)
    sample = check_requests(which, corpus.samples, mix["check_requests"], ctx.seed)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    gc.collect()
    with traced_window(ctx.trace, ctx.name) as summary:
        res.e2e["setup_s"] = time.perf_counter() - ctx.t0
        out = serve_window(svc, clips, due, which, mix["client_threads"], sample)
    lat = np.where(np.isnan(out["latency"]), np.inf, out["latency"])
    res.attempted, res.failed = len(lat), int(np.isinf(lat).sum())
    res.e2e["serve_p95_ms"] = 1e3 * percentile(lat.tolist(), 95)
    passes = out["gc"]
    print(f"generator: sent {len(lat)} succeeded {len(lat) - res.failed} failed {res.failed} "
          f"late p50 {1e3 * np.nanpercentile(out['late'], 50):.3f} ms "
          f"max {1e3 * np.nanmax(out['late']):.3f} ms "
          f"latency p50 {1e3 * percentile(lat.tolist(), 50):.3f} ms; "
          f"collector full passes {passes.count} longest {1e3 * passes.longest:.1f} ms "
          f"total {1e3 * passes.total:.1f} ms", file=sys.stderr, flush=True)
    slices = [1e3 * percentile(lat[(due >= t) & (due < t + SLICE_S)].tolist(), 95)
              for t in np.arange(0.0, seconds, SLICE_S)]
    print(f"generator: p95 by {SLICE_S:g} s of due time (ms) "
          f"{' '.join(f'{v:.1f}' for v in slices)}",
          file=sys.stderr, flush=True)
    frames = bounds.conv_out_frames(bounds.frames_of_samples(corpus.samples))
    res.work = {"entry": "serve", "cfg": ctx.cfg["model"], "trace": summary,
                "request_frames": frames[which].tolist()}
    if ctx.device.type == "cuda":
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))
    svc.close()
    del svc
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    gap = served_gap(ctx, weights, corpus, which, out["kept"], sample)
    res.checks = [("served_logit_gap", gap, ctx.limits["served_logit_gap"])]
    return res


def reference_logits(ctx: Context, weights: dict, pcm: list, quant=None):
    """The reference's logits for the clips, in one batch (evaluation
    BatchNorm: a row's logits do not depend on the others)."""
    import torch

    from benchmark.lib.reference import features, forward, no_tf32

    no_tf32()
    with torch.no_grad():
        feats, lengths = features(pcm, device=ctx.device)
        logits, out_len = forward(ctx.cfg["model"], weights, feats, lengths, train=False,
                                  quant=quant)
    return logits.cpu(), out_len.cpu()


def served_gap(ctx: Context, weights: dict, corpus, which: np.ndarray, kept: dict,
               sample: list) -> float:
    """The widest gap over the sampled requests; infinite where one of
    them has no text or text that the alphabet cannot hold."""
    from benchmark.lib.reference import greedy_gap

    if any(i not in kept for i in sample):
        return float("inf")
    logits, out_len = reference_logits(ctx, weights, [corpus.pcm[which[i]] for i in sample])
    index = {ch: i for i, ch in enumerate(ctx.cfg["labels"])}
    worst = 0.0
    for j, i in enumerate(sample):
        text, offsets = kept[i]
        if any(ch not in index for ch in text) or len(text) != len(offsets):
            return float("inf")
        chars = [index[ch] for ch in text]
        worst = max(worst, greedy_gap(logits[j], int(out_len[j]), list(offsets), chars))
    return worst


def greedy_path(logits, frames: int, blank: int = 0):
    """A greedy best path's text classes and offsets from (T, C) logits."""
    ids = logits[:frames].argmax(-1).tolist()
    chars, offsets, prev = [], [], -1
    for f, c in enumerate(ids):
        if c != blank and c != prev:
            chars.append(c)
            offsets.append(f)
        prev = c
    return chars, offsets


def control_readings(ctx: Context, keep: dict, with_control: bool) -> dict:
    """The readings that the limit is set from, for one seed: the served
    gap of a short window (``ctx.seconds``) at the cell's own rate and,
    with ``with_control``, the control's: the reference in float8 put in
    the program's place on the same sampled requests, its greedy path
    read against the float32 reference. The service is built once and
    takes each seed's weights."""
    from benchmark.lib.reference import greedy_gap

    if "svc" not in keep:
        keep["svc"] = build_service(ctx, ctx.seed)
    svc = keep["svc"]
    weights = set_weights(svc, ctx, ctx.seed)
    mix = ctx.mix
    corpus = make_corpus(mix["clips"], mix, ctx.seed, ctx.device)
    clips = [p.astype(np.float32) / 32768.0 for p in corpus.pcm]
    due, which = open_loop_schedule(mix["rate_per_s"], ctx.seconds, len(clips), ctx.seed)
    sample = check_requests(which, corpus.samples, mix["check_requests"], ctx.seed)
    win = serve_window(svc, clips, due, which, mix["client_threads"], sample)
    out = {"program": {
        "served_logit_gap": served_gap(ctx, weights, corpus, which, win["kept"], sample),
        "failed": int(np.isnan(win["latency"]).sum())}}
    if with_control:
        pcm = [corpus.pcm[which[i]] for i in sample]
        ref, n = reference_logits(ctx, weights, pcm)
        low, _ = reference_logits(ctx, weights, pcm, quant="fp8")
        worst = 0.0
        for j in range(len(sample)):
            chars, offsets = greedy_path(low[j], int(n[j]))
            worst = max(worst, greedy_gap(ref[j], int(n[j]), offsets, chars))
        out["control_fp8"] = {"served_logit_gap": worst}
    return out
