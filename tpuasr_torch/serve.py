"""Batch transcription service (port of ``tpuasr/serve.py``).

Requests (WAV bytes or waves) land in a queue; one device worker drains
up to ``max_batch`` of them within ``batch_window_ms``, pads the batch
to ``max_batch`` rows and to a static duration bucket
(``tpuasr_torch.data.buckets.BucketSpec``), runs the eval step (frontend
+ DS2 with its Hopper RNN kernel: K1 or K5 for a GRU, K4 for an LSTM)
and decodes with the configured decoder: greedy by default, the host
beam, or ``DeviceBeamDecoder`` (one K3 launch per batch). Padding rows
have length 0. Audio beyond ``max_seconds`` follows ``long_audio``:
chunked long-form decode, reject, or explicit truncation.

Live-stream sessions (``StreamSessionService``, unidirectional models):
many concurrent streams share one batched streaming step
(``tpuasr_torch.stream.MultiStreamTranscriber``) driven by one ticker
thread.

HTTP wrapper (``make_http_server``): POST /transcribe with a WAV body ->
{"text": ..., "offsets": [...]}; GET /healthz; with a stream service,
POST /stream/open, /stream/<id>/feed and /stream/<id>/close.
"""

from __future__ import annotations

import dataclasses
import io
import json
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
from scipy.io import wavfile

from tpuasr_torch.audio.io import resample_poly_host
from tpuasr_torch.compat.weights import model_from_variables
from tpuasr_torch.data.buckets import BucketSpec
from tpuasr_torch.decode.greedy import GreedyDecoder
from tpuasr_torch.decode.longform import samples_per_frame, transcribe_longform
from tpuasr_torch.device import resolve_device
from tpuasr_torch.profiling import count, sample, span, tracing
from tpuasr_torch.train.checkpoint import load_checkpoint
from tpuasr_torch.train.step import make_eval_step


@dataclass
class ServeConfig:
    max_batch: int = 32
    batch_window_ms: float = 10.0
    max_seconds: float = 16.5
    # "chunk" | "reject" | "truncate" for audio beyond max_seconds
    long_audio: str = "chunk"
    chunk_overlap: float = 2.0
    # request durations (s) run once at startup, before traffic
    warmup_seconds: tuple = ()


class TranscriptionService:
    """Checkpoint -> ready-to-serve transcriber with micro-batching."""

    def __init__(self, model_path: str, cfg: ServeConfig | None = None,
                 decoder=None, package=None, device: str = "cuda",
                 rnn_impl: str | None = None):
        """``rnn_impl`` overrides the checkpoint's (``pallas2`` runs a
        GRU checkpoint through K5)."""
        self.device = resolve_device(device)
        self.cfg = cfg or ServeConfig()
        pkg = package if package is not None else load_checkpoint(model_path)
        self.alphabet = pkg.alphabet
        self.frontend_cfg = pkg.frontend_config
        model_cfg = pkg.model_config
        if rnn_impl:
            model_cfg = dataclasses.replace(model_cfg, rnn_impl=rnn_impl)
        self.model = model_from_variables(pkg.variables, model_cfg, self.device)
        # (waves, lengths) -> (logits, out_lengths) on the device
        self.eval_step = make_eval_step(self.model, self.frontend_cfg)
        self.decoder = decoder or GreedyDecoder(self.alphabet)
        self.spec = BucketSpec(sample_rate=self.frontend_cfg.sample_rate)

        for sec in self.cfg.warmup_seconds:
            self.warmup(sec)

        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    def warmup(self, seconds: float) -> None:
        """Run the (bucket, max_batch) shape a request of this duration
        hits — eval forward and decoder — before traffic (builds the
        CUDA kernels, K3 too with a device beam decoder, and lets cuDNN
        pick its algorithms)."""
        cap = int(self.cfg.max_seconds * self.spec.sample_rate)
        n = min(int(seconds * self.spec.sample_rate), cap)
        l_bucket = self.spec.bucket_samples(
            self.spec.bucket_of(n / self.spec.sample_rate))
        arr = np.zeros((self.cfg.max_batch, l_bucket), np.float32)
        lengths = np.full((self.cfg.max_batch,), n, np.int32)
        logits, out_lengths = self.eval_step(arr, lengths)
        self.decoder.decode(logits, out_lengths, return_offsets=True)

    # ---------- public API ----------

    def transcribe_wave(self, wave: np.ndarray, timeout: float = 60.0):
        """Blocking single-utterance call (thread-safe): enqueue and
        wait; the worker micro-batches concurrent callers together."""
        cap = int(self.cfg.max_seconds * self.spec.sample_rate)
        wave = wave.astype(np.float32)
        if len(wave) > cap:
            if self.cfg.long_audio == "reject":
                raise ValueError(
                    f"audio of {len(wave) / self.spec.sample_rate:.1f}s "
                    f"exceeds the {self.cfg.max_seconds}s serving cap "
                    "(long_audio='reject')"
                )
            if self.cfg.long_audio == "truncate":
                wave = wave[:cap]
        done = threading.Event()
        slot: dict = {}
        if tracing():
            slot["t_enq"] = time.perf_counter_ns()
        self._queue.put((wave, slot, done))
        if not done.wait(timeout):
            raise TimeoutError("transcription timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["text"], slot["offsets"]

    def transcribe_wav_bytes(self, data: bytes, timeout: float = 60.0):
        # scipy.io/scipy.signal are imported with the module: imported
        # here, the first burst of requests waited ~2.8 s on the import
        # (PERF.md)
        sr, wave = wavfile.read(io.BytesIO(data))
        if wave.dtype == np.int16:
            wave = wave.astype(np.float32) / 32768.0
        elif wave.dtype != np.float32:
            wave = wave.astype(np.float32)
        if wave.ndim > 1:
            wave = wave.mean(axis=1)
        if sr != self.frontend_cfg.sample_rate:
            wave = resample_poly_host(wave, sr, self.frontend_cfg.sample_rate)
        return self.transcribe_wave(wave, timeout=timeout)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # ---------- worker ----------

    def _collect(self):
        """Block for one request, then drain up to max_batch within the
        batching window (span ``serve.collect``), sampling each traced
        request's queue wait (``serve.queue_wait_s``) as the batch
        closes."""
        try:
            first = self._queue.get(timeout=0.2)
        except queue.Empty:
            return []
        with span("serve.collect"):
            batch = [first]
            deadline = time.time() + self.cfg.batch_window_ms / 1e3
            while len(batch) < self.cfg.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            if tracing():
                now = time.perf_counter_ns()
                for _, slot, _ in batch:
                    if "t_enq" in slot:
                        sample("serve.queue_wait_s", (now - slot.pop("t_enq")) / 1e9)
        return batch

    def _serve_loop(self):
        cap = int(self.cfg.max_seconds * self.spec.sample_rate)
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            short = [r for r in batch if len(r[0]) <= cap]
            long_ = [r for r in batch if len(r[0]) > cap]
            if short:
                try:
                    self._serve_batch(short)
                except Exception as exc:  # report, never wedge callers
                    for _, slot, done in short:
                        slot["error"] = repr(exc)
                        done.set()
            if long_:
                self._serve_longform(long_)

    def _serve_batch(self, requests: list) -> None:
        """One padded batch of ``max_batch`` rows at the bucket of its
        longest wave: spans ``serve.pad``, ``serve.forward``, the
        decoder's, ``serve.respond``; counters ``serve.batches``,
        ``serve.rows``, ``serve.real_samples`` and
        ``serve.computed_samples`` (``max_batch`` x the bucket's)."""
        with span("serve.pad"):
            waves, slots, dones = zip(*requests)
            n_max = max(len(w) for w in waves)
            b_idx = self.spec.bucket_of(n_max / self.spec.sample_rate)
            l_bucket = self.spec.bucket_samples(b_idx)
            bsz = self.cfg.max_batch  # static batch dim
            arr = np.zeros((bsz, l_bucket), np.float32)
            lengths = np.zeros((bsz,), np.int32)
            for j, w in enumerate(waves):
                arr[j, : len(w)] = w
                lengths[j] = len(w)
            if tracing():
                count("serve.batches")
                count("serve.rows", len(waves))
                count("serve.real_samples", int(lengths.sum()))
                count("serve.computed_samples", bsz * l_bucket)
        with span("serve.forward"):
            logits, out_lengths = self.eval_step(arr, lengths)
        texts, offsets = self.decoder.decode(logits, out_lengths, return_offsets=True)
        with span("serve.respond"):
            for j, (slot, done) in enumerate(zip(slots, dones)):
                slot["text"] = texts[j]
                slot["offsets"] = np.asarray(offsets[j]).tolist()
                done.set()

    def _serve_longform(self, requests: list) -> None:
        """Long-form requests: overlapping ladder-sized chunks through the
        same (max_batch, bucket) shapes, stitched and decoded on host."""
        for wave, slot, done in requests:
            try:
                text, frames = transcribe_longform(
                    self.eval_step, wave, self.alphabet, self.spec,
                    self.decoder, overlap_seconds=self.cfg.chunk_overlap,
                    batch_size=self.cfg.max_batch,
                    spf=samples_per_frame(self.frontend_cfg),
                )
                slot["text"] = text
                slot["offsets"] = np.asarray(frames).tolist()
            except Exception as exc:
                slot["error"] = repr(exc)
            done.set()


# ---------------------------------------------------------------------------
# Live-stream sessions (unidirectional models): many concurrent streams
# share one batched streaming step (tpuasr_torch.stream.MultiStreamTranscriber)
# ---------------------------------------------------------------------------


@dataclass
class StreamServeConfig:
    max_streams: int = 8
    chunk_frames: int = 32
    # ticker cadence when no stream has a full chunk buffered
    idle_sleep_ms: float = 5.0
    # a session silent for this long is force-closed (slot leak guard)
    session_timeout_s: float = 300.0
    # "greedy" or "beam" (incremental prefix beam per session, optional
    # word-LM fusion through lm_path)
    decoder: str = "greedy"
    # beam engine: "auto" = K3 on the device (CUDA) or the host beam (CPU)
    beam_impl: str = "auto"
    lm_path: str | None = None
    alpha: float = 0.8
    beta: float = 1.0
    beam_width: int = 10
    cutoff_top_n: int = 40
    cutoff_prob: float = 1.0
    # optional (mean, var, weight_frames): prime the causal normalization
    # with corpus statistics (stream._init_carry)
    prime_stats: tuple | None = None


class StreamSessionService:
    """HTTP sessions over a ``MultiStreamTranscriber``.

    One ticker thread batches every live session into shared device
    steps; ``feed`` only buffers samples and reads back text already
    final, so a request never waits for device work. Every call into the
    transcriber (device work included) holds the service's lock, so the
    ticker, the request threads and a ``TranscriptionService`` sharing
    ``package=``/``variables=`` (its model) never interleave calls into
    it.

    Session ids are generation-stamped (``gen * max_streams + slot``): a
    reaped or finished session's id never addresses the slot's next
    occupant, so a stale client's late feed or close gets a KeyError
    (HTTP 404) instead of another session.
    """

    def __init__(self, model_path: str, cfg: StreamServeConfig | None = None,
                 package=None, variables=None, device: str = "cuda"):
        """``variables``: a flax-shaped tree, or the ``DeepSpeech2`` of a
        ``TranscriptionService`` (``service.model``) to share it."""
        from tpuasr_torch.stream import MultiStreamTranscriber

        self.cfg = cfg or StreamServeConfig()
        pkg = package if package is not None else load_checkpoint(model_path)
        model_cfg = pkg.model_config
        if model_cfg.bidirectional:
            raise ValueError(
                "streaming sessions need a unidirectional checkpoint "
                "(bidirectional=False, e.g. --no-bidirectional training)")
        self.sample_rate = pkg.frontend_config.sample_rate
        if variables is None:
            variables = model_from_variables(pkg.variables, model_cfg,
                                             resolve_device(device))
        lm = None
        if self.cfg.decoder == "beam" and self.cfg.lm_path:
            from tpuasr_torch.decode.lm import load_lm

            lm = load_lm(self.cfg.lm_path)
        self._mst = MultiStreamTranscriber(
            variables, model_cfg, pkg.frontend_config, pkg.alphabet,
            max_streams=self.cfg.max_streams, chunk_frames=self.cfg.chunk_frames,
            decoder=self.cfg.decoder, lm=lm, alpha=self.cfg.alpha,
            beta=self.cfg.beta, beam_width=self.cfg.beam_width,
            cutoff_top_n=self.cfg.cutoff_top_n, cutoff_prob=self.cfg.cutoff_prob,
            beam_impl=self.cfg.beam_impl, prime_stats=self.cfg.prime_stats,
            device=device)
        self.device = self._mst.device
        self._lock = threading.Lock()
        self._sessions: dict[int, int] = {}  # public sid -> slot
        self._gen = 0  # generation stamp: sids never repeat
        self._last_seen: dict[int, float] = {}
        self._stop = threading.Event()
        # one warm-up tick before sessions arrive (builds the kernels and
        # lets the libraries pick their algorithms)
        with self._lock:
            slot = self._mst.open()
            self._mst.feed(slot, np.zeros(
                (self.cfg.chunk_frames * pkg.frontend_config.hop + 1,), np.float32))
            self._mst.tick()
            self._mst.flush(slot)
            self._mst.close(slot)
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        self._ticker.start()

    # ---- session API ------------------------------------------------------

    def open(self) -> int:
        with self._lock:
            self._reap()
            slot = self._mst.open()
            self._gen += 1
            sid = self._gen * self.cfg.max_streams + slot
            self._sessions[sid] = slot
            self._last_seen[sid] = time.time()
            return sid

    def feed(self, sid: int, samples: np.ndarray) -> str:
        """Buffer samples; return the text finalized since the last call
        (decoding happens on the ticker thread)."""
        with self._lock:
            self._mst.feed(self._slot(sid), samples)
            self._last_seen[sid] = time.time()
            return self._mst.take_text(self._slot(sid))

    def finish(self, sid: int) -> tuple[str, list[int]]:
        """Drain and close the session; returns the full final text and
        per-char frame offsets. The ticker drives the drain, and this
        thread releases the lock between its polls, so other sessions'
        feeds and opens never wait behind a closing stream."""
        with self._lock:
            slot = self._slot(sid)
            self._mst.begin_flush(slot)
            self._last_seen[sid] = time.time()
        while True:
            with self._lock:
                if sid not in self._sessions:
                    # reaped mid-drain (only after session_timeout_s of
                    # ticker starvation)
                    raise KeyError(f"stream {sid} timed out during drain")
                self._last_seen[sid] = time.time()
                if self._mst.flush_done(slot):
                    text = self._mst.finalize_flush(slot)
                    offs = self._mst.offsets(slot).tolist()
                    self._mst.close(slot)
                    self._sessions.pop(sid, None)
                    self._last_seen.pop(sid, None)
                    return text, offs
            time.sleep(self.cfg.idle_sleep_ms / 1e3)

    def close(self) -> None:
        self._stop.set()
        self._ticker.join(timeout=5)

    # ---- internals --------------------------------------------------------

    def _slot(self, sid: int) -> int:
        """Session id -> live slot; a stale or unknown id raises KeyError
        (HTTP 404), never resolves to another session's slot."""
        if sid not in self._sessions:
            raise KeyError(f"no open stream {sid}")
        return self._sessions[sid]

    def _reap(self) -> None:
        now = time.time()
        for sid, seen in list(self._last_seen.items()):
            if now - seen > self.cfg.session_timeout_s:
                self._mst.close(self._sessions[sid])
                self._sessions.pop(sid, None)
                self._last_seen.pop(sid, None)

    def _tick_loop(self) -> None:
        last_reap = time.time()
        while not self._stop.is_set():
            try:
                with self._lock:
                    stepped = self._mst.tick()
                    # reap abandoned sessions even when no open() arrives
                    if time.time() - last_reap > 5.0:
                        self._reap()
                        last_reap = time.time()
            except Exception as exc:  # the shared ticker must not die
                print(f"stream ticker error (retrying): {exc!r}", flush=True)
                time.sleep(0.2)
                continue
            if not stepped:
                time.sleep(self.cfg.idle_sleep_ms / 1e3)


def make_http_server(service: TranscriptionService | None, host: str, port: int,
                     stream_service: StreamSessionService | None = None):
    """HTTP server over a batch service and/or a live-stream session
    service: POST /transcribe (WAV body), GET /healthz, and the
    streaming protocol (raw PCM at the model's sample rate, int16 LE by
    default, ``X-Audio-Format: f32`` for float32):

        POST /stream/open            -> {"id": N}
        POST /stream/<id>/feed  PCM  -> {"text": "<newly final text>"}
        POST /stream/<id>/close      -> {"text": "<full text>", "offsets": [...]}
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n)

        def _pcm(self, data: bytes) -> np.ndarray:
            if self.headers.get("X-Audio-Format", "i16").lower() == "f32":
                return np.frombuffer(data, np.float32)
            return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                if self.path == "/transcribe" and service is not None:
                    text, offsets = service.transcribe_wav_bytes(self._body())
                    self._send(200, {"text": text, "offsets": offsets})
                    return
                if self.path.startswith("/stream"):
                    if stream_service is None:
                        self._send(400, {"error": "streaming disabled "
                                         "(start with --streaming and a "
                                         "unidirectional checkpoint)"})
                        return
                    parts = self.path.strip("/").split("/")
                    if parts == ["stream", "open"]:
                        self._send(200, {"id": stream_service.open()})
                        return
                    if len(parts) == 3 and parts[2] in ("feed", "close"):
                        sid = int(parts[1])
                        if parts[2] == "feed":
                            frag = stream_service.feed(sid, self._pcm(self._body()))
                            self._send(200, {"text": frag})
                        else:
                            text, offs = stream_service.finish(sid)
                            self._send(200, {"text": text, "offsets": offs})
                        return
                self._send(404, {"error": "not found"})
            except KeyError as exc:
                self._send(404, {"error": f"unknown stream {exc}"})
            except Exception as exc:
                self._send(400, {"error": repr(exc)})

    return ThreadingHTTPServer((host, port), Handler)
