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

HTTP wrapper (``make_http_server``): POST /transcribe with a WAV body ->
{"text": ..., "offsets": [...]}; GET /healthz. Live-stream sessions
come with the streaming slice.
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
        batching window."""
        try:
            first = self._queue.get(timeout=0.2)
        except queue.Empty:
            return []
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
        return batch

    def _serve_loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            cap = int(self.cfg.max_seconds * self.spec.sample_rate)
            short = [r for r in batch if len(r[0]) <= cap]
            long_ = [r for r in batch if len(r[0]) > cap]
            if short:
                try:
                    waves, slots, dones = zip(*short)
                    n_max = max(len(w) for w in waves)
                    b_idx = self.spec.bucket_of(n_max / self.spec.sample_rate)
                    l_bucket = self.spec.bucket_samples(b_idx)
                    bsz = self.cfg.max_batch  # static batch dim
                    arr = np.zeros((bsz, l_bucket), np.float32)
                    lengths = np.zeros((bsz,), np.int32)
                    for j, w in enumerate(waves):
                        arr[j, : len(w)] = w
                        lengths[j] = len(w)
                    logits, out_lengths = self.eval_step(arr, lengths)
                    texts, offsets = self.decoder.decode(
                        logits, out_lengths, return_offsets=True
                    )
                    for j, (slot, done) in enumerate(zip(slots, dones)):
                        slot["text"] = texts[j]
                        slot["offsets"] = np.asarray(offsets[j]).tolist()
                        done.set()
                except Exception as exc:  # report, never wedge callers
                    for _, slot, done in short:
                        slot["error"] = repr(exc)
                        done.set()
            # long-form requests: overlapping ladder-sized chunks through
            # the same (max_batch, bucket) shapes, stitched + decoded on host
            for wave, slot, done in long_:
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


def make_http_server(service: TranscriptionService, host: str, port: int):
    """HTTP server over a batch service: POST /transcribe (WAV body),
    GET /healthz."""
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

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                if self.path == "/transcribe":
                    text, offsets = service.transcribe_wav_bytes(self._body())
                    self._send(200, {"text": text, "offsets": offsets})
                    return
                self._send(404, {"error": "not found"})
            except Exception as exc:
                self._send(400, {"error": repr(exc)})

    return ThreadingHTTPServer((host, port), Handler)
