"""Host batch loader (port of ``tpuasr/data/loader.py``): manifest
entries -> padded numpy batches, read on a background thread.

The host only decodes WAVs, encodes transcripts and pads; the
spectrogram runs on the device in the train step. Every batch has its
bucket's static shape: waves (B, L_bucket) as int16 PCM (half the
host-to-device bytes; rescaled on the device) or float32, labels
(B, L_cap) capped per bucket, and a short last batch padded with
repeats of its last entry that ``valid`` marks False.
"""

from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass

import numpy as np

from tpuasr_torch.audio.io import load_audio, load_audio_pcm16
from tpuasr_torch.data.buckets import BatchPlanEntry, BucketingPlan
from tpuasr_torch.labels import Alphabet


@dataclass
class Batch:
    waves: np.ndarray  # (B, L_bucket) float32 or int16
    wave_lengths: np.ndarray  # (B,) int32
    labels: np.ndarray  # (B, L_cap) int32
    label_lengths: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) bool: False for batch-padding repeats
    bucket: int
    texts: list  # reference transcripts (for eval)
    n_valid: int | None = None  # set when the fields are device tensors

    @property
    def size(self) -> int:
        if self.n_valid is not None:  # no read-back from the device
            return self.n_valid
        return int(self.valid.sum())


class AudioBatchLoader:
    """Iterates a BucketingPlan epoch, reading and padding on a
    background thread with ``prefetch`` batches in flight. ``rank`` and
    ``world`` pick a data shard: batches [rank::world] of the shared
    schedule (``BucketingPlan.sharded_batches``); a distributed run
    passes the data index and data-group size, so the ranks of one model
    group load the same batches."""

    def __init__(self, plan: BucketingPlan, alphabet: Alphabet, sample_rate: int = 16000,
                 prefetch: int = 2, cache_audio: bool = False,
                 transfer_dtype: str = "float32", rank: int = 0, world: int = 1):
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be float32|int16, got {transfer_dtype!r}")
        self.plan = plan
        self.alphabet = alphabet
        self.sample_rate = sample_rate
        self.prefetch = prefetch
        self.rank = rank
        self.world = world
        self.transfer_dtype = transfer_dtype
        self._wave_cache: dict | None = {} if cache_audio else None

    @staticmethod
    def _overflow(kind: str, path: str, have: int, cap: int) -> None:
        warnings.warn(f"{kind} overflow for {path}: {have} > bucket cap {cap} — "
                      f"truncating corrupts CTC supervision; prune overlong "
                      f"utterances from the manifest (--max-duration) or widen the "
                      f"bucket spec.", stacklevel=3)

    def _wave(self, path: str) -> np.ndarray:
        if self._wave_cache is not None and path in self._wave_cache:
            return self._wave_cache[path]
        if self.transfer_dtype == "int16":
            w = load_audio_pcm16(path, expected_sample_rate=self.sample_rate)
        else:
            w = load_audio(path, expected_sample_rate=self.sample_rate)
        if self._wave_cache is not None:
            self._wave_cache[path] = w
        return w

    def _make_batch(self, pb: BatchPlanEntry) -> Batch:
        spec = self.plan.spec
        bsz = self.plan.batch_size
        l_bucket = spec.bucket_samples(pb.bucket)
        l_cap = spec.bucket_label_cap(pb.bucket)
        idx = list(pb.indices)
        n_real = len(idx)
        idx += [idx[-1]] * (bsz - n_real)  # static batch: pad with repeats
        waves = np.zeros((bsz, l_bucket),
                         np.int16 if self.transfer_dtype == "int16" else np.float32)
        wave_lengths = np.zeros((bsz,), np.int32)
        labels = np.zeros((bsz, l_cap), np.int32)
        label_lengths = np.zeros((bsz,), np.int32)
        texts = []
        for j, i in enumerate(idx):
            e = self.plan.entries[i]
            w = self._wave(e.wav_path)
            if len(w) > l_bucket:
                self._overflow("wave", e.wav_path, len(w), l_bucket)
            n = min(len(w), l_bucket)
            waves[j, :n] = w[:n]
            wave_lengths[j] = n
            text = e.read_transcript()
            ids = self.alphabet.encode(text)
            if len(ids) > l_cap:
                self._overflow("label", e.wav_path, len(ids), l_cap)
                ids = ids[:l_cap]
            labels[j, :len(ids)] = ids
            label_lengths[j] = len(ids)
            texts.append(text)
        valid = np.arange(bsz) < n_real
        return Batch(waves, wave_lengths, labels, label_lengths, valid, pb.bucket, texts)

    def epoch(self, epoch: int):
        """Yield the prefetched batches of one epoch (this rank's shard)."""
        schedule = self.plan.sharded_batches(epoch, self.rank, self.world)
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = object()

        def producer():
            try:
                for pb in schedule:
                    q.put(self._make_batch(pb))
                q.put(stop)
            except BaseException as exc:  # raised in the consumer, never swallowed
                q.put(exc)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def num_batches(self, epoch: int) -> int:
        return len(self.plan.sharded_batches(epoch, self.rank, self.world))
