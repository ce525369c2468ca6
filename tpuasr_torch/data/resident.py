"""Device-resident corpus: batches assembled by a gather on the device
(port of ``tpuasr/data/resident.py``).

For corpora that fit device memory (LapsBM-scale sets, the synthetic
benches, any eval manifest), the whole corpus is packed into one bank
per duration bucket once: waves as int16 (2 bytes a sample; 1,024
utterances of 5 s take 164 MB), labels as int32. A batch is then an
``index_select`` over the bank, and the only host-to-device traffic a
step is its (B,) index vector.

``ResidentBatchLoader`` yields the same ``Batch`` fields as
``AudioBatchLoader`` from ``epoch(e)`` (device tensors), and
``bucket_chunks(e)`` gives the epoch's schedule bucket by bucket as
index matrices, for the resident runners of ``train/step.py`` and
``decode/resident_eval.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpuasr_torch.audio.io import load_audio_pcm16
from tpuasr_torch.data.buckets import BucketingPlan
from tpuasr_torch.data.loader import AudioBatchLoader, Batch
from tpuasr_torch.device import resolve_device, to_device
from tpuasr_torch.labels import Alphabet


@dataclass
class _BucketBank:
    """One bucket's bank on the device. ``rows`` (manifest entry index
    -> bank row) and the tensors are public: the resident runners read
    them through ``bucket_chunks``."""

    waves: torch.Tensor  # (N, L_bucket) int16
    wave_lengths: torch.Tensor  # (N,) int32
    labels: torch.Tensor  # (N, L_cap) int32
    label_lengths: torch.Tensor  # (N,) int32
    rows: dict  # manifest entry index -> bank row


class ResidentBatchLoader:
    """Packs the plan's corpus into device memory once (``device``:
    CUDA unless the CPU is asked for) and yields gathered batches."""

    def __init__(self, plan: BucketingPlan, alphabet: Alphabet, sample_rate: int = 16000,
                 rank: int = 0, world: int = 1, device: str | torch.device = "cuda"):
        self.plan = plan
        self.alphabet = alphabet
        self.rank = rank
        self.world = world
        self.device = resolve_device(device)
        # a bank pads each utterance to ITS OWN bucket, so every batch
        # must stay within one bucket, the epoch-0 SortaGrad pass too
        plan.homogeneous = True
        spec = plan.spec
        by_bucket: dict = {}
        for i, e in enumerate(plan.entries):
            by_bucket.setdefault(spec.bucket_of(e.duration), []).append(i)

        self.texts = [e.read_transcript() for e in plan.entries]
        self.banks: dict = {}
        for b, idxs in by_bucket.items():
            l_bucket, l_cap, n = spec.bucket_samples(b), spec.bucket_label_cap(b), len(idxs)
            waves = np.zeros((n, l_bucket), np.int16)
            wl = np.zeros((n,), np.int32)
            labels = np.zeros((n, l_cap), np.int32)
            ll = np.zeros((n,), np.int32)
            rows = {}
            for r, i in enumerate(idxs):
                e = plan.entries[i]
                w = load_audio_pcm16(e.wav_path, expected_sample_rate=sample_rate)
                if len(w) > l_bucket:
                    AudioBatchLoader._overflow("wave", e.wav_path, len(w), l_bucket)
                m = min(len(w), l_bucket)
                waves[r, :m] = w[:m]
                wl[r] = m
                ids = alphabet.encode(self.texts[i])
                if len(ids) > l_cap:
                    AudioBatchLoader._overflow("label", e.wav_path, len(ids), l_cap)
                    ids = ids[:l_cap]
                labels[r, :len(ids)] = ids
                ll[r] = len(ids)
                rows[i] = r
            # the host arrays go with this iteration: one host copy at a time
            self.banks[b] = _BucketBank(
                *(torch.from_numpy(a).to(self.device) for a in (waves, wl, labels, ll)), rows)
        # a valid mask is one of bsz + 1 vectors: made once, on the device
        bsz = plan.batch_size
        self._valid = [torch.arange(bsz, device=self.device) < k for k in range(bsz + 1)]

    def _rows(self, bank: _BucketBank, indices: list) -> list:
        """Bank rows of a batch, padded to the batch size with its last."""
        idx = [bank.rows[i] for i in indices]
        return idx + [idx[-1]] * (self.plan.batch_size - len(idx))

    def epoch(self, epoch: int):
        """Yield the epoch's batches as device tensors; each copies only
        its (B,) index vector to the device."""
        bsz = self.plan.batch_size
        for pb in self.plan.sharded_batches(epoch, self.rank, self.world):
            bank = self.banks[pb.bucket]
            n_real = len(pb.indices)
            idx = to_device(np.asarray(self._rows(bank, pb.indices), np.int64), self.device)
            yield Batch(
                waves=bank.waves.index_select(0, idx),
                wave_lengths=bank.wave_lengths.index_select(0, idx),
                labels=bank.labels.index_select(0, idx),
                label_lengths=bank.label_lengths.index_select(0, idx),
                valid=self._valid[n_real],
                bucket=pb.bucket,
                texts=[self.texts[i] for i in pb.indices]
                + [self.texts[pb.indices[-1]]] * (bsz - n_real),
                n_valid=n_real,
            )

    def num_batches(self, epoch: int) -> int:
        return len(self.plan.sharded_batches(epoch, self.rank, self.world))

    def bucket_chunks(self, epoch: int):
        """The epoch's schedule grouped per bucket, for the resident
        runners: yields (bucket, bank, idx_mat (K, B) int32, n_valid
        (K,) int32, valid_mat (K, B) bool), host arrays. Within a bucket
        the (shuffled) batch order is kept; buckets are visited shortest
        first, which keeps the epoch-0 SortaGrad curriculum exact. With
        several ranks a step is grouped by the buckets of every rank's
        batch at that step (the same groups on every rank), so the ranks
        run the same chunks and each step's global batch is the shared
        schedule's."""
        bsz = self.plan.batch_size
        shards = [self.plan.sharded_batches(epoch, r, self.world) for r in range(self.world)]
        by_buckets: dict = {}
        for k, pb in enumerate(shards[self.rank]):
            by_buckets.setdefault(tuple(s[k].bucket for s in shards), []).append(pb)
        for buckets in sorted(by_buckets):
            b = buckets[self.rank]
            bank, pbs = self.banks[b], by_buckets[buckets]
            idx_mat = np.asarray([self._rows(bank, pb.indices) for pb in pbs], np.int32)
            n_valid = np.asarray([len(pb.indices) for pb in pbs], np.int32)
            valid_mat = np.arange(bsz)[None, :] < n_valid[:, None]
            yield b, bank, idx_mat, n_valid, valid_mat
