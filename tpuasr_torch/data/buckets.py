"""Static duration buckets and the SortaGrad batch schedule (port of
``tpuasr/data/buckets.py``).

Every batch is padded up to a bucket of this ladder (samples and label
slots), so the port sees the same small set of shapes as the JAX
package. Epoch 0 runs in duration-sorted order (SortaGrad); later
epochs shuffle within each bucket and then the batch order, from a
numpy ``RandomState(seed + epoch)`` used exactly as the JAX package
uses it, so both packages train on the same batches in the same order.
A ``homogeneous`` plan keeps epoch 0's batches within one bucket too
(the device-resident corpus pads each utterance to its own bucket).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# Default bucket boundaries in seconds: dense where PT-BR read-speech
# utterances live (2-8 s), sparse tails.
DEFAULT_BUCKET_SECONDS = (1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.5, 8.0, 11.0, 16.5)

# Label capacity per bucket second: PT-BR read speech runs ~12-16
# chars/s; 25 chars/s (+5 slack) never truncates real transcripts.
LABEL_CHARS_PER_SECOND = 25
LABEL_SLACK = 5


@dataclass(frozen=True)
class BucketSpec:
    seconds: tuple = DEFAULT_BUCKET_SECONDS
    sample_rate: int = 16000

    def bucket_samples(self, i: int) -> int:
        return int(round(self.seconds[i] * self.sample_rate))

    def bucket_label_cap(self, i: int) -> int:
        return int(math.ceil(self.seconds[i] * LABEL_CHARS_PER_SECOND)) + LABEL_SLACK

    def bucket_of(self, duration: float) -> int:
        """Smallest bucket that fits; overlong utterances go to the last
        bucket."""
        for i, s in enumerate(self.seconds):
            if duration <= s:
                return i
        return len(self.seconds) - 1

    @property
    def n_buckets(self) -> int:
        return len(self.seconds)


@dataclass
class BatchPlanEntry:
    bucket: int
    indices: list  # indices into the manifest entry list


@dataclass
class BucketingPlan:
    """An epoch-indexed batch schedule over duration-annotated manifest
    entries: ``batches(epoch)`` lists BatchPlanEntry in training order,
    ``sharded_batches(epoch, rank, world)`` a rank's share of it."""

    entries: list
    batch_size: int
    spec: BucketSpec = field(default_factory=BucketSpec)
    seed: int = 0
    sorta_grad: bool = True
    shuffle: bool = True
    # homogeneous=True keeps every batch within ONE bucket in the sorted
    # (epoch-0 SortaGrad) pass as well: each bucket's duration-sorted
    # members are chunked apart, buckets shortest first, so the
    # curriculum holds with less padding. The resident loader needs it.
    homogeneous: bool = False

    def __post_init__(self):
        self._durations = np.array([e.duration for e in self.entries], dtype=np.float64)
        self._order = np.argsort(self._durations, kind="stable")
        self._bucket_ids = np.array(
            [self.spec.bucket_of(d) for d in self._durations], dtype=np.int64)

    def _chunks(self, members, bucket=None) -> list[BatchPlanEntry]:
        """Consecutive batches of ``members``, in the given bucket or in
        the largest bucket of the batch's members."""
        out = []
        for start in range(0, len(members), self.batch_size):
            idx = members[start:start + self.batch_size]
            b = int(self._bucket_ids[idx].max()) if bucket is None else bucket
            out.append(BatchPlanEntry(b, list(map(int, idx))))
        return out

    def _bucketed_batches(self, rng: np.random.RandomState) -> list[BatchPlanEntry]:
        out = []
        for b in range(self.spec.n_buckets):
            members = np.nonzero(self._bucket_ids == b)[0]
            if len(members) == 0:
                continue
            rng.shuffle(members)
            out += self._chunks(members, b)
        rng.shuffle(out)
        return out

    def _sorted_batches(self) -> list[BatchPlanEntry]:
        if not self.homogeneous:
            return self._chunks(self._order)
        out = []
        for b in range(self.spec.n_buckets):
            out += self._chunks(self._order[self._bucket_ids[self._order] == b], b)
        return out

    def batches(self, epoch: int) -> list[BatchPlanEntry]:
        if (epoch == 0 and self.sorta_grad) or not self.shuffle:
            return self._sorted_batches()
        return self._bucketed_batches(np.random.RandomState(self.seed + epoch))

    def sharded_batches(self, epoch: int, rank: int, world: int) -> list[BatchPlanEntry]:
        """Every rank sees the same schedule and takes batches
        [rank::world]; trailing batches that do not divide evenly are
        dropped, so every rank steps the same number of times. At world
        1 it is ``batches(epoch)``."""
        all_b = self.batches(epoch)
        n = (len(all_b) // world) * world
        return all_b[rank:n:world]


def make_buckets(entries: list, batch_size: int, spec: BucketSpec | None = None,
                 **kw) -> BucketingPlan:
    return BucketingPlan(entries, batch_size, spec or BucketSpec(), **kw)
