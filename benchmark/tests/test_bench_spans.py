"""The readers of the program's spans and counters on hand-made
snapshots of ``tpuasr_torch.profiling.recorded()``."""

import sys

import pytest

from benchmark.lib.harness import BENCH_DIR
from benchmark.run import load_module

SERVE = ("queue_wait_p95_ms.serve", "batch_rows.serve", "batch_fill.serve",
         "host_stage_share.serve", "batch_window_share.serve", "forward_share.serve",
         "card_wait_share.serve")
TRAIN = ("dispatch_ms_per_step.train", "chunk_gap_ms.train")
MS = 1_000_000  # ns


def reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "spans_" + name.replace(".", "_"))


def spans(*rows):
    """Spans from (id, name, start ms, end ms, parent) rows."""
    from tpuasr_torch.profiling import Span

    return [Span(i, n, int(a * MS), int(b * MS), p) for i, n, a, b, p in rows]


def serve_snapshot():
    return {
        "spans": spans((1, "serve.collect", 4, 6, None), (2, "serve.pad", 6, 9, None),
                       (4, "serve.forward", 9, 15, None), (5, "greedy.readback", 15, 30, None),
                       (6, "greedy.text", 30, 32, None), (7, "serve.respond", 32, 33, None),
                       (8, "serve.collect", 40, 41.5, None),
                       (9, "greedy.readback", 50, 60, None)),
        "counters": {"serve.batches": 4, "serve.rows": 50, "serve.real_samples": 3_000,
                     "serve.computed_samples": 12_000},
        "samples": {"serve.queue_wait_s": [k / 1000 for k in range(1, 101)]},
    }


def train_snapshot():
    # chunk 1 (steps at 2 and 5 ms) after a read-back that ends at 1 ms,
    # read back to 20; chunk 2's first step at 27 (gap 7); read back to 40;
    # chunk 3's first step at 43 (gap 3)
    return {
        "spans": spans((0, "train.read_back", 0, 1, None), (1, "train.chunk", 1, 10, None),
                       (2, "train.step", 2, 4, 1), (3, "train.step", 5, 9, 1),
                       (4, "train.read_back", 10, 20, None), (5, "train.chunk", 25, 35, None),
                       (6, "train.step", 27, 33, 5), (7, "train.read_back", 35, 40, None),
                       (8, "train.chunk", 41, 50, None), (9, "train.step", 44, 48, 8),
                       (10, "train.step", 43, 44, 8)),
        "counters": {}, "samples": {},
    }


@pytest.fixture
def snapshot(monkeypatch):
    from tpuasr_torch import profiling

    holder = {}
    monkeypatch.setattr(profiling, "recorded", lambda: holder["rec"])
    return holder


WORK = {"serve": {"entry": "serve", "trace": {"window_s": 0.1}},
        "train": {"entry": "train", "trace": {"window_s": 0.05}}}


def test_serve_readers(snapshot):
    snapshot["rec"] = serve_snapshot()
    work = WORK["serve"]
    # waits 1..100 ms: the 95th percentile by linear interpolation
    assert reader("queue_wait_p95_ms.serve").read(work) == pytest.approx(95.05)
    assert reader("batch_rows.serve").read(work) == pytest.approx(12.5)
    assert reader("batch_fill.serve").read(work) == pytest.approx(25.0)
    # of the 100 ms window: pad 3 + text 2 + respond 1 ms; collect 2 + 1.5;
    # forward 6; read-back 15 + 10
    assert reader("host_stage_share.serve").read(work) == pytest.approx(6.0)
    assert reader("batch_window_share.serve").read(work) == pytest.approx(3.5)
    assert reader("forward_share.serve").read(work) == pytest.approx(6.0)
    assert reader("card_wait_share.serve").read(work) == pytest.approx(25.0)


def test_train_readers(snapshot):
    snapshot["rec"] = train_snapshot()
    work = WORK["train"]
    assert reader("dispatch_ms_per_step.train").read(work) == pytest.approx((2 + 4 + 6 + 4 + 1) / 5)
    # the window's first chunk is skipped: its 1 ms gap does not count
    assert reader("chunk_gap_ms.train").read(work) == pytest.approx((7 + 3) / 2)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_finds_nothing(name, snapshot, monkeypatch):
    entry = "serve" if name.endswith(".serve") else "train"
    other = "train" if entry == "serve" else "serve"
    snapshot["rec"] = serve_snapshot() if entry == "serve" else train_snapshot()
    assert reader(name).read(WORK[entry]) is not None
    assert reader(name).read(WORK[other]) is None  # the other entry's work
    snapshot["rec"] = {"spans": [], "counters": {}, "samples": {}}
    assert reader(name).read(WORK[entry]) is None  # nothing recorded
    snapshot["rec"] = serve_snapshot() if entry == "serve" else train_snapshot()
    import tpuasr_torch

    monkeypatch.delattr(tpuasr_torch, "profiling")
    monkeypatch.setitem(sys.modules, "tpuasr_torch.profiling", None)
    assert reader(name).read(WORK[entry]) is None  # a program without a recorder
