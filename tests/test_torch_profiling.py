"""The program's spans and counters (``tpuasr_torch.profiling``) on the
CPU: nothing is recorded and no profiler range is entered without a
running ``torch.profiler`` profile; under one, the serving worker's
counters add up to the requests it served, every span it records is in
the exported trace as often as in the recorder, and a resident chunk
gives a ``train.step`` span a step with its three stages under it."""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr_torch import profiling
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.cli import synth_corpus
from tpuasr_torch.compat.weights import to_jax_variables
from tpuasr_torch.data.buckets import make_buckets
from tpuasr_torch.data.manifest import order_and_prune, read_manifest
from tpuasr_torch.data.resident import ResidentBatchLoader
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
from tpuasr_torch.serve import ServeConfig, TranscriptionService
from tpuasr_torch.train.checkpoint import CheckpointPackage
from tpuasr_torch.train.loop import read_back
from tpuasr_torch.train.step import TrainConfig, make_resident_epoch_runner, make_train_step

SR = 16000
MAX_BATCH = 4
# one bucket for every request: the computed samples are then
# batches x MAX_BATCH x that bucket's samples
LENGTHS = [9000, 12000, 14000, 15000, 16000, 10000, 11000]
WORKER_SPANS = ("serve.collect", "serve.pad", "serve.forward", "greedy.readback",
                "greedy.text", "serve.respond")


def _model_cfg():
    return ModelConfig(n_classes=Alphabet().size, n_features=FrontendConfig().n_features,
                       hidden_size=16, hidden_layers=1, compute_dtype="float32")


@pytest.fixture
def service():
    torch.manual_seed(0)
    cfg = _model_cfg()
    pkg = CheckpointPackage(cfg, FrontendConfig(), Alphabet().labels,
                            to_jax_variables(DeepSpeech2(cfg)))
    svc = TranscriptionService(None, ServeConfig(max_batch=MAX_BATCH, batch_window_ms=30.0),
                               package=pkg, device="cpu")
    yield svc
    svc.close()


def _serve(svc, lengths):
    rng = np.random.RandomState(3)
    waves = [(0.1 * rng.randn(n)).astype(np.float32) for n in lengths]
    out = [None] * len(waves)

    def call(j):
        out[j] = svc.transcribe_wave(waves[j], timeout=120)

    threads = [threading.Thread(target=call, args=(j,)) for j in range(len(waves))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in out)


def test_off_records_nothing_and_enters_no_range(service, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset()
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 2)
        profiling.sample("s", 1.0)
    _serve(service, LENGTHS[:3])
    assert profiling.recorded() == {"spans": [], "counters": {}, "samples": {}}


def test_service_counters_and_trace(service, tmp_path):
    profiling.reset()
    # a profile records other threads' ranges only when asked to; the
    # recorder keeps every thread's spans either way
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        _serve(service, LENGTHS)
        service.close()  # every worker span closes inside the trace
    rec = profiling.recorded()
    c = rec["counters"]
    bucket = service.spec.bucket_samples(service.spec.bucket_of(max(LENGTHS) / SR))
    assert service.spec.bucket_of(min(LENGTHS) / SR) == service.spec.bucket_of(max(LENGTHS) / SR)
    assert c["serve.rows"] == len(LENGTHS)
    assert c["serve.real_samples"] == sum(LENGTHS)
    assert c["serve.computed_samples"] == c["serve.batches"] * MAX_BATCH * bucket
    waits = rec["samples"]["serve.queue_wait_s"]
    assert len(waits) == len(LENGTHS)
    assert all(v >= 0 for v in waits)
    names = Counter(s.name for s in rec["spans"])
    assert names["serve.forward"] == names["greedy.text"] == c["serve.batches"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    traced = Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    for name in WORKER_SPANS:
        assert names[name] > 0, name
        assert traced[name] == names[name], name
    # the worker's spans do not overlap one another: none has a parent
    assert all(s.parent is None for s in rec["spans"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return synth_corpus.generate(str(tmp_path_factory.mktemp("corpus")), 6, None, 0.0, seed=4)


def test_resident_chunk_spans(corpus):
    torch.manual_seed(0)
    plan = make_buckets(order_and_prune(read_manifest(corpus["train"])), 2, seed=5)
    loader = ResidentBatchLoader(plan, Alphabet(), device="cpu")
    model = DeepSpeech2(_model_cfg())
    model.train()
    runner = make_resident_epoch_runner(make_train_step(model, FrontendConfig(), TrainConfig()))
    profiling.reset()
    k0, chunks = 0, 0
    with profile(activities=[ProfilerActivity.CPU]):
        for _, bank, idx, _, valid in loader.bucket_chunks(1):
            read_back(runner(bank, idx, valid, 1e-4, k0))
            k0 += idx.shape[0]
            chunks += 1
    spans = profiling.recorded()["spans"]
    names = Counter(s.name for s in spans)
    assert names["resident.chunk"] == names["train.chunk"] == names["train.read_back"] == chunks
    assert names["train.step"] == k0 == loader.num_batches(1)
    by_id = {s.id: s for s in spans}
    for step in (s for s in spans if s.name == "train.step"):
        assert by_id[step.parent].name == "train.chunk"
        assert sorted(s.name for s in spans if s.parent == step.id) == [
            "train.backward", "train.loss", "train.update"]


def _keep_span():
    with profiling.span("x"):
        pass


@pytest.mark.parametrize("keep", [_keep_span, lambda: profiling.sample("x", 1.0)],
                         ids=["span", "sample"])
def test_cap_counts_dropped(keep, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_KEPT", 3)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.sample("y", 0.0)
        for _ in range(5):
            keep()
    rec = profiling.recorded()
    kept = len(rec["spans"]) + sum(len(v) for v in rec["samples"].values())
    assert kept == 3
    assert rec["counters"]["profiling.dropped"] == 3
