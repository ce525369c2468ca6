"""The port's host data path against tpuasr's, exactly: the synthetic
corpus tool, manifests, duration ordering, the SortaGrad and bucketed
batch schedules, the loader's padded batches, and WER/CER."""

import filecmp

import numpy as np
import pytest

from tpuasr.cli.synth_corpus import generate as jax_generate
from tpuasr.data import buckets as jax_buckets
from tpuasr.data import manifest as jax_manifest
from tpuasr.data.loader import AudioBatchLoader as JaxLoader
from tpuasr.decode import metrics as jax_metrics
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr_torch.cli.synth_corpus import generate
from tpuasr_torch.data import buckets, manifest
from tpuasr_torch.data.loader import AudioBatchLoader
from tpuasr_torch.decode import metrics
from tpuasr_torch.labels import Alphabet


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = generate(str(root / "port"), 10, None, 0.2, seed=4)
    jax_paths = jax_generate(str(root / "jax"), 10, None, 0.2, seed=4)
    return paths, jax_paths


def test_synth_corpus_matches(corpus):
    paths, jax_paths = corpus
    for name in ("train", "val", "all"):
        got = [ln.split(",") for ln in open(paths[name]).read().splitlines()]
        want = [ln.split(",") for ln in open(jax_paths[name]).read().splitlines()]
        assert len(got) == len(want) > 0
        for (w, t), (wj, tj) in zip(got, want):
            assert filecmp.cmp(w, wj, shallow=False) and filecmp.cmp(t, tj, shallow=False)


def _plans(entries, jax_entries, **kw):
    spec = buckets.BucketSpec(seconds=(0.8, 1.2, 1.7))
    jspec = jax_buckets.BucketSpec(seconds=(0.8, 1.2, 1.7))
    return (buckets.make_buckets(entries, 3, spec, **kw),
            jax_buckets.make_buckets(jax_entries, 3, jspec, **kw))


@pytest.mark.parametrize("kw", [dict(seed=7), dict(seed=11), dict(seed=2, shuffle=False),
                                dict(seed=3, sorta_grad=False)],
                         ids=["sortagrad", "sortagrad-seed11", "no-shuffle", "no-sortagrad"])
def test_manifest_order_and_batch_plans_match(corpus, kw):
    path = corpus[0]["all"]
    entries = manifest.order_and_prune(manifest.read_manifest(path), min_duration=0.7)
    jax_entries = jax_manifest.order_and_prune(jax_manifest.read_manifest(path),
                                               min_duration=0.7)
    assert [(e.wav_path, e.duration) for e in entries] == [
        (e.wav_path, e.duration) for e in jax_entries]
    plan, jplan = _plans(entries, jax_entries, **kw)
    for epoch in (0, 1, 2):
        got = [(p.bucket, p.indices) for p in plan.batches(epoch)]
        assert got == [(p.bucket, p.indices) for p in jplan.batches(epoch)]


def test_manifest_round_trip(corpus, tmp_path):
    entries = manifest.with_durations(manifest.read_manifest(corpus[0]["train"]))
    manifest.write_manifest(str(tmp_path / "m.csv"), entries)
    jax_manifest.write_manifest(str(tmp_path / "j.csv"),
                                jax_manifest.with_durations(
                                    jax_manifest.read_manifest(corpus[0]["train"])))
    assert (tmp_path / "m.csv").read_text() == (tmp_path / "j.csv").read_text()
    back = manifest.read_manifest(str(tmp_path / "m.csv"))
    assert [(e.wav_path, e.transcript_path, e.duration) for e in back] == [
        (e.wav_path, e.transcript_path, round(e.duration, 4)) for e in entries]


@pytest.mark.parametrize("transfer_dtype", ["int16", "float32"])
def test_loader_batches_match(corpus, transfer_dtype):
    path = corpus[0]["all"]
    entries = manifest.order_and_prune(manifest.read_manifest(path))
    jax_entries = jax_manifest.order_and_prune(jax_manifest.read_manifest(path))
    plan, jplan = _plans(entries, jax_entries, seed=5)
    loader = AudioBatchLoader(plan, Alphabet(), transfer_dtype=transfer_dtype)
    jloader = JaxLoader(jplan, JaxAlphabet(), transfer_dtype=transfer_dtype)
    for epoch in (0, 1):
        got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert len(got) == len(want) == loader.num_batches(epoch)
        for a, b in zip(got, want):
            for k in ("waves", "wave_lengths", "labels", "label_lengths", "valid"):
                x, y = getattr(a, k), getattr(b, k)
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)
            assert a.bucket == b.bucket and a.texts == b.texts and a.size == b.size
    assert any(not b.valid.all() for b in got)  # a short batch was padded


def test_metrics_match():
    pairs = [("OLA MUNDO", "ALO MUNDO"), ("", "BOM DIA"), ("TUDO BEM", ""),
             ("CASA  FALA VOZ", "CASA FALA VOZ REDE"), ("SOL MAR", "SOL MAR")]
    meter, jmeter = metrics.ErrorRateMeter(), jax_metrics.ErrorRateMeter()
    for hyp, ref in pairs:
        assert metrics.wer(hyp, ref) == jax_metrics.wer(hyp, ref)
        assert metrics.cer(hyp, ref) == jax_metrics.cer(hyp, ref)
        assert metrics.levenshtein(hyp, ref) == jax_metrics.levenshtein(hyp, ref)
        meter.update(hyp, ref)
        jmeter.update(hyp, ref)
    assert (meter.wer, meter.cer) == (jmeter.wer, jmeter.cer)
    assert metrics.levenshtein(list("kitten"), list("sitting")) == 3
