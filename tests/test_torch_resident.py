"""The device-resident corpus of tpuasr_torch (data/resident.py, the
resident runners of train/step.py, decode/resident_eval.py) against
tpuasr's and against the port's own per-batch paths, on the CPU.

A synthetic corpus of 8 utterances of 0.6-1.7 s spans three buckets.
The banks, batches and chunk schedules equal JAX's element for element.
Training through the resident runner equals the per-batch loop on the
same schedule bit for bit (the same operations on the same inputs, in
one process): with augmentation on and off, with a chunk a step
(--checkpoint-per-batch 1) or a chunk a bucket, and resumed mid-epoch.
Greedy ids and emission masks equal JAX's resident eval runner on the
same weights wherever a frame's two best logits are more than 1e-4
apart (the two packages' logits differ by ~1e-6, so only a nearer tie
could flip); cli.test prints the same summary and hypotheses with and
without --device-resident-audio.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr.data.buckets import make_buckets as jax_make_buckets
from tpuasr.data.manifest import order_and_prune as jax_order_and_prune
from tpuasr.data.manifest import read_manifest as jax_read_manifest
from tpuasr.data.resident import ResidentBatchLoader as JaxResidentBatchLoader
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr_torch.audio.augment import AugmentConfig, make_augment_fn
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.cli import synth_corpus
from tpuasr_torch.cli import test as test_cli
from tpuasr_torch.cli import train as train_cli
from tpuasr_torch.cli import train_lm
from tpuasr_torch.compat.weights import model_from_variables
from tpuasr_torch.data.buckets import make_buckets
from tpuasr_torch.data.loader import AudioBatchLoader
from tpuasr_torch.data.manifest import order_and_prune, read_manifest
from tpuasr_torch.data.resident import ResidentBatchLoader
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model.ds2 import ModelConfig
from tpuasr_torch.profiling import StepProfiler
from tpuasr_torch.train import loop as loop_mod
from tpuasr_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tpuasr_torch.train.loop import LoopConfig, train
from tpuasr_torch.train.step import TrainConfig, make_eval_step, make_resident_eval_runner

BATCH, SEED = 2, 5
STEP_KEYS = ("train/loss", "train/grad_norm", "train/param_norm", "train/n_ok", "train/n_frames")


def _steps(path):
    """The logged train steps of a metrics.jsonl, in order."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [[r[k] for k in STEP_KEYS] for r in rows if "train/loss" in r]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return synth_corpus.generate(str(tmp_path_factory.mktemp("corpus")), 8, None, 0.0,
                                 seed=4, make_noise=True)


def _plans(corpus, seed=SEED):
    port = make_buckets(order_and_prune(read_manifest(corpus["train"])), BATCH, seed=seed)
    jax_plan = jax_make_buckets(jax_order_and_prune(jax_read_manifest(corpus["train"])),
                                BATCH, seed=seed)
    return port, jax_plan


@pytest.mark.parametrize("homogeneous", [False, True])
def test_plan_matches_jax(corpus, homogeneous):
    port, jax_plan = _plans(corpus)
    port.homogeneous = jax_plan.homogeneous = homogeneous
    assert len(set(port._bucket_ids)) == 3  # the corpus spans three buckets
    for epoch in range(3):
        want = [(b.bucket, b.indices) for b in jax_plan.batches(epoch)]
        assert [(b.bucket, b.indices) for b in port.batches(epoch)] == want
        for world in (1, 2):
            for rank in range(world):
                assert ([(b.bucket, b.indices) for b in port.sharded_batches(epoch, rank, world)]
                        == [(b.bucket, b.indices)
                            for b in jax_plan.sharded_batches(epoch, rank, world)])
    if homogeneous:  # every epoch-0 batch within one bucket, shortest first
        buckets = [port._bucket_ids[b.indices] for b in port.batches(0)]
        assert all(len(set(ids)) == 1 for ids in buckets)
        assert [ids[0] for ids in buckets] == sorted(ids[0] for ids in buckets)


@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_matches_jax(corpus, epoch):
    port_plan, jax_plan = _plans(corpus)
    got = ResidentBatchLoader(port_plan, Alphabet(), device="cpu")
    want = JaxResidentBatchLoader(jax_plan, JaxAlphabet())
    assert port_plan.homogeneous and got.texts == want.texts
    assert got.banks.keys() == want.banks.keys()
    for b, bank in want.banks.items():
        mine = got.banks[b]
        assert mine.rows == bank.rows and mine.waves.dtype == torch.int16
        for f in ("waves", "wave_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(bank, f)))
    assert got.num_batches(epoch) == want.num_batches(epoch)
    batches = list(want.epoch(epoch))
    assert len(batches) == got.num_batches(epoch)
    for mine, theirs in zip(got.epoch(epoch), batches):
        assert (mine.bucket, mine.texts, mine.size) == (theirs.bucket, theirs.texts, theirs.size)
        for f in ("waves", "wave_lengths", "labels", "label_lengths", "valid"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(theirs, f)))
    for mine, theirs in zip(got.bucket_chunks(epoch), want.bucket_chunks(epoch), strict=True):
        assert mine[0] == theirs[0] and mine[1] is got.banks[mine[0]]
        for m, t in zip(mine[2:], theirs[2:]):
            assert m.dtype == t.dtype
            np.testing.assert_array_equal(m, t)


def _model_cfg():
    return ModelConfig(n_classes=Alphabet().size, n_features=FrontendConfig().n_features,
                       hidden_size=32, hidden_layers=1, compute_dtype="float32")


def _train(corpus, tmp_path, name, resident, augment, cap=0, continue_from=None,
           profile_dir=None):
    """One epoch of the tiny model on the homogeneous schedule; returns
    the logged steps and the final checkpoint package."""
    plan = make_buckets(order_and_prune(read_manifest(corpus["train"])), BATCH, seed=SEED)
    plan.homogeneous = True
    loader = (ResidentBatchLoader(plan, Alphabet(), device="cpu") if resident
              else AudioBatchLoader(plan, Alphabet(), transfer_dtype="int16"))
    fn = None
    if augment:
        fn = make_augment_fn(AugmentConfig(noise_dir=corpus["noise"], noise_prob=0.5,
                                           spec_augment=True))
    out = tmp_path / name
    cfg = LoopConfig(epochs=1, seed=SEED, save_folder=str(out), checkpoint_per_batch=cap,
                     log_dir=str(out / "log"), quiet=True, sync_every=1,
                     profile_dir=profile_dir)
    pkg = train(_model_cfg(), FrontendConfig(), TrainConfig(lr=3e-3), cfg, loader, None,
                Alphabet(), continue_from=continue_from, device="cpu", augment_fn=fn)
    return _steps(out / "log" / "metrics.jsonl"), pkg


def _same_weights(pkg_a, pkg_b):
    assert (pkg_a.epoch, pkg_a.iteration) == (pkg_b.epoch, pkg_b.iteration)
    flat = jax.tree_util.tree_leaves_with_path
    for (path, x), (_, y) in zip(flat(pkg_a.variables), flat(pkg_b.variables), strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


@pytest.fixture(scope="module")
def per_batch_runs(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    return {aug: _train(corpus, tmp, f"batch_{aug}", False, aug) for aug in (False, True)}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_resident_runner_equals_the_per_batch_loop(corpus, tmp_path, per_batch_runs, augment):
    steps, pkg = _train(corpus, tmp_path, "resident", True, augment)
    want_steps, want_pkg = per_batch_runs[augment]
    assert steps == want_steps and len(steps) == 5  # epoch 0's chunks: 2, 1 and 2 steps
    _same_weights(pkg, want_pkg)


@pytest.fixture(scope="module")
def capped_run(corpus, tmp_path_factory):
    """Augmented, a chunk a step (--checkpoint-per-batch 1), with a trace
    window inside this short run (the flag's own is steps 10-15)."""
    tmp = tmp_path_factory.mktemp("capped")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_mod, "StepProfiler", functools.partial(StepProfiler, start=1, stop=3))
        return tmp, _train(corpus, tmp, "run", True, True, cap=1, profile_dir=str(tmp / "trace"))


def test_resident_chunk_a_step_equals_the_per_batch_loop(capped_run, per_batch_runs):
    tmp, (steps, pkg) = capped_run
    want_steps, want_pkg = per_batch_runs[True]
    assert steps == want_steps
    _same_weights(pkg, want_pkg)
    assert len(list((tmp / "run").glob("tpuasr_e0_b*.ckpt"))) == 5  # a checkpoint a chunk
    trace = json.loads((tmp / "trace" / "steps_1-3.pt.trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])


def test_resident_resume_mid_epoch(corpus, tmp_path, capped_run, per_batch_runs):
    """The chunk-a-step run's checkpoint after step 1, inside the first
    bucket's chunk, resumed with one chunk a bucket: the consumed row is
    sliced off and the stream goes on as the continuous run's."""
    loader = ResidentBatchLoader(_plans(corpus)[0], Alphabet(), device="cpu")
    assert [len(c[2]) for c in loader.bucket_chunks(0)] == [2, 1, 2]
    mid = capped_run[0] / "run" / "tpuasr_e0_b1.ckpt"
    steps, pkg = _train(corpus, tmp_path, "resumed", True, True, continue_from=str(mid))
    want_steps, want_pkg = per_batch_runs[True]
    assert steps == want_steps[1:]
    _same_weights(pkg, want_pkg)


def _first_chunk(loader):
    return next(iter(loader.bucket_chunks(0)))


def test_resident_greedy_runner_matches_jax(corpus, per_batch_runs, tmp_path):
    from tpuasr.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from tpuasr.train.step import make_resident_eval_runner as jax_runner

    path = str(tmp_path / "trained.ckpt")
    save_checkpoint(path, per_batch_runs[False][1])
    jpkg = jax_load_checkpoint(path)
    port_plan, jax_plan = _plans(corpus)
    _, jbank, jidx, _, _ = _first_chunk(JaxResidentBatchLoader(jax_plan, JaxAlphabet()))
    variables = {"params": jpkg.variables["params"], "batch_stats": jpkg.variables["batch_stats"]}
    # one bucket's chunk: the one JAX compile of this file
    ids_j, emit_j, ol_j = jax_runner(jpkg.model_config, jpkg.frontend_config, blank_id=0)(
        variables, jbank.waves, jbank.wave_lengths, jnp.asarray(jidx))

    pkg = load_checkpoint(path)
    model = model_from_variables(pkg.variables, pkg.model_config, torch.device("cpu"))
    _, bank, idx, _, _ = _first_chunk(ResidentBatchLoader(port_plan, pkg.alphabet, device="cpu"))
    np.testing.assert_array_equal(idx, jidx)
    ids, emit, ol = make_resident_eval_runner(model, pkg.frontend_config, blank_id=0)(bank, idx)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(ol_j))
    # frames whose two best logits are clearly apart (the port's logits;
    # JAX's differ from them by ~1e-6): there the argmax cannot differ
    eval_step = make_eval_step(model, pkg.frontend_config)
    top2 = np.stack([np.sort(eval_step(bank.waves[r], bank.wave_lengths[r])[0].numpy(),
                             axis=-1)[..., -2:] for r in torch.from_numpy(idx).long()])
    valid = np.arange(top2.shape[2])[None, None, :] < ol.numpy()[..., None]
    clear = (top2[..., 1] - top2[..., 0] > 1e-4) | ~valid  # padding frames emit nothing
    assert clear[valid].mean() > 0.95
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(ids_j)[clear])
    sure = clear & np.roll(clear, 1, axis=-1)  # emit also reads the previous frame's id
    np.testing.assert_array_equal(emit.numpy()[sure], np.asarray(emit_j)[sure])
    assert emit.numpy().any()


@pytest.fixture(scope="module")
def short_manifest(corpus, tmp_path_factory):
    """The corpus' two shortest utterances (K3's plain version is slow
    on the CPU)."""
    rows = order_and_prune(read_manifest(corpus["all"]))[:2]
    path = tmp_path_factory.mktemp("short") / "short.csv"
    path.write_text("".join(f"{e.wav_path},{e.transcript_path}\n" for e in rows))
    return str(path)


@pytest.mark.parametrize("decoder", ["greedy", "beam-device"])
def test_cli_test_resident_prints_what_the_per_batch_run_prints(
        corpus, per_batch_runs, short_manifest, tmp_path, decoder, capsys):
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, per_batch_runs[True][1])
    extra = []
    if decoder == "beam-device":
        lm = str(tmp_path / "lm.arpa")
        assert train_lm.main(["--manifest", corpus["train"], "--order", "2", "--out", lm]) == 0
        extra = ["--lm-path", lm, "--beam-width", "4"]
    outs = {}
    for mode in ("batch", "resident"):
        capsys.readouterr()
        argv = ["--model-path", ckpt, "--test-manifest", short_manifest, "--batch-size", "2",
                "--decoder", decoder, "--save-output", str(tmp_path / f"{mode}.jsonl"),
                "--device", "cpu", *extra]
        assert test_cli.main(argv + (["--device-resident-audio"] if mode == "resident"
                                     else [])) == 0
        outs[mode] = (capsys.readouterr().out, (tmp_path / f"{mode}.jsonl").read_text())
    assert "Test Summary" in outs["batch"][0] and outs["resident"] == outs["batch"]
    assert len(outs["batch"][1].splitlines()) == 2


def test_train_cli_takes_the_ported_flags(corpus, tmp_path, monkeypatch):
    """--speed-perturb (resample), noise, SpecAugment, the resident
    corpus and the profiler (its window moved inside this run), through
    the CLI; a --mesh-tp that does not divide the world and a --rank
    outside it refuse before any rendezvous."""
    monkeypatch.setattr(loop_mod, "StepProfiler",
                        functools.partial(StepProfiler, start=2, stop=4))
    out = tmp_path / "cli"
    argv = ["--train-manifest", corpus["train"], "--hidden-size", "16", "--hidden-layers", "1",
            "--compute-dtype", "float32", "--batch-size", "2", "--epochs", "1", "--quiet",
            "--checkpoint", "--save-folder", str(out), "--model-path", str(out / "best.ckpt"),
            "--log-dir", str(out / "log"), "--device", "cpu", "--sync-every", "1"]
    assert train_cli.main(argv + ["--speed-perturb", "--noise-dir", corpus["noise"],
                                  "--spec-augment", "--device-resident-audio",
                                  "--profile-dir", str(out / "trace")]) == 0
    steps = _steps(out / "log" / "metrics.jsonl")
    assert len(steps) == 5 and np.isfinite(steps).all()
    assert (out / "trace" / "steps_2-4.pt.trace.json").is_file()
    for flag, match in ((["--mesh-tp", "2"], r"--mesh-tp 2 does not divide --world-size 1"),
                        (["--world-size", "2", "--rank", "2"], r"--rank 2 must be in")):
        with pytest.raises(ValueError, match=match):
            train_cli.main(argv + flag)


def test_resident_beam_takes_widths_past_the_packed_readout(per_batch_runs, short_manifest):
    """W=255 does not pack into int16 (the JAX runner refuses it): the
    resident beam reads K3's outputs back unpacked and decodes what the
    per-batch decoder decodes."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.resident_eval import ResidentEvaluator, supports_resident_eval

    pkg = per_batch_runs[True][1]
    model = model_from_variables(pkg.variables, pkg.model_config, torch.device("cpu"))
    dec = DeviceBeamDecoder(pkg.alphabet, beam_width=255)
    assert supports_resident_eval(dec)
    plan = make_buckets(order_and_prune(read_manifest(short_manifest))[:1], 1, shuffle=False)
    loader = ResidentBatchLoader(plan, pkg.alphabet, device="cpu")
    got = list(ResidentEvaluator(model, pkg.frontend_config, dec).pairs(loader))
    eval_step = make_eval_step(model, pkg.frontend_config)
    batch = next(iter(loader.epoch(0)))
    assert got == list(zip(dec.decode(*eval_step(batch.waves, batch.wave_lengths)), batch.texts))
