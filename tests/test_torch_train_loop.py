"""tpuasr_torch.cli.train against tpuasr.cli.train on a tiny model
(hidden 16, 2 layers, f32) and a synthetic 1 s corpus (batch 8: the
JAX package shards it over the suite's 8 CPU devices): checkpoints
written by either package resume in the other and continue the same
trajectory. Tolerance: 1e-4 relative on the epoch losses, 1e-4 on every
parameter and running statistic (the same f32 arithmetic in another
order, over a few steps); the momentum traces, which sum gradients of
any scale, within 1e-4 of each trace's largest element."""

import os
import shutil

import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr.cli import train as jax_train_cli
from tpuasr.train.checkpoint import load_checkpoint as jax_load_checkpoint
from tpuasr_torch.cli import synth_corpus
from tpuasr_torch.cli import train as train_cli
from tpuasr_torch.train.checkpoint import load_checkpoint

TINY = ["--hidden-size", "16", "--hidden-layers", "2", "--compute-dtype", "float32",
        "--batch-size", "8", "--lr", "3e-3", "--quiet", "--seed", "5"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return synth_corpus.generate(str(tmp_path_factory.mktemp("corpus")), 16, 1.0, 0.25, seed=2)


def _argv(corpus, out, epochs, *extra):
    return ["--train-manifest", corpus["train"], "--val-manifest", corpus["val"],
            *TINY, "--epochs", str(epochs), "--checkpoint", "--save-folder", str(out),
            "--model-path", str(out / "best.ckpt"), *extra]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _assert_same_run(path, jax_path):
    got, want = load_checkpoint(str(path)), jax_load_checkpoint(str(jax_path))
    assert (got.epoch, got.iteration, got.epoch_batch) == (want.epoch, want.iteration,
                                                           want.epoch_batch)
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-4)
    np.testing.assert_allclose(got.cer_history, want.cer_history, rtol=1e-6)
    a, b = _flat(got.variables), _flat(want.variables)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)
    a, b = _flat(got.opt_state["1"]), _flat(want.opt_state["1"])
    assert a.keys() == b.keys() and got.opt_state["0"] == {}
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4 * np.abs(b[k]).max(),
                                   err_msg=k)


def test_checkpoints_resume_across_packages(corpus, tmp_path):
    # tpuasr trains one epoch; both packages resume it for a second
    assert jax_train_cli.main(_argv(corpus, tmp_path / "j1", 1)) == 0
    start = tmp_path / "j1" / "tpuasr_1.ckpt"
    assert train_cli.main(_argv(corpus, tmp_path / "p2", 2, "--continue-from", str(start),
                                "--device", "cpu")) == 0
    assert jax_train_cli.main(_argv(corpus, tmp_path / "j2", 2, "--continue-from",
                                    str(start))) == 0
    _assert_same_run(tmp_path / "p2" / "tpuasr_2.ckpt", tmp_path / "j2" / "tpuasr_2.ckpt")
    # tpuasr resumes the port's checkpoint, as the port itself does
    port_ckpt = tmp_path / "p2" / "tpuasr_2.ckpt"
    assert jax_train_cli.main(_argv(corpus, tmp_path / "j3", 3, "--continue-from",
                                    str(port_ckpt))) == 0
    assert train_cli.main(_argv(corpus, tmp_path / "p3", 3, "--continue-from",
                                str(port_ckpt), "--device", "cpu")) == 0
    _assert_same_run(tmp_path / "p3" / "tpuasr_3.ckpt", tmp_path / "j3" / "tpuasr_3.ckpt")
    pkg = load_checkpoint(str(tmp_path / "p3" / "best.ckpt"))
    assert pkg.epoch in (2, 3) and np.isfinite(pkg.best_wer)


def test_finetune_and_mid_epoch_resume(corpus, tmp_path):
    cpu = ["--device", "cpu"]
    assert train_cli.main(_argv(corpus, tmp_path / "a", 2, "--checkpoint-per-batch", "1",
                                *cpu)) == 0
    full = load_checkpoint(str(tmp_path / "a" / "tpuasr_2.ckpt"))
    # resume after the first batch of epoch 1: the same end state
    mid = tmp_path / "a" / "tpuasr_e1_b1.ckpt"
    assert load_checkpoint(str(mid)).epoch_batch == 1
    assert train_cli.main(_argv(corpus, tmp_path / "b", 2, "--continue-from", str(mid),
                                *cpu)) == 0
    again = load_checkpoint(str(tmp_path / "b" / "tpuasr_2.ckpt"))
    assert again.iteration == full.iteration
    for k, v in _flat(full.variables).items():
        np.testing.assert_allclose(_flat(again.variables)[k], v, rtol=1e-5, atol=1e-6)
    # --finetune keeps the weights and starts the schedule afresh
    assert train_cli.main(_argv(corpus, tmp_path / "c", 1, "--continue-from",
                                str(tmp_path / "a" / "tpuasr_2.ckpt"), "--finetune",
                                *cpu)) == 0
    ft = load_checkpoint(str(tmp_path / "c" / "tpuasr_1.ckpt"))
    assert ft.epoch == 1 and len(ft.loss_history) == 1


def test_epoch_without_validation_keeps_the_best_model(corpus, tmp_path):
    """An epoch without validation (WER NaN) writes the same files in both
    packages: its per-epoch checkpoint, and model_path as well, which
    then holds that epoch's model rather than the best one
    (tpuasr/train/loop.py:523)."""
    assert jax_train_cli.main(_argv(corpus, tmp_path / "j1", 1)) == 0
    start = tmp_path / "j1" / "tpuasr_1.ckpt"
    for name, main, extra in (("j", jax_train_cli.main, []),
                              ("p", train_cli.main, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        shutil.copy(tmp_path / "j1" / "best.ckpt", out / "best.ckpt")
        argv = ["--train-manifest", corpus["train"], *TINY, "--epochs", "2", "--checkpoint",
                "--save-folder", str(out), "--model-path", str(out / "best.ckpt"),
                "--continue-from", str(start), *extra]
        assert main(argv) == 0
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    for f in ("tpuasr_2.ckpt", "best.ckpt"):
        _assert_same_run(tmp_path / "p" / f, tmp_path / "j" / f)
    best = load_checkpoint(str(tmp_path / "p" / "best.ckpt"))
    assert best.epoch == 2 and np.isnan(best.wer_history[-1])


@pytest.mark.parametrize("flag", [["--world-size", "2", "--rank", "2"], ["--mesh-tp", "2"]])
def test_unported_flags_raise(flag, corpus):
    """What no (data, model) grid runs raises before any rendezvous: a
    rank outside the world, a --mesh-tp that does not divide it."""
    with pytest.raises(ValueError, match=r"--rank 2 must be in|--mesh-tp 2 does not divide"):
        train_cli.main(["--train-manifest", corpus["train"], *flag, "--device", "cpu"])


def test_train_needs_a_gpu_unless_cpu_is_asked_for(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(_argv(corpus, tmp_path, 1))
