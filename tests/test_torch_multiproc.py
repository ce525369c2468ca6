"""tpuasr_torch.cli.multiproc and the distributed train CLI on the CPU.

The launcher plumbs rank, world and URL into its children as
tpuasr.cli.multiproc does (tests/test_multiproc.py's check), and a
child that fails stops the others. Then ``cli.multiproc --world-size 2
-- cli.train --world-size 2 --device cpu`` (gloo, a file:// rendezvous)
trains one epoch of a tiny corpus whose first global batch spans two
buckets (per-batch loader, and the device-resident corpus, whose
one-bucket batches are the same here): rank 0 alone logs and writes the
checkpoint, which loads in
both packages and resumes at world 1; each logged step equals the
port's single-process step on the two ranks' batches concatenated and
padded to the longer: loss, param_norm and the parameters after the
epoch within 1e-5 (as the data-parallel step of
tests/test_torch_distributed.py), grad_norm within 5e-5, since the
single-process step's own grad_norm moves by up to 9e-6 when only the
padding of its batch grows. ``--mesh-tp 2`` (direction TP) and 4
(gate-axis TP) on as many ranks, with validation, write the one-process
run's checkpoint.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread, run_multiproc  # noqa: F401
from tpuasr.train.checkpoint import load_checkpoint as jax_load_checkpoint
from tpuasr_torch.cli import synth_corpus
from tpuasr_torch.cli import train as train_cli
from tpuasr_torch.compat.weights import init_train_variables, model_from_variables
from tpuasr_torch.data.buckets import BucketSpec, make_buckets
from tpuasr_torch.data.loader import AudioBatchLoader
from tpuasr_torch.data.manifest import order_and_prune, read_manifest
from tpuasr_torch.train.checkpoint import load_checkpoint
from tpuasr_torch.train.step import TrainConfig, make_train_step


def _launch(tmp_path, *command, world=2, timeout=120):
    """(exit code, output) of ``cli.multiproc`` over ``command``."""
    return run_multiproc(world, f"file://{tmp_path}/rendezvous", list(command), timeout)


def test_multiproc_launcher_plumbs_rank(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(
        "import os, sys\n"
        "rank = os.environ['TPUASR_PROCESS_ID']\n"
        "out = os.path.join(os.path.dirname(__file__), f'rank{rank}.txt')\n"
        "open(out, 'w').write(' '.join(sys.argv[1:]) + '|' +\n"
        "    os.environ['TPUASR_NUM_PROCESSES'] + '|' +\n"
        "    os.environ['TPUASR_COORDINATOR'])\n")
    rc, out = _launch(tmp_path, sys.executable, str(child), "--foo", "bar")
    assert rc == 0, out[-2000:]
    for rank in range(2):
        argv, world, coord = (tmp_path / f"rank{rank}.txt").read_text().split("|")
        assert f"--rank {rank}" in argv and "--world-size 2" in argv and "--foo bar" in argv
        assert f"--dist-url file://{tmp_path}/rendezvous" in argv
        assert world == "2" and coord == f"file://{tmp_path}/rendezvous"


def test_multiproc_stops_the_ranks_when_one_fails(tmp_path):
    """Rank 1 fails at once; rank 0 would wait a minute (in a real run,
    in a collective for rank 1): the launcher stops it and fails."""
    child = tmp_path / "child.py"
    child.write_text("import os, sys, time\n"
                     "if os.environ['TPUASR_PROCESS_ID'] == '1': sys.exit(3)\n"
                     "time.sleep(60)\n")
    t0 = time.monotonic()
    rc, _ = _launch(tmp_path, sys.executable, str(child))
    assert rc != 0
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("device,cards,error,match", [
    ("cuda:1", 2, SystemExit, None),
    ("cuda", 1, ValueError, r"2 ranks on 1 card.*--dist-backend gloo"),
], ids=["indexed-card", "nccl-shared-card"])
def test_train_cli_refuses_before_the_rendezvous(monkeypatch, capsys, device, cards, error,
                                                 match):
    """Before any process group is joined: the CLI takes no card index (a
    rank's card is its local rank % the cards), and NCCL refuses two
    ranks on one card, naming gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(error, match=match):
        train_cli.main(["--train-manifest", "unread.csv", "--world-size", "2", "--rank", "0",
                        "--device", device])
    if error is SystemExit:
        assert "invalid choice: 'cuda:1'" in capsys.readouterr().err


BATCH, SEED = 2, 3
FLAGS = ["--hidden-size", "16", "--hidden-layers", "1", "--compute-dtype", "float32",
         "--batch-size", str(BATCH), "--device", "cpu", "--sync-every", "1", "--quiet"]


def _concat(a, b):
    """Two ranks' batches as one: waves and labels padded to the longer."""
    def pad(x, n):
        return np.pad(x, ((0, 0), (0, n - x.shape[1])))
    lw, ll = max(a.waves.shape[1], b.waves.shape[1]), max(a.labels.shape[1], b.labels.shape[1])
    return (np.concatenate([pad(a.waves, lw), pad(b.waves, lw)]),
            np.concatenate([a.wave_lengths, b.wave_lengths]),
            np.concatenate([pad(a.labels, ll), pad(b.labels, ll)]),
            np.concatenate([a.label_lengths, b.label_lengths]),
            np.concatenate([a.valid, b.valid]))


@pytest.mark.parametrize("resident", [False, True], ids=["loader", "resident"])
def test_two_rank_cli_training_equals_one_process_on_the_global_batches(tmp_path, resident):
    # 2 utterances of 0.9 s (the 1 s bucket) and 6 of 1.3 s (the 1.5 s one)
    lines = [Path(synth_corpus.generate(str(tmp_path / name), n, dur, 0.0, seed=SEED)["train"])
             .read_text() for name, n, dur in (("short", 2, 0.9), ("long", 6, 1.3))]
    paths = {"train": str(tmp_path / "train.csv")}
    Path(paths["train"]).write_text("".join(lines))
    out = tmp_path / "run"
    rc, log = _launch(tmp_path, sys.executable, "-m", "tpuasr_torch.cli.train",
                      "--train-manifest", paths["train"], *FLAGS, "--epochs", "1",
                      "--checkpoint", "--save-folder", str(out),
                      "--model-path", str(out / "best.ckpt"), "--log-dir", str(out / "log"),
                      "--world-size", "2", *(["--device-resident-audio"] if resident else []),
                      timeout=300)
    assert rc == 0, log[-4000:]

    rows = [json.loads(line) for line in (out / "log" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "train/loss" in r]
    assert len(steps) == 2  # rank 0 alone logs: 4 batches, 2 global steps
    pkg = load_checkpoint(str(out / "tpuasr_1.ckpt"))
    jpkg = jax_load_checkpoint(str(out / "tpuasr_1.ckpt"))
    np.testing.assert_array_equal(
        np.asarray(jpkg.variables["params"]["rnn0"]["bi"]["recurrent_kernel"]),
        pkg.variables["params"]["rnn0"]["bi"]["recurrent_kernel"])
    assert (pkg.epoch, pkg.iteration) == (1, 2)

    # the single-process step on the ranks' batches, concatenated
    plan = make_buckets(order_and_prune(read_manifest(paths["train"])), BATCH, BucketSpec(),
                        seed=123456)
    batches = list(AudioBatchLoader(plan, pkg.alphabet, transfer_dtype="int16").epoch(0))
    assert batches[0].bucket != batches[1].bucket  # the first global batch spans two buckets
    model = model_from_variables(init_train_variables(pkg.model_config, seed=123456),
                                 pkg.model_config, torch.device("cpu"), trainable=True)
    step = make_train_step(model, pkg.frontend_config, TrainConfig())
    for s, logged in enumerate(steps):
        m = step(*_concat(batches[2 * s], batches[2 * s + 1]), TrainConfig().lr_at_epoch(0))
        for k in ("loss", "param_norm", "n_ok", "n_frames"):
            np.testing.assert_allclose(logged[f"train/{k}"], float(m[k]), rtol=1e-5, err_msg=k)
        # grad_norm sums squares of conv gradients taken over the padded
        # time axis: padding the one-process batch 0.1-1 s further moves
        # it by up to 9e-6 (relative); the ranks' step is 1.3e-5 from it
        np.testing.assert_allclose(steps[s]["train/grad_norm"], float(m["grad_norm"]),
                                   rtol=5e-5)
    got = pkg.variables["params"]["rnn0"]["bi"]["recurrent_kernel"]
    want = model.rnns[0].bi.recurrent_kernel.detach().numpy()
    assert np.abs(got - want).max() < 1e-5

    # the rank-0 checkpoint resumes in one process
    resumed = tmp_path / "resumed"
    assert train_cli.main(["--train-manifest", paths["train"], *FLAGS, "--epochs", "2",
                           "--continue-from", str(out / "tpuasr_1.ckpt"), "--checkpoint",
                           "--save-folder", str(resumed),
                           "--model-path", str(resumed / "best.ckpt")]) == 0
    assert load_checkpoint(str(resumed / "tpuasr_2.ckpt")).iteration == 2 + 4


@pytest.mark.parametrize("tp", [2, 4], ids=["direction", "gate"])
def test_tensor_parallel_cli_training_equals_one_process(tmp_path, tp):
    """``--world-size tp --mesh-tp tp``: one data rank, so the run is the
    one-process run on the same batches. At tp 2 the BiGRU runs one
    direction a rank, at 4 its gate columns are sharded; validation runs
    through the sharded model on every rank, and rank 0's checkpoint
    (sharded leaves gathered) holds the one-process run's WER, and its
    weights and momentum within 1e-4 relative norm a leaf."""
    paths = synth_corpus.generate(str(tmp_path / "corpus"), 6, 0.9, 1 / 3, seed=SEED)
    runs = {}
    for world in (tp, 1):
        out = tmp_path / f"w{world}"
        argv = ["--train-manifest", paths["train"], "--val-manifest", paths["val"], *FLAGS,
                "--epochs", "1", "--checkpoint", "--save-folder", str(out),
                "--model-path", str(out / "best.ckpt")]
        if world == 1:
            assert train_cli.main(argv) == 0
        else:
            rc, log = _launch(tmp_path, sys.executable, "-m", "tpuasr_torch.cli.train", *argv,
                              "--mesh-tp", str(tp), world=world, timeout=300)
            assert rc == 0, log[-4000:]
        runs[world] = load_checkpoint(str(out / "tpuasr_1.ckpt"))
    got, want = runs[tp], runs[1]
    assert got.wer_history == want.wer_history and got.iteration == want.iteration == 2
    # every leaf within 1e-4 relative norm (the f32 sums in other orders
    # leave ~1.4e-5 on the momentum, 1.0e-5 on the weights)
    for tree in ("variables", "opt_state"):
        g, w = _flat(getattr(got, tree)), _flat(getattr(want, tree))
        assert g.keys() == w.keys()
        for k in w:
            assert np.linalg.norm(g[k] - w[k]) <= 1e-4 * np.linalg.norm(w[k]), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out
