"""A configuration, a traffic mix, a per-layer metric and a cell are
added by files and entries alone: the harness finds them by name."""

import json
import shutil

import pytest

from benchmark.lib.harness import BENCH_DIR, Result
from benchmark.tests import tiny


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark with a new config, mix, metric, limits and
    cell dropped in, and none of its files edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "ds2_bigru800.json").read_text())
    cfg["model"].update(tiny.TINY_MODEL)
    (b / "configs" / "ds2_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "mixes" / "train.json").read_text())
    mix.update(tiny.TINY_MIX["train"])
    (b / "mixes" / "tiny_train.json").write_text(json.dumps(mix))
    (b / "metrics" / "steps_seen.train.py").write_text(
        "def read(work):\n    return float(len(work['steps'])) if work.get('steps') else None\n")
    (b / "limits" / "ds2_tiny.tiny_train.json").write_text(
        (b / "limits" / "ds2_bigru800.train.json").read_text())
    bench["configs"].append({"name": "ds2_tiny", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/ds2_tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "ds2_tiny.tiny_train", "config": "ds2_tiny",
                               "traffic": "tiny_train", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("ds2_tiny.tiny_train")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["ds2_tiny.tiny_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_files_are_found(checkout, monkeypatch):
    import torch

    from benchmark.run import load_module

    run = load_module(checkout / "benchmark" / "run.py", "copied_run")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    ctx = run.make_context(bench, "ds2_tiny.tiny_train", 2 ** 31 + 9, 0.5, False,
                           torch.device("cpu"))
    assert ctx.cfg["model"]["hidden_size"] == tiny.TINY_MODEL["hidden_size"]
    assert ctx.mix["utterances"] == tiny.TINY_MIX["train"]["utterances"]
    torch.set_num_threads(2)
    res = run.run_entry(ctx)
    assert res.correct
    e2e = run.metrics_of(bench, ctx, res)
    assert set(e2e) == {"train_audio_s_per_s", "setup_s"}
    ctx.trace = True
    per_layer = run.metrics_of(bench, ctx, res)
    assert per_layer["steps_seen.train"]["value"] == len(res.work["steps"])
    # readers that find no trace leave their metrics out
    assert "idle_share.train" not in per_layer


def test_reader_that_finds_nothing_is_left_out(checkout):
    import torch

    from benchmark.run import load_module

    run = load_module(checkout / "benchmark" / "run.py", "copied_run2")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    ctx = run.make_context(bench, "ds2_tiny.tiny_train", 1, 0.5, True, torch.device("cpu"))
    assert run.metrics_of(bench, ctx, Result(work={"entry": "train", "steps": []})) == {}
