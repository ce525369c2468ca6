"""The run refuses to print a result once a forbidden module (by whole
top-level name) is loaded."""

import sys
import types

import pytest

from benchmark import run
from benchmark.lib.harness import Result
from benchmark.tests import tiny


@pytest.fixture
def finished(capsys):
    bench = run.json.loads((run.ROOT / "BENCHMARK.json").read_text())
    ctx = tiny.context("ds2_bigru800.train")
    res = Result(e2e={"setup_s": 1.0, "train_audio_s_per_s": 2.0}, attempted=1,
                 checks=[("loss_rel_gap", 0.0, 1.0)])

    def go():
        rc = run.finish(bench, ctx, res, {"platform": "gpu", "kind": "x", "count": 1,
                                          "memory_peak_bytes": 0})
        return rc, capsys.readouterr()
    return go


@pytest.mark.parametrize("name", ["tpuasr", "tpuasr.model.ds2", "jax", "jaxlib", "flax.linen"])
def test_forbidden_module_fails_the_run(finished, monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc, out = finished()
    assert rc != 0
    assert out.out == ""
    assert name.split(".")[0] in out.err


def test_port_alone_passes(finished, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "tpuasr_torch", types.ModuleType("tpuasr_torch"))
    rc, out = finished()
    assert rc == 0
    line = run.json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check loss_rel_gap")


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", "ds2_bigru800.train", "--seed", str(2 ** 31 + 5),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
