"""tpuasr_torch stands alone: importing every module of the port loads
no JAX, flax or tpuasr module, and its entry points run on the GPU or
fail — never silently on the CPU — unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import tpuasr_torch
names = ["tpuasr_torch"] + [m.name for m in pkgutil.walk_packages(
    tpuasr_torch.__path__, "tpuasr_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpuasr"))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_tpuasr():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


def test_sources_name_no_jax_import():
    for path in list((REPO / "tpuasr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "tpuasr"), (path, line)


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from tpuasr_torch.cli.test import main as test_main
    from tpuasr_torch.cli.transcribe import main
    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.serve import TranscriptionService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TranscriptionService(str(tmp_path / "missing.ckpt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model-path", "m", "--audio-path", "a.wav"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_main(["--model-path", "m", "--test-manifest", "t.csv"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
