"""Shared helpers of the tpuasr_torch parity tests (test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the tests of a module that imports this
    fixture. Their tensors are tiny and their loops many; with the
    suite's workers sharing the cores, torch's default pool (a thread a
    core in every worker) spins against the other workers and runs them
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def gru_inputs(rng, t, b, h, nd=2, lengths=None, n_gates=3):
    """Seeded numpy inputs of the fused GRU (or, with ``n_gates=4``, the
    fused LSTM): xg (T, D, B, GH), w_h (D, H, GH), b_h (D, GH), mask
    (T, D, B) with direction 1 in the time-flipped layout (valid where
    t >= T - len)."""
    g = n_gates
    xg = (rng.randn(t, nd, b, g * h) * 0.5).astype(np.float32)
    w_h = (rng.randn(nd, h, g * h) * 0.3).astype(np.float32)
    b_h = (rng.randn(nd, g * h) * 0.1).astype(np.float32)
    if lengths is None:
        lengths = rng.randint(0, t + 1, size=(b,))
    lengths = np.asarray(lengths)
    m_fwd = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    m_bwd = (np.arange(t)[:, None] >= (t - lengths)[None, :]).astype(np.float32)
    mask = np.stack([m_fwd, m_bwd][:nd], axis=1)
    return xg, w_h, b_h, mask


def gate_major(xg, w_h, b_h):
    """K1's (T, D, B, 3H) / (D, H, 3H) / (D, 3H) arrays relaid out as
    K5's gate-major (T, D, 3, B, H) / (D, 3, H, H) / (D, 3, H)."""
    t, nd, b, g3 = xg.shape
    h = g3 // 3
    return (np.ascontiguousarray(xg.reshape(t, nd, b, 3, h).transpose(0, 1, 3, 2, 4)),
            np.ascontiguousarray(w_h.reshape(nd, h, 3, h).transpose(0, 2, 1, 3)),
            np.ascontiguousarray(b_h.reshape(nd, 3, h)))


def use_private_tpuasr_native(tmp_dir, mp) -> None:
    """Point tpuasr's native decoder (``tpuasr.decode.native``) at a build
    of ``native/ctc_beam.cpp`` in ``tmp_dir`` (``native/Makefile``'s
    flags), through the MonkeyPatch ``mp``. Its own library,
    ``native/libtpuasr_native.so``, is deleted and rebuilt by
    ``tests/test_native.py`` while other workers run."""
    import subprocess

    import tpuasr.decode.native as jnative

    out = str(tmp_dir / "libtpuasr_native.so")
    subprocess.run(["c++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
                    "-shared", "-o", out, jnative._NATIVE_DIR + "/ctc_beam.cpp",
                    "-lpthread"], check=True, capture_output=True)
    mp.setattr(jnative, "_LIB_PATH", out)
    mp.setattr(jnative, "_lib", None)


# ------------------------------------------------------------ distributed

TESTS_DIR = __file__.rsplit("/", 1)[0]
REPO_DIR = TESTS_DIR.rsplit("/", 1)[0]


def dist_steps(spec: dict, mesh=None) -> dict:
    """Train steps of the port from ``spec`` on this rank's rows of the
    global batch (all of them without a ``mesh``): a model of
    ``spec["model"]`` (a ModelConfig dict) from ``init_train_variables(
    cfg, spec["seed"])``, on the CPU, made this rank's by
    ``train.loop.rank_train_step`` (``direction_tp`` as given), then one
    step a learning rate of ``spec["lrs"]`` on the npz batch
    ``spec["batch"]`` (waves, wave_lengths, labels, label_lengths,
    valid), with ``spec["augment"]`` (AugmentConfig fields, or None)
    drawing from step_generator(cpu, spec["aug_seed"], i). Returns
    {"metrics": [per step], "variables": the flax tree with sharded
    leaves gathered whole, "momentum": the optax trace, "sharded": {name:
    axis}}."""
    from tpuasr_torch.audio.augment import AugmentConfig, make_augment_fn
    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.compat.weights import (
        init_train_variables,
        momentum_buffers,
        momentum_to_opt_state,
        to_jax_variables,
    )
    from tpuasr_torch.model.ds2 import ModelConfig
    from tpuasr_torch.train.loop import rank_train_step
    from tpuasr_torch.train.mesh import Mesh, whole_state, whole_tensors
    from tpuasr_torch.train.step import TrainConfig, step_generator

    mesh = mesh if mesh is not None else Mesh()
    cpu = torch.device("cpu")
    cfg = ModelConfig.from_dict(spec["model"])
    aug = spec.get("augment")
    augment_fn = make_augment_fn(AugmentConfig(**aug)) if aug is not None else None
    model, step = rank_train_step(init_train_variables(cfg, seed=spec["seed"]), cfg,
                                  FrontendConfig(), TrainConfig(max_norm=spec["max_norm"]), cpu,
                                  mesh, spec.get("direction_tp", False), augment_fn)
    batch = np.load(spec["batch"])
    fields = [batch[k] for k in ("waves", "wave_lengths", "labels", "label_lengths", "valid")]
    b = len(fields[0]) // mesh.data_size
    own = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    metrics = []
    for i, lr in enumerate(spec["lrs"]):
        gen = step_generator(cpu, spec["aug_seed"], i) if augment_fn is not None else None
        m = step(*(f[own] for f in fields), lr, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    buffers = whole_tensors(momentum_buffers(model, step.optimizer), model.sharded, mesh)
    return {"metrics": metrics, "variables": to_jax_variables(model, whole_state(model, mesh)),
            "momentum": momentum_to_opt_state(model, step.optimizer, buffers)["1"]["trace"],
            "sharded": model.sharded}


def dist_worker(argv: list) -> None:
    """One gloo rank of ``run_ranks``: ``SPEC --rank R --world-size N
    --dist-url URL`` (what ``cli.multiproc`` appends). Joins the group,
    runs ``dist_steps`` on a make_mesh(N, spec["tp"]) and pickles its
    result to spec["out"]/rank{R}.pt."""
    import argparse
    import json

    import torch.distributed as dist

    from tpuasr_torch.train.mesh import distributed_init, make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("spec")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--dist-url", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.spec) as f:
        spec = json.load(f)
    distributed_init(args.dist_url, args.world_size, args.rank, "gloo")
    try:
        out = dist_steps(spec, make_mesh(args.world_size, spec["tp"]))
        torch.save(out, f"{spec['out']}/rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


def child_env() -> dict:
    """The environment of a child process of the tests: this repository
    on the path, one thread."""
    import os

    env = dict(os.environ)
    parts = [REPO_DIR] + [p for p in env.get("PYTHONPATH", "").split(":") if p]
    env["PYTHONPATH"] = ":".join(dict.fromkeys(parts))
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_multiproc(world: int, dist_url: str, command: list, timeout: float) -> tuple:
    """``tpuasr_torch.cli.multiproc --world-size world --dist-url dist_url
    -- *command`` in a session of its own (``child_env``). Past
    ``timeout`` seconds the whole session, launcher and ranks, is killed
    and the caller fails. Returns (exit code, the ranks' output and
    errors together)."""
    import os
    import signal
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuasr_torch.cli.multiproc", "--world-size", str(world),
         "--dist-url", dist_url, "--", *command], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=child_env(), cwd=REPO_DIR,
        start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        pytest.fail(f"{world} ranks outlasted {timeout} s:\n{out[-4000:]}")
    return proc.returncode, out


def run_ranks(spec: dict, tmp_dir, timeout: float = 240.0) -> list:
    """``spec["world"]`` gloo ranks through ``run_multiproc``, each a fresh
    interpreter that imports tpuasr_torch and nothing of JAX, running
    ``dist_worker`` at a file:// rendezvous in ``tmp_dir``; returns their
    results in rank order. A rank that fails fails the caller."""
    import json
    import sys

    spec = {**spec, "out": str(tmp_dir)}
    path = f"{tmp_dir}/spec.json"
    with open(path, "w") as f:
        json.dump(spec, f)
    code = (f"import sys; sys.path.insert(0, {TESTS_DIR!r}); import torch_helpers; "
            "torch_helpers.dist_worker(sys.argv[1:])")
    rc, out = run_multiproc(spec["world"], f"file://{tmp_dir}/rendezvous",
                            [sys.executable, "-c", code, path], timeout)
    assert rc == 0, out[-4000:]
    return [torch.load(f"{tmp_dir}/rank{r}.pt", weights_only=False)
            for r in range(spec["world"])]
