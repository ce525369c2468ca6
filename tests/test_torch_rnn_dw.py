"""The RNN backwards' weight gradients (``tpuasr_torch.ops.gru.
rnn_weight_grads``): dw and db of all four autograd functions, K1's
packed [dr, dz, dn, dhn] (gates 0, 1, 3), K4's dhg (all four gates),
K5's gate-major dg (gates 0, 1, 3) and K6's d(pre) with h read from ys a
step back.

On the CPU (every tier-1 run): the helper's einsum path gives, bit for
bit, what each function's own inline expression gave before the helper
(the ``cat`` of K1's columns, the ``stack`` of K5's gates, the shifted
ys of K6), its counters record only under a profile, and the kernel's
grid plan (``rnn_plan.rnn_dw_plan``) covers every row once. On a card
(marker ``cuda``; this file imports no JAX, so it runs there on its own
with ``python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_rnn_dw.py``): the kernel ``dw_gemm_bf16`` against the
f32 einsum of the same bf16 values within a relative Frobenius gap of
1e-5 for dw and for db (bf16 products are exact in f32, so only the
order of the f32 additions differs), bit-equal to it where every partial
sum is exact (small integers times powers of two), and bit-identical on
two calls (no atomics in the sums).
"""

import importlib.util

import numpy as np
import pytest
import torch

from benchmark.lib.harness import BENCH_DIR
from torch_helpers import cuda, gru_inputs, one_intra_op_thread  # noqa: F401 (fixtures)
from tpuasr_torch import profiling
from tpuasr_torch.ops import _build, rnn_plan
from tpuasr_torch.ops.gru import (
    BiGRUFunction,
    rnn_weight_grads,
    rnn_weight_grads_reference,
    shift_time,
)

F32 = torch.float32
# layout: (gates the backward emits, gates w_h reads, gate-major, shift)
LAYOUTS = {
    "K1": (4, (0, 1, 3), False, 0),
    "K4": (4, (0, 1, 2, 3), False, 0),
    "K5": (4, (0, 1, 3), True, 0),
    "K6": (1, (0,), False, 1),
}


def _operands(layout, t, b, h, nd, seed, device="cpu", w_dtype=F32, exact=False):
    """Seeded bf16 h and gate gradients in ``layout``'s shapes, and w_h
    and b_h (values unused) that give dw and db their shapes and dtypes.
    ``exact``: small integers times powers of two, so that every partial
    sum of dw and db is exact in f32 whatever its order."""
    emitted, gates, gate_major, _ = LAYOUTS[layout]
    gen = torch.Generator().manual_seed(seed)
    d_shape = (t, nd, emitted, b, h) if gate_major else (t, nd, b, emitted * h)
    if exact:
        hs = torch.randint(-4, 5, (t, nd, b, h), generator=gen) * 0.125
        dhg = torch.randint(-8, 9, d_shape, generator=gen) * 0.0625
    else:
        hs = torch.randn((t, nd, b, h), generator=gen) * 0.5
        dhg = torch.randn(d_shape, generator=gen) * 0.1
    ng = len(gates)
    w_h = torch.zeros((nd, ng, h, h) if gate_major else (nd, h, ng * h), dtype=w_dtype)
    b_h = torch.zeros((nd, ng, h) if gate_major else (nd, ng * h))
    return [x.to(device) for x in (hs.to(torch.bfloat16), dhg.to(torch.bfloat16), w_h, b_h)]


def _inline(layout, h, dhg, w_h, b_h):
    """The functions' own dw and db expressions before ``rnn_weight_grads``."""
    hd = h.shape[-1]
    if layout == "K1":  # BiGRUFunction
        g = torch.cat([dhg[..., :2 * hd], dhg[..., 3 * hd:]], dim=-1).to(F32)
        dw, db = torch.einsum("tdbh,tdbg->dhg", h.to(F32), g), g.sum(dim=(0, 2))
    elif layout == "K4":  # BiLSTMFunction
        g = dhg.to(F32)
        dw, db = torch.einsum("tdbh,tdbg->dhg", h.to(F32), g), g.sum(dim=(0, 2))
    elif layout == "K5":  # BiGRU2Function
        gf = dhg.to(F32)
        g = torch.stack([gf[:, :, 0], gf[:, :, 1], gf[:, :, 3]], dim=2)
        dw, db = torch.einsum("tdbh,tdgbk->dghk", h.to(F32), g), g.sum(dim=(0, 3))
    else:  # BiRNNFunction: h is ys
        g = dhg.to(F32)
        dw = torch.einsum("tdbh,tdbg->dhg", shift_time(h).to(F32), g)
        db = g.sum(dim=(0, 2))
    return dw.to(w_h.dtype), db.to(b_h.dtype)


def _grads(layout, h, dhg, w_h, b_h):
    _, gates, _, shift = LAYOUTS[layout]
    return rnn_weight_grads(h, dhg, gates, w_h, b_h, shift=shift)


@pytest.mark.parametrize("nd", [1, 2], ids=["D1", "D2"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cpu_path_is_each_functions_old_expression(layout, nd):
    """bf16 operands and bf16 w_h, as the model hands them over."""
    ops = _operands(layout, 7, 3, 8, nd, seed=nd, w_dtype=torch.bfloat16)
    for got, want in zip(_grads(layout, *ops), _inline(layout, *ops)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_the_kernel_has_a_library_of_its_own():
    """Every backward reaches the kernel through one library, which no
    backward's name selects; it is rebuilt when the shared backward
    header changes."""
    assert [p.name for p in _build.sources("rnn_dw")] == ["rnn_dw.cu", "rnn_bwd.cuh", "rnn.cuh"]
    for name in ("bigru_bwd", "bigru2_bwd", "bilstm_bwd", "birnn_bwd"):
        assert "tpuasr_rnn_dw" not in (_build.CSRC / f"{name}.cu").read_text()
    assert "tpuasr_rnn_dw" not in (_build.CSRC / "rnn_bwd.cuh").read_text()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reference_is_the_cpu_path(layout):
    """The plain version that chip_smoke holds the kernel to is the
    helper's own einsum path, bit for bit, in f32 and in bf16."""
    for w_dtype in (F32, torch.bfloat16):
        ops = _operands(layout, 5, 4, 13, 2, seed=11, w_dtype=w_dtype)
        _, gates, _, shift = LAYOUTS[layout]
        want = rnn_weight_grads_reference(*ops[:2], gates, *ops[2:], shift)
        for got, w, dtype in zip(_grads(layout, *ops), want, (w_dtype, F32)):
            assert got.dtype == w.dtype == dtype
            assert torch.equal(got, w)


def test_dw_calls_count_only_under_a_profile():
    ops = _operands("K4", 3, 2, 8, 2, seed=5)
    profiling.reset()
    _grads("K4", *ops)
    assert profiling.recorded()["counters"] == {}
    xg, w_h, b_h, mask = (torch.from_numpy(a)
                          for a in gru_inputs(np.random.RandomState(6), 4, 2, 8))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _grads("K4", *ops)
        leaves = [a.clone().requires_grad_() for a in (xg, w_h, b_h)]
        BiGRUFunction.apply(*leaves, mask).sum().backward()
    assert profiling.recorded()["counters"] == {"rnn.dw_einsum_calls": 2}
    profiling.reset()


@pytest.mark.parametrize("metric", ["rnn_dw_kernel_share.train",
                                    "rnn_dw_kernel_share.train_rnn"])
def test_benchmark_share_reads_the_counters(metric):
    """The benchmark's reader: 100 x kernel calls over all backwards of the
    traced window; nothing where the program counted none (a program
    without the kernel) or the entry is not training."""
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), BENCH_DIR / "metrics" / f"{metric}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    profiling.reset()
    assert reader.read({"entry": "train"}) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("rnn.dw_kernel_calls", 3)
        profiling.count("rnn.dw_einsum_calls", 1)
    assert reader.read({"entry": "train"}) == 75.0
    assert reader.read({"entry": "serve"}) is None
    profiling.reset()


@pytest.mark.parametrize("h,g", [(8, 24), (13, 52), (800, 2400), (800, 3200), (1280, 1280)])
def test_dw_plan_deals_every_k_step_once(h, g):
    """Every block's range is non-empty and the ranges tile the k-steps
    of every tile in order; no more blocks than the card holds at once."""
    for nd in (1, 2):
        for m in (1, 31, 33, 259, 1632, 8032, 26432):
            plan = rnn_plan.rnn_dw_plan(m, h, g, nd, 132)
            total = plan.tiles * plan.ksteps
            assert plan.tiles == nd * -(-(h + 1) // 128) * -(-g // 128)
            assert plan.ksteps == -(-m // rnn_plan.DW_KSTEP)
            assert 1 <= plan.blocks <= 132 * rnn_plan.DW_BLOCKS_PER_SM
            assert (plan.blocks - 1) * plan.per < total <= plan.blocks * plan.per


# (T, B) of the kernel cases: T*B = 259 is no multiple of a tile's 128 or
# a k-step's 32; T = 1 has no h_{t-1} at all when read from ys
KERNEL_SHAPES = [(37, 7), (1, 5)]


def _gap(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    *[(lay, nd, h, t, b) for lay in LAYOUTS for nd in (1, 2) for h in (8, 13, 800, 1280)
      for t, b in KERNEL_SHAPES],
    *[(lay, 2, 1280 if lay == "K6" else 800, 251, 32) for lay in LAYOUTS],  # split rows
    ("exact", 2, 800, 251, 32), ("exact", 1, 13, 37, 7),
], ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_the_f32_einsum(case, cuda):  # noqa: F811
    name, nd, h, t, b = case
    layout = "K1" if name == "exact" else name
    ops = _operands(layout, t, b, h, nd, seed=h + t, device=cuda, exact=name == "exact")
    got = _grads(layout, *ops)
    again = _grads(layout, *ops)
    want = _inline(layout, *ops)  # the f32 einsum on the card, TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype == F32 and g.shape == w.shape
        assert torch.equal(g, a)
        if name == "exact":
            assert torch.equal(g, w)
        else:
            assert _gap(g, w) <= 1e-5


@pytest.mark.cuda
def test_kernel_calls_count_under_a_profile(cuda):  # noqa: F811
    ops = _operands("K6", 5, 3, 16, 2, seed=2, device=cuda)
    profiling.reset()
    launches = rnn_weight_grads.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _grads("K6", *ops)
        _grads("K6", *[x.float() if x.dtype == torch.bfloat16 else x for x in ops])
        with pytest.raises(ValueError, match="contiguous"):  # raises before any launch
            _grads("K6", ops[0].transpose(0, 1).contiguous().transpose(0, 1), *ops[1:])
    assert profiling.recorded()["counters"] == {"rnn.dw_kernel_calls": 1,
                                                "rnn.dw_einsum_calls": 1}
    assert rnn_weight_grads.launches == launches + 1
    profiling.reset()
