"""The port's hand-written CUDA kernels against their plain PyTorch
versions. The GPU tests (marker ``cuda``) skip without a card; this file
imports no JAX, so on a GPU machine it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Tolerances (BiGRU forward): f32 max-abs 1e-4, the same f32 products
summed in another order; bf16 max-abs 3e-2 and mean-abs 1e-3, because
the carried h is rounded to bf16 every step and an ulp moved by the
summation order is carried on.

BiGRU backward (packed gate gradients): f32 max-abs 1e-4 relative to
the largest |packed| (the f32 carry sums the same products in another
order); bf16 max-abs 2e-2 and mean-abs 1e-3 relative to it (packed is
rounded to bf16, 2**-8 relative, and a moved rounding of a recomputed
gate can flip one bf16 ulp of the output).

BiLSTM (K4) forward, ys and cs, and backward, dhg: the BiGRU's
tolerances, for the same reasons (h carried rounded to bf16, c carried
in f32 and emitted rounded, dhg rounded; another f32 summation order).
Gate-major BiGRU (K5): the BiGRU's tolerances against its plain
version, and bit-equal to K1 on the relaid-out inputs (the same
compiled body with other strides).

Vanilla tanh RNN (K6f, K6b): the BiGRU's tolerances, for the same
reasons (h carried rounded to bf16; the backward reads the same rounded
ys as its plain version and rounds only its emitted d(pre); another f32
summation order).

CTC alpha and beta: alphas within rel 1e-5 of the plain recursion on
frames where they are finite, dL/demit within 2e-4 absolute
(tests/test_pallas_ctc.py's loss and gradient tolerances); the kernels
compute every cell with the plain version's operations in its order, on
the same card's expf and logf, so they agree bit for bit, and a warp
that skips an lse3 whose inputs are all log-zero writes the LOG_EPS that
lse3 gives.

Prefix beam search (K3): parents and chars equal to the plain version's
and scores within 1e-5 relative (at least 1e-5 absolute), in every LM
mode and in stateful mode; both run the same f32 operations in the same
order on the same card's exp/log1p, so only a sum over several absorbed
extends, taken in another order, could move a last bit.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from torch_helpers import cuda, gate_major, gru_inputs  # noqa: F401 (fixture)
from tpuasr_torch.decode.beam import pack_lm_tables, pack_word_lm_tables
from tpuasr_torch.decode.lm import train_ngram
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.ops import _build
from tpuasr_torch.ops.beam import beam_scan, beam_scan_reference, flat_tables, make_beam_state
from tpuasr_torch.ops.ctc import (
    LOG_EPS,
    CTCFromEmit,
    ctc_alpha,
    ctc_alpha_reference,
    ctc_beta,
    ctc_beta_reference,
)
from tpuasr_torch.ops import birnn as birnn_mod
from tpuasr_torch.ops.birnn import (
    BiRNNFunction,
    birnn_backward,
    birnn_backward_reference,
    birnn_forward,
    birnn_reference,
)
from tpuasr_torch.ops.gru import (
    BWD_LAUNCHES,
    BiGRUFunction,
    bigru_backward,
    bigru_backward_reference,
    bigru_forward,
    bigru_reference,
)
from tpuasr_torch.ops.gru2 import (
    BiGRU2Function,
    bigru2_backward,
    bigru2_backward_reference,
    bigru2_forward,
    bigru2_reference,
)
from tpuasr_torch.ops.lstm import (
    BiLSTMFunction,
    bilstm_backward,
    bilstm_backward_reference,
    bilstm_forward,
    bilstm_reference,
)

CASES = [  # (T, B, H, D)
    pytest.param(10, 4, 16, 2, id="bidir"),
    pytest.param(7, 4, 16, 2, id="T7"),
    pytest.param(6, 96, 16, 2, id="B96"),
    pytest.param(7, 3, 8, 1, id="D1"),
    pytest.param(40, 33, 100, 2, id="ragged-tiles"),
    pytest.param(3, 2, 800, 2, id="H800"),
]


def _args(device, t, b, h, nd, dtype, seed=11):
    rng = np.random.RandomState(seed)
    xg, w_h, b_h, mask = [torch.from_numpy(a).to(device)
                          for a in gru_inputs(rng, t, b, h, nd)]
    return xg.to(dtype), w_h.to(dtype), b_h, mask


def test_library_name_carries_the_source_hash():
    path = _build.library_path("bigru_fwd")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("libbigru_fwd-") and len(path.stem) == len("libbigru_fwd-") + 16


def test_library_name_follows_the_local_headers(tmp_path, monkeypatch):
    """An edited header that a source includes names a new library, so a
    stale build is never loaded; nvcc is not needed for this."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("bilstm_bwd")] == ["bilstm_bwd.cu", "rnn_bwd.cuh",
                                                              "rnn.cuh"]
    assert [p.name for p in _build.sources("bilstm_fwd")] == ["bilstm_fwd.cu", "rnn_fwd.cuh",
                                                              "rnn.cuh"]
    assert [p.name for p in _build.sources("ctc")] == ["ctc.cu"]
    before = {n: _build.library_path(n) for n in ("bigru_fwd", "bigru2_bwd", "ctc")}
    with open(csrc / "rnn.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["bigru_fwd"] != before["bigru_fwd"]
    assert after["bigru2_bwd"] != before["bigru2_bwd"]
    assert after["ctc"] == before["ctc"]
    with open(csrc / "rnn_bwd.cuh", "a") as f:  # the backward's header only
        f.write("// edited\n")
    again = {n: _build.library_path(n) for n in before}
    assert again["bigru2_bwd"] != after["bigru2_bwd"]
    assert again["bigru_fwd"] == after["bigru_fwd"]
    with open(csrc / "rnn_fwd.cuh", "a") as f:  # the forward's header only
        f.write("// edited\n")
    last = {n: _build.library_path(n) for n in before}
    assert last["bigru_fwd"] != again["bigru_fwd"]
    assert last["bigru2_bwd"] == again["bigru2_bwd"]


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    if _build.library_path("bigru_fwd").exists():
        pytest.skip("the library is already built")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("bigru_fwd")


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_reference(t, b, h, nd, dtype, cuda):  # noqa: F811
    args = _args(cuda, t, b, h, nd, dtype)
    before = bigru_forward.launches
    ys = bigru_forward(*args)
    torch.cuda.synchronize()
    assert bigru_forward.launches == before + 1  # one persistent launch, whatever T
    assert ys.shape == (t, nd, b, h) and ys.dtype == dtype
    diff = (ys.float() - bigru_reference(*args).float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4
    else:
        assert diff.max().item() <= 3e-2 and diff.mean().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    xg, w_h, b_h, mask = _args(cuda, 5, 3, 8, 2, torch.bfloat16)
    with pytest.raises(TypeError):
        bigru_forward(xg, w_h.float(), b_h, mask)
    with pytest.raises(TypeError):
        bigru_forward(xg.half(), w_h.half(), b_h, mask)
    with pytest.raises(ValueError, match="contiguous"):
        bigru_forward(xg.transpose(1, 2).contiguous().transpose(1, 2), w_h, b_h, mask)
    with pytest.raises(ValueError):
        bigru_forward(xg, w_h, b_h, mask[:, :, :2])
    with pytest.raises(ValueError):
        bigru_forward(xg, w_h, b_h, mask.cpu())


def _bwd_args(device, t, b, h, nd, dtype, seed=12):
    xg, w_h, b_h, mask = _args(device, t, b, h, nd, dtype, seed)
    ys = bigru_reference(xg, w_h, b_h, mask)
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).contiguous()
    rng = np.random.RandomState(seed + 1)
    dy = torch.from_numpy(rng.randn(t, nd, b, h).astype(np.float32)).to(device, dtype)
    return xg, w_h, b_h, mask, h_prev, dy


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_matches_reference(t, b, h, nd, dtype, cuda):  # noqa: F811
    args = _bwd_args(cuda, t, b, h, nd, dtype)
    before = bigru_backward.launches
    packed = bigru_backward(*args)
    torch.cuda.synchronize()
    assert bigru_backward.launches == before + BWD_LAUNCHES  # whatever T
    assert packed.shape == (t, nd, b, 4 * h) and packed.dtype == dtype
    want = bigru_backward_reference(*args).float()
    scale = want.abs().max().item()
    diff = (packed.float() - want).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4 * scale
    else:
        assert diff.max().item() <= 2e-2 * scale and diff.mean().item() <= 1e-3 * scale


@pytest.mark.cuda
def test_bigru_function_gradients_match_plain_autograd(cuda):  # noqa: F811
    xg, w_h, b_h, mask = _args(cuda, 9, 5, 32, 2, torch.float32)
    rng = np.random.RandomState(4)
    dy = torch.from_numpy(rng.randn(9, 2, 5, 32).astype(np.float32)).to(cuda)
    grads = []
    for fn in (BiGRUFunction.apply, bigru_reference):
        leaves = [a.clone().requires_grad_() for a in (xg, w_h, b_h)]
        (fn(*leaves, mask) * dy).sum().backward()
        grads.append([a.grad for a in leaves])
    for g_k, g_r in zip(*grads):
        assert (g_k - g_r).abs().max().item() <= 3e-4


def _lstm_args(device, t, b, h, nd, dtype, seed=13):
    rng = np.random.RandomState(seed)
    xg, w_h, b_h, mask = [torch.from_numpy(a).to(device)
                          for a in gru_inputs(rng, t, b, h, nd, n_gates=4)]
    return xg.to(dtype), w_h.to(dtype), b_h, mask


def _shift(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]]).contiguous()


def _assert_close(got, want, dtype, scale=1.0):
    """The forward (scale 1) and backward (scale = largest |want|)
    tolerances of the module docstring."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4 * scale
    else:
        assert diff.max().item() <= (3e-2 if scale == 1.0 else 2e-2 * scale)
        assert diff.mean().item() <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_lstm_kernels_match_reference(t, b, h, nd, dtype, cuda):  # noqa: F811
    args = _lstm_args(cuda, t, b, h, nd, dtype)
    before = (bilstm_forward.launches, bilstm_backward.launches)
    ys, cs = bilstm_forward(*args)
    torch.cuda.synchronize()
    assert ys.shape == cs.shape == (t, nd, b, h) and ys.dtype == cs.dtype == dtype
    ys_r, cs_r = bilstm_reference(*args)
    _assert_close(ys, ys_r, dtype)
    _assert_close(cs, cs_r, dtype)
    dy = torch.from_numpy(np.random.RandomState(t).randn(t, nd, b, h).astype(np.float32))
    bwd = (*args, _shift(ys_r), _shift(cs_r), cs_r, dy.to(cuda, dtype))
    dhg = bilstm_backward(*bwd)
    torch.cuda.synchronize()
    assert dhg.shape == (t, nd, b, 4 * h) and dhg.dtype == dtype
    want = bilstm_backward_reference(*bwd)
    _assert_close(dhg, want, dtype, want.float().abs().max().item())
    assert (bilstm_forward.launches, bilstm_backward.launches) == (before[0] + 1,
                                                                   before[1] + BWD_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gru2_kernels_match_reference_and_k1(t, b, h, nd, dtype, cuda):  # noqa: F811
    xg, w_h, b_h, mask = _args(cuda, t, b, h, nd, dtype)
    k5 = [torch.from_numpy(a).to(cuda) for a in
          gate_major(xg.float().cpu().numpy(), w_h.float().cpu().numpy(), b_h.cpu().numpy())]
    k5 = (k5[0].to(dtype), k5[1].to(dtype), k5[2], mask)
    before = (bigru2_forward.launches, bigru2_backward.launches)
    ys = bigru2_forward(*k5)
    torch.cuda.synchronize()
    assert ys.shape == (t, nd, b, h) and ys.dtype == dtype
    _assert_close(ys, bigru2_reference(*k5), dtype)
    assert torch.equal(ys, bigru_forward(xg, w_h, b_h, mask))  # K5f == K1f
    h_prev = _shift(ys)
    dy = torch.from_numpy(np.random.RandomState(t).randn(t, nd, b, h).astype(np.float32))
    dy = dy.to(cuda, dtype)
    dg = bigru2_backward(*k5, h_prev, dy)
    torch.cuda.synchronize()
    assert dg.shape == (t, nd, 4, b, h) and dg.dtype == dtype
    want = bigru2_backward_reference(*k5, h_prev, dy)
    _assert_close(dg, want, dtype, want.float().abs().max().item())
    packed = bigru_backward(xg, w_h, b_h, mask, h_prev, dy)  # K5b == K1b
    assert torch.equal(dg, packed.reshape(t, nd, b, 4, h).permute(0, 1, 3, 2, 4))
    assert (bigru2_forward.launches, bigru2_backward.launches) == (before[0] + 1,
                                                                   before[1] + BWD_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,plain,n_gates", [
    (BiLSTMFunction.apply, lambda *a: bilstm_reference(*a)[0], 4),
    (BiGRU2Function.apply, bigru2_reference, 3),
], ids=["lstm", "gru2"])
def test_new_rnn_functions_gradients_match_plain_autograd(fn, plain, n_gates,
                                                          cuda):  # noqa: F811
    if n_gates == 4:
        xg, w_h, b_h, mask = _lstm_args(cuda, 9, 5, 32, 2, torch.float32)
    else:
        xg, w_h, b_h, mask = [torch.from_numpy(a).to(cuda) for a in (
            *gate_major(*gru_inputs(np.random.RandomState(3), 9, 5, 32, 2)[:3]),
            gru_inputs(np.random.RandomState(3), 9, 5, 32, 2)[3])]
    dy = torch.from_numpy(np.random.RandomState(4).randn(9, 2, 5, 32).astype(np.float32))
    grads = []
    for f in (fn, plain):
        leaves = [a.clone().requires_grad_() for a in (xg, w_h, b_h)]
        (f(*leaves, mask) * dy.to(cuda)).sum().backward()
        grads.append([a.grad for a in leaves])
    for g_k, g_r in zip(*grads):
        assert (g_k - g_r).abs().max().item() <= 3e-4


@pytest.mark.cuda
def test_new_rnn_kernels_reject_what_they_do_not_take(cuda):  # noqa: F811
    xg, w_h, b_h, mask = _lstm_args(cuda, 5, 3, 8, 2, torch.bfloat16)
    with pytest.raises(TypeError):
        bilstm_forward(xg, w_h.float(), b_h, mask)
    with pytest.raises(ValueError):
        bilstm_forward(xg[..., :24].contiguous(), w_h, b_h, mask)  # 3H: a GRU's xg
    ys, cs = bilstm_forward(xg, w_h, b_h, mask)
    with pytest.raises(ValueError, match="contiguous"):
        bilstm_backward(xg, w_h, b_h, mask, ys, cs, cs.transpose(0, 1).contiguous()
                        .transpose(0, 1), ys)
    k5 = gate_major(*[a.float().cpu().numpy() for a in _args(cuda, 5, 3, 8, 2,
                                                             torch.float32)[:3]])
    xg5, w5, b5 = [torch.from_numpy(a).to(cuda) for a in k5]
    with pytest.raises(ValueError):
        bigru2_forward(xg5, w5.transpose(2, 3).contiguous()[:, :2], b5, mask)
    with pytest.raises(ValueError):
        bigru2_forward(xg5.reshape(5, 2, 9, 8), w5, b5, mask)
    with pytest.raises(TypeError):
        h_prev = xg5[:, :, 0].contiguous()
        bigru2_backward(xg5, w5, b5, mask, h_prev, h_prev.bfloat16())


BWD_EDGE_CASES = [  # (T, B, H, D, lengths): the backward's plan at its edges
    pytest.param(3, 32, 1760, 2, None, id="H1760"),  # w_h rows partly read from L2
    pytest.param(5, 96, 100, 2, None, id="B96"),  # three row tiles
    pytest.param(6, 1, 100, 2, None, id="B1"),
    pytest.param(6, 9, 100, 2, [0] * 9, id="all-len0"),  # every frame masked
    pytest.param(4, 9, 48, 1, None, id="D1"),
    pytest.param(5, 32, 800, 2, None, id="B32-H800"),  # the flagship's width
    pytest.param(4, 128, 800, 2, None, id="B128-H800"),  # four row tiles
    pytest.param(5, 32, 800, 1, None, id="D1-H800"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd,lengths", BWD_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernels_at_plan_edges(t, b, h, nd, lengths, dtype, cuda):  # noqa: F811
    """K1b, K4b and K5b against their plain versions; K5b bit-equal to
    K1b; each bit-identical over two calls (a race at the grid barrier
    would show here)."""
    rng = np.random.RandomState(t * 1000 + b + h)
    xg, w_h, b_h, mask = [torch.from_numpy(a).to(cuda) for a in
                          gru_inputs(rng, t, b, h, nd, lengths=lengths)]
    xg, w_h = xg.to(dtype), w_h.to(dtype)
    h_prev = _shift(bigru_reference(xg, w_h, b_h, mask))
    dy = torch.from_numpy(rng.randn(t, nd, b, h).astype(np.float32)).to(cuda, dtype)
    packed = bigru_backward(xg, w_h, b_h, mask, h_prev, dy)
    torch.cuda.synchronize()
    want = bigru_backward_reference(xg, w_h, b_h, mask, h_prev, dy)
    _assert_close(packed, want, dtype, max(want.float().abs().max().item(), 1e-30))
    assert torch.equal(packed, bigru_backward(xg, w_h, b_h, mask, h_prev, dy))
    k5 = [torch.from_numpy(a).to(cuda) for a in
          gate_major(xg.float().cpu().numpy(), w_h.float().cpu().numpy(), b_h.cpu().numpy())]
    k5 = (k5[0].to(dtype), k5[1].to(dtype), k5[2], mask)
    dg = bigru2_backward(*k5, h_prev, dy)
    assert torch.equal(dg, packed.reshape(t, nd, b, 4, h).permute(0, 1, 3, 2, 4))
    assert torch.equal(dg, bigru2_backward(*k5, h_prev, dy))

    xg4, w4, b4, _ = [torch.from_numpy(a).to(cuda) for a in
                      gru_inputs(rng, t, b, h, nd, lengths=lengths, n_gates=4)]
    args = (xg4.to(dtype), w4.to(dtype), b4, mask)
    ys, cs = bilstm_reference(*args)
    bwd = (*args, _shift(ys), _shift(cs), cs, dy)
    dhg = bilstm_backward(*bwd)
    torch.cuda.synchronize()
    want = bilstm_backward_reference(*bwd)
    _assert_close(dhg, want, dtype, max(want.float().abs().max().item(), 1e-30))
    assert torch.equal(dhg, bilstm_backward(*bwd))
    if lengths is not None and not any(lengths):
        assert not packed.any() and not dhg.any()


@pytest.mark.cuda
def test_backward_refuses_a_grid_that_is_not_co_resident(cuda, monkeypatch):  # noqa: F811
    """A plan for more blocks than the card holds at once raises; it
    never hangs and never falls back."""
    import tpuasr_torch.ops.gru as gru_mod
    from tpuasr_torch.ops import rnn_plan

    real = rnn_plan.rnn_bwd_plan

    def too_many(nd, b, h, n_gates, itemsize, n_sms, smem):
        return real(nd, b, h, n_gates, itemsize, 4 * n_sms, smem)

    monkeypatch.setattr(gru_mod, "rnn_bwd_plan", too_many)
    args = _bwd_args(cuda, 3, 4, 1760, 2, torch.bfloat16)  # 220 slices: 220 blocks
    with pytest.raises(RuntimeError, match="loop"):
        bigru_backward(*args)


FWD_EDGE_CASES = [  # (T, B, H, D, lengths): the forward's plan at its edges
    pytest.param(3, 32, 1760, 2, None, id="H1760"),  # w_h columns partly read from L2
    pytest.param(5, 96, 100, 2, None, id="B96"),  # three row tiles
    pytest.param(6, 1, 100, 2, [6], id="B1"),
    pytest.param(6, 9, 100, 2, [0] * 9, id="all-len0"),  # every frame masked
    pytest.param(4, 9, 48, 1, None, id="D1"),
    pytest.param(3, 448, 800, 2, None, id="B448"),  # 14 row tiles a step
    pytest.param(5, 7, 20, 2, None, id="H20"),  # H % 8 != 0: element loads of h
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd,lengths", FWD_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_kernels_at_plan_edges(t, b, h, nd, lengths, dtype, cuda):  # noqa: F811
    """K1f, K5f and K4f against their plain versions at the edges of
    their launch plan, one launch each; K5f bit-equal to K1f; each
    bit-identical over two calls (a race at the grid barrier would show
    here). The LSTM runs B=320 where the GRU runs 448."""
    rng = np.random.RandomState(t * 1000 + b + h)
    xg, w_h, b_h, mask = [torch.from_numpy(a).to(cuda) for a in
                          gru_inputs(rng, t, b, h, nd, lengths=lengths)]
    xg, w_h = xg.to(dtype), w_h.to(dtype)
    before = (bigru_forward.launches, bigru2_forward.launches, bilstm_forward.launches)
    ys = bigru_forward(xg, w_h, b_h, mask)
    torch.cuda.synchronize()
    _assert_close(ys, bigru_reference(xg, w_h, b_h, mask), dtype)
    assert torch.equal(ys, bigru_forward(xg, w_h, b_h, mask))
    k5 = [torch.from_numpy(a).to(cuda) for a in
          gate_major(xg.float().cpu().numpy(), w_h.float().cpu().numpy(), b_h.cpu().numpy())]
    ys5 = bigru2_forward(k5[0].to(dtype), k5[1].to(dtype), k5[2], mask)
    assert torch.equal(ys5, ys)

    b4 = 320 if b == 448 else b
    xg4, w4, b4_h, mask4 = [torch.from_numpy(a).to(cuda) for a in
                            gru_inputs(rng, t, b4, h, nd, lengths=lengths, n_gates=4)]
    args = (xg4.to(dtype), w4.to(dtype), b4_h, mask4)
    ys4, cs4 = bilstm_forward(*args)
    torch.cuda.synchronize()
    ys_r, cs_r = bilstm_reference(*args)
    _assert_close(ys4, ys_r, dtype)
    _assert_close(cs4, cs_r, dtype)
    again = bilstm_forward(*args)
    assert torch.equal(ys4, again[0]) and torch.equal(cs4, again[1])
    assert (bigru_forward.launches, bigru2_forward.launches,
            bilstm_forward.launches) == (before[0] + 2, before[1] + 1, before[2] + 2)
    if lengths is not None and not any(lengths):
        assert not ys.any() and not ys4.any() and not cs4.any()


@pytest.mark.cuda
def test_forward_step_timer_splits_without_changing_the_result(cuda):  # noqa: F811
    """With ``fwd_parts`` set, each call hands back per-block clock64 sums
    of the step's parts (barrier, h load, product, gate math) and of the
    whole loop; the outputs are those of the untimed call."""
    import tpuasr_torch.ops.gru as gru_mod

    xg, w_h, b_h, mask = _args(cuda, 12, 32, 800, 2, torch.bfloat16)
    plain = bigru_forward(xg, w_h, b_h, mask)
    gru_mod.fwd_parts = []
    try:
        ys = bigru_forward(xg, w_h, b_h, mask)
        torch.cuda.synchronize()
        parts = gru_mod.fwd_parts
    finally:
        gru_mod.fwd_parts = None
    assert torch.equal(ys, plain)
    assert len(parts) == 1 and parts[0]["T"] == 12
    timer = parts[0]["timer"].cpu()
    assert timer.shape == (100, len(gru_mod.FWD_PARTS))
    assert (timer >= 0).all() and (timer[:, :4].sum(1) <= timer[:, 4]).all()
    assert (timer[:, 2] > 0).all() and (timer[:, 3] > 0).all()


@pytest.mark.cuda
def test_forward_refuses_a_grid_that_is_not_co_resident(cuda, monkeypatch):  # noqa: F811
    """A forward plan for more blocks than the card holds at once raises;
    it never hangs and never falls back."""
    import tpuasr_torch.ops.gru as gru_mod
    from tpuasr_torch.ops import rnn_plan

    real = rnn_plan.rnn_fwd_plan

    def too_many(nd, b, h, n_gates, itemsize, n_sms, smem):
        return real(nd, b, h, n_gates, itemsize, 4 * n_sms, smem)

    monkeypatch.setattr(gru_mod, "rnn_fwd_plan", too_many)
    xg, w_h, b_h, mask = _args(cuda, 3, 4, 1760, 2, torch.bfloat16)  # 220 slices: 220 blocks
    with pytest.raises(RuntimeError, match="bigru_fwd"):
        bigru_forward(xg, w_h, b_h, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_kernels_past_one_plan_run_in_row_groups(dtype, cuda,
                                                         monkeypatch):  # noqa: F811
    """With the forward plan's row limit set to 7, K1f, K5f and K4f (ys
    and cs) run B=20 in 3 row groups, one launch each; the result is the
    single launch's bit for bit and matches the plain loops."""
    import tpuasr_torch.ops.gru as gru_mod

    t, b, h = 5, 20, 100
    rng = np.random.RandomState(20)
    k1 = [torch.from_numpy(a).to(cuda) for a in gru_inputs(rng, t, b, h)]
    k1[0], k1[1] = k1[0].to(dtype), k1[1].to(dtype)
    k5 = [torch.from_numpy(a).to(cuda) for a in
          gate_major(k1[0].float().cpu().numpy(), k1[1].float().cpu().numpy(),
                     k1[2].cpu().numpy())]
    k5 = [k5[0].to(dtype), k5[1].to(dtype), k5[2], k1[3]]
    k4 = [torch.from_numpy(a).to(cuda) for a in gru_inputs(rng, t, b, h, n_gates=4)]
    k4[0], k4[1] = k4[0].to(dtype), k4[1].to(dtype)
    runs = ((bigru_forward, bigru_reference, k1), (bigru2_forward, bigru2_reference, k5),
            (bilstm_forward, bilstm_reference, k4))

    def outs(x):
        return x if isinstance(x, tuple) else (x,)

    whole = [outs(fn(*args)) for fn, _, args in runs]
    monkeypatch.setattr(gru_mod, "max_fwd_rows", lambda *a: 7)
    before = [fn.launches for fn, _, _ in runs]
    grouped = [outs(fn(*args)) for fn, _, args in runs]
    torch.cuda.synchronize()
    assert [fn.launches - n for (fn, _, _), n in zip(runs, before)] == [3, 3, 3]
    for (fn, plain, args), one, got in zip(runs, whole, grouped):
        assert all(torch.equal(a, g) for a, g in zip(one, got))
        for g, w in zip(got, outs(plain(*args))):
            _assert_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n_gates,b", [(3, 448), (4, 320)], ids=["gru-B448", "lstm-B320"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernels_past_one_plan_run_in_row_groups(n_gates, b, dtype,
                                                          cuda):  # noqa: F811
    """B=448 (BiGRU-800) and B=320 (BiLSTM-800) are past the rows one
    backward plan holds on an H100 (422 and 306); the wrappers run the
    rows in two groups, two launches each, and match the plain loops."""
    t, h, nd = 3, 800, 2
    rng = np.random.RandomState(b)
    xg, w_h, b_h, mask = [torch.from_numpy(a).to(cuda) for a in
                          gru_inputs(rng, t, b, h, nd, n_gates=n_gates)]
    args = (xg.to(dtype), w_h.to(dtype), b_h, mask)
    dy = torch.from_numpy(rng.randn(t, nd, b, h).astype(np.float32)).to(cuda, dtype)
    if n_gates == 3:
        fn, plain = bigru_backward, bigru_backward_reference
        bwd = (*args, _shift(bigru_reference(*args)), dy)
    else:
        fn, plain = bilstm_backward, bilstm_backward_reference
        ys, cs = bilstm_reference(*args)
        bwd = (*args, _shift(ys), _shift(cs), cs, dy)
    before = fn.launches
    got = fn(*bwd)
    torch.cuda.synchronize()
    assert fn.launches == before + 2 * BWD_LAUNCHES
    want = plain(*bwd)
    _assert_close(got, want, dtype, want.float().abs().max().item())


def _rnn_args(device, t, b, h, nd, dtype, seed=14, lengths=None):
    rng = np.random.RandomState(seed)
    xg, w_h, b_h, mask = [torch.from_numpy(a).to(device) for a in
                          gru_inputs(rng, t, b, h, nd, lengths=lengths, n_gates=1)]
    return xg.to(dtype), w_h.to(dtype), b_h, mask


RNN_CASES = [pytest.param(*p.values, None, id=p.id) for p in CASES] + [
    # (T, B, H, D, lengths): K6's plan at its edges and the cell's width
    pytest.param(4, 32, 1280, 2, None, id="B32-H1280"),  # 160 slices, two a block
    pytest.param(4, 32, 1280, 1, None, id="D1-H1280"),
    pytest.param(3, 32, 1760, 2, None, id="H1760"),
    pytest.param(5, 96, 100, 2, None, id="B96"),  # three row tiles
    pytest.param(6, 1, 100, 2, [6], id="B1"),
    pytest.param(6, 9, 100, 2, [0] * 9, id="all-len0"),  # every frame masked
    pytest.param(5, 7, 20, 2, None, id="H20"),  # H % 8 != 0: element loads of h
    pytest.param(3, 448, 800, 2, None, id="B448"),  # 14 row tiles a step
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h,nd,lengths", RNN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rnn_kernels_match_reference(t, b, h, nd, lengths, dtype, cuda):  # noqa: F811
    """K6f and K6b against their plain versions, one launch each a call,
    each bit-identical over two calls (a race at the grid barrier would
    show here)."""
    args = _rnn_args(cuda, t, b, h, nd, dtype, seed=t * 1000 + b + h, lengths=lengths)
    before = (birnn_forward.launches, birnn_backward.launches)
    ys = birnn_forward(*args)
    torch.cuda.synchronize()
    assert ys.shape == (t, nd, b, h) and ys.dtype == dtype
    ys_r = birnn_reference(*args)
    _assert_close(ys, ys_r, dtype)
    assert torch.equal(ys, birnn_forward(*args))
    dy = torch.from_numpy(np.random.RandomState(t).randn(t, nd, b, h).astype(np.float32))
    bwd = (args[1], args[3], ys_r, dy.to(cuda, dtype))
    dpre = birnn_backward(*bwd)
    torch.cuda.synchronize()
    assert dpre.shape == (t, nd, b, h) and dpre.dtype == dtype
    want = birnn_backward_reference(*bwd)
    _assert_close(dpre, want, dtype, max(want.float().abs().max().item(), 1e-30))
    assert torch.equal(dpre, birnn_backward(*bwd))
    assert (birnn_forward.launches, birnn_backward.launches) == (
        before[0] + 2, before[1] + 2 * birnn_mod.BWD_LAUNCHES)
    if lengths is not None and not any(lengths):
        assert not ys.any() and not dpre.any()


@pytest.mark.cuda
def test_rnn_function_gradients_match_plain_autograd(cuda):  # noqa: F811
    """BiRNNFunction (K6f, K6b, the dw/db einsums) against autograd
    through the plain forward, f32."""
    xg, w_h, b_h, mask = _rnn_args(cuda, 9, 5, 32, 2, torch.float32)
    dy = torch.from_numpy(np.random.RandomState(4).randn(9, 2, 5, 32).astype(np.float32))
    grads = []
    for f in (BiRNNFunction.apply, birnn_reference):
        leaves = [a.clone().requires_grad_() for a in (xg, w_h, b_h)]
        (f(*leaves, mask) * dy.to(cuda)).sum().backward()
        grads.append([a.grad for a in leaves])
    for g_k, g_r in zip(*grads):
        assert (g_k - g_r).abs().max().item() <= 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rnn_kernels_past_one_plan_run_in_row_groups(dtype, cuda, monkeypatch):  # noqa: F811
    """With both plans' row limits set to 7, K6f and K6b run B=20 in 3
    row groups, one launch each; the results are the single launches'
    bit for bit."""
    import tpuasr_torch.ops.gru as gru_mod

    args = _rnn_args(cuda, 5, 20, 100, 2, dtype, seed=21)
    ys = birnn_forward(*args)
    dy = torch.randn(ys.shape, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda).to(dtype)
    dpre = birnn_backward(args[1], args[3], ys, dy)
    monkeypatch.setattr(gru_mod, "max_fwd_rows", lambda *a: 7)
    monkeypatch.setattr(gru_mod, "max_bwd_rows", lambda *a: 7)
    before = (birnn_forward.launches, birnn_backward.launches)
    ys_g = birnn_forward(*args)
    dpre_g = birnn_backward(args[1], args[3], ys, dy)
    torch.cuda.synchronize()
    assert (birnn_forward.launches - before[0], birnn_backward.launches - before[1]) == (3, 3)
    assert torch.equal(ys_g, ys) and torch.equal(dpre_g, dpre)


@pytest.mark.cuda
def test_rnn_kernels_reject_what_they_do_not_take(cuda):  # noqa: F811
    xg, w_h, b_h, mask = _rnn_args(cuda, 5, 3, 8, 2, torch.bfloat16)
    with pytest.raises(TypeError):
        birnn_forward(xg, w_h.float(), b_h, mask)
    with pytest.raises(ValueError):
        birnn_forward(torch.cat([xg, xg], -1).contiguous(), w_h, b_h, mask)  # 2H columns
    ys = birnn_forward(xg, w_h, b_h, mask)
    with pytest.raises(TypeError):
        birnn_backward(w_h, mask, ys, ys.float())
    with pytest.raises(ValueError, match="contiguous"):
        birnn_backward(w_h, mask, ys, ys.transpose(0, 1).contiguous().transpose(0, 1))


def _ctc_case(device, t, b, s, seed=7, holes=False):
    """Log-emissions with ragged frame counts (row 1 padded to 0 frames,
    its labels at full width) and ragged label lengths (one empty, one
    longer than its frames); with ``holes`` the frame mask of row 0 is
    not a prefix (every third frame off)."""
    rng = np.random.RandomState(seed)
    emit = np.log(rng.dirichlet(np.ones(8), size=(t, b, s)).max(-1)).astype(np.float32)
    frames = rng.randint(1, t + 1, size=b)
    n_lab = rng.randint(0, (s - 1) // 2 + 1, size=b)
    frames[0], n_lab[0] = t, (s - 1) // 2
    if b > 1:
        frames[1], n_lab[1] = 0, (s - 1) // 2
    if b > 2:
        n_lab[2] = 0
    if b > 3:
        n_lab[3] = min((s - 1) // 2, t + 5)
        frames[3] = max(1, n_lab[3] - 3)  # infeasible: more labels than frames
    s_idx = np.arange(s)[None, :]
    valid_s = (s_idx < 2 * n_lab[:, None] + 1).astype(np.float32)
    skip = ((s_idx % 2 == 1) & (s_idx >= 2) & (rng.rand(b, s) < 0.7)).astype(np.float32)
    fv = (np.arange(t)[:, None] < frames[None, :]).astype(np.float32)
    if holes:
        fv[1::3, 0] = 0.0
    init = np.full((b, s), LOG_EPS, np.float32)
    init[:, 0] = 0.0
    init[:, 1] = np.where(n_lab > 0, 0.0, LOG_EPS)
    end = 2 * n_lab
    end_mask = ((s_idx == end[:, None])
                | ((s_idx == np.maximum(end - 1, 0)[:, None]) & (n_lab > 0)[:, None]))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32)
            for a in (emit, init, skip, valid_s, fv, end_mask)]


def _ctc_run(case, **plan):
    """K2a and K2b on ``case`` and their plain versions (K2b on the plain
    alphas, an uneven cotangent with a zero): (alphas, want, demit,
    want_d)."""
    emit, init, skip, valid_s, fv, end_mask = case
    alpha0 = torch.clamp(init + emit[0], min=LOG_EPS)
    alphas = ctc_alpha(emit, skip, valid_s, fv, alpha0, **plan)
    want = ctc_alpha_reference(emit, skip, valid_s, fv, alpha0)
    logp = torch.logsumexp(torch.where(end_mask > 0.5, want[-1], LOG_EPS), dim=1)
    dloss = torch.linspace(0.5, 2.0, emit.shape[1], device=emit.device)
    dloss[-1] = 0.0
    b_args = (emit, skip, fv, end_mask, want, logp, dloss)
    demit = ctc_beta(*b_args, **plan)
    want_d = ctc_beta_reference(*b_args)
    torch.cuda.synchronize()
    return alphas, want, demit, want_d


def _assert_ctc_close(alphas, want, demit, want_d):
    live = want > LOG_EPS / 2
    assert torch.equal(alphas > LOG_EPS / 2, live)
    rel = ((alphas - want).abs() / want.abs().clamp(min=1.0))[live]
    assert rel.numel() == 0 or rel.max().item() <= 1e-5
    assert (demit - want_d).abs().max().item() <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,s,holes", [(11, 5, 9, False), (40, 6, 61, False),
                                         (251, 32, 261, False), (3, 4, 1201, False),
                                         (826, 8, 837, False), (5, 2, 5001, False),
                                         (1, 4, 261, False), (30, 4, 1025, False),
                                         (40, 6, 61, True)],
                         ids=["tiny", "small", "train-5s", "S1201", "train-16s", "S5001",
                              "T1", "S1025", "holes"])
def test_ctc_kernels_match_reference(t, b, s, holes, cuda):  # noqa: F811
    case = _ctc_case(cuda, t, b, s, holes=holes)
    before = ctc_alpha.launches, ctc_beta.launches
    got = _ctc_run(case)
    assert (ctc_alpha.launches, ctc_beta.launches) == (before[0] + 1, before[1] + 1)
    _assert_ctc_close(*got)
    if b > 1:  # the row of 0 frames, at full width: no gradient
        assert bool((got[2][:, 1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [2, 3, 4, 8, 16, 32])
def test_ctc_kernels_every_launch_plan(slots, cuda):  # noqa: F811
    """Every instantiated slot count a thread (each with its prefetch
    depth), with the plain versions' results, at a width that leaves
    ragged tails."""
    _assert_ctc_close(*_ctc_run(_ctc_case(cuda, 23, 5, 301, holes=True), _slots=slots))


@pytest.mark.cuda
def test_ctc_kernels_are_deterministic(cuda):  # noqa: F811
    first = _ctc_run(_ctc_case(cuda, 251, 32, 261, holes=True))
    second = _ctc_run(_ctc_case(cuda, 251, 32, 261, holes=True))
    assert torch.equal(first[0], second[0]) and torch.equal(first[2], second[2])


@pytest.mark.cuda
def test_ctc_function_gradient_matches_plain(cuda):  # noqa: F811
    emit, init, skip, valid_s, fv, end_mask = _ctc_case(cuda, 30, 6, 21, holes=True)
    e_k = emit.clone().requires_grad_()
    before = ctc_beta.launches
    loss_k = CTCFromEmit.apply(e_k, init, skip, valid_s, fv, end_mask)
    w = torch.linspace(0.5, 2.0, loss_k.shape[0], device=cuda)
    w[3] = 0.0
    (loss_k * w).sum().backward()
    assert ctc_beta.launches == before + 1
    import tpuasr_torch.ops.ctc as ctc_mod
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ctc_mod, "ctc_alpha", ctc_alpha_reference)
        mp.setattr(ctc_mod, "ctc_beta", ctc_beta_reference)
        e_r = emit.clone().requires_grad_()
        loss_r = CTCFromEmit.apply(e_r, init, skip, valid_s, fv, end_mask)
        (loss_r * w).sum().backward()
    assert ((loss_k - loss_r).abs() / loss_r.abs().clamp(min=1.0)).max().item() <= 1e-5
    assert (e_k.grad - e_r.grad).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_new_kernels_reject_what_they_do_not_take(cuda):  # noqa: F811
    xg, w_h, b_h, mask, h_prev, dy = _bwd_args(cuda, 5, 3, 8, 2, torch.bfloat16)
    with pytest.raises(TypeError):
        bigru_backward(xg, w_h, b_h, mask, h_prev, dy.float())
    with pytest.raises(ValueError):
        bigru_backward(xg, w_h, b_h, mask, h_prev[:4], dy)
    emit, init, skip, valid_s, fv, end_mask = _ctc_case(cuda, 6, 4, 9)
    with pytest.raises(TypeError):
        ctc_alpha(emit.double(), skip, valid_s, fv, init)
    with pytest.raises(ValueError, match="contiguous"):
        ctc_alpha(emit.transpose(0, 1).contiguous().transpose(0, 1), skip, valid_s, fv, init)
    logp, dloss = init[:, 0].contiguous(), torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        ctc_beta(emit, skip, fv, end_mask, emit, logp.cpu(), dloss)
    with pytest.raises(ValueError):
        ctc_beta(emit, skip, fv, end_mask, emit, logp, dloss[:3])
    # past the shared-memory rows (~29,000 slots on an H100): refused with
    # its reason, before any launch
    big = 2 * 16384 + 1
    z = torch.zeros((2, 1, big), device=cuda)
    m = torch.zeros((1, big), device=cuda)
    f = torch.ones((2, 1), device=cuda)
    before = ctc_alpha.launches, ctc_beta.launches
    with pytest.raises(ValueError, match="shared memory"):
        ctc_alpha(z, m, m, f, m)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_beta(z, m, f, m, z, torch.zeros(1, device=cuda), torch.ones(1, device=cuda))
    assert (ctc_alpha.launches, ctc_beta.launches) == before


def _beam_lines(mode, alphabet):
    """Seeded LM training lines over the alphabet's letters: words of 1-3
    letters, 5 to a line; a char LM's letter by letter."""
    rng = np.random.RandomState(5)
    letters = list(alphabet.labels[1:-1])
    words = ["".join(rng.choice(letters, size=rng.randint(1, 4))) for _ in range(30)]
    lines = [" ".join(rng.choice(words, size=5)) for _ in range(40)]
    if mode == "char":
        lines = [" ".join("<sp>" if ch == " " else ch for ch in ln) for ln in lines]
    return lines


def _beam_lm(mode, alphabet, device, order=3):
    """K3's LM kwargs for a mode, from a seeded n-gram (a trigram unless
    ``order`` says otherwise) over the alphabet's letters."""
    if mode == "none":
        return {}
    lines = _beam_lines(mode, alphabet)
    if mode == "char":
        tables, key = pack_lm_tables(train_ngram(lines, order=order), alphabet), "char_tables"
    else:
        tables, key = (pack_word_lm_tables(train_ngram(lines, order=order), alphabet),
                       "word_tables")
    return {key: flat_tables(tables, device), "alpha": 0.8, "beta": 0.6,
            "space_id": alphabet.space_id}


def _beam_alphabet(c):
    """An alphabet of c classes: blank, c - 2 letters, space."""
    if c == 5:
        return Alphabet(labels="_AB C")
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789ÀÁÂÃÇÉÊÍ"
    if c - 2 > len(letters):
        letters = "".join(chr(0x100 + i) for i in range(c - 2))
    return Alphabet(labels="_" + letters[:c - 2] + " ")


def _beam_inputs(device, b, t, c, seed=0):
    """Seeded log-probs (B, T, C) and ragged lengths, one row of 0."""
    rng = np.random.RandomState(seed)
    lp = torch.log_softmax(torch.from_numpy((rng.randn(b, t, c) * 2.5).astype(np.float32)), -1)
    lengths = rng.randint(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    if b > 2:
        lengths[2] = 0
    return lp.to(device).contiguous(), torch.from_numpy(lengths).to(device)


def _assert_beam_equal(got, want):
    parents, chars, scores = got[:3]
    assert parents.dtype == want[0].dtype and torch.equal(parents, want[0])
    assert torch.equal(chars, want[1])
    tol = 1e-5 * want[2].abs().clamp(min=1.0)
    assert bool(((scores - want[2]).abs() <= tol).all()), (scores, want[2])


BEAM_SHAPES = [  # (B, T, C, W)
    pytest.param(4, 30, 5, 5, id="small"),
    pytest.param(1, 1, 5, 1, id="B1-T1-W1"),
    pytest.param(3, 17, 37, 8, id="C37"),
    pytest.param(32, 60, 44, 10, id="flagship-width"),
    pytest.param(8, 40, 44, 100, id="W100"),  # int8 backpointers, 4,500-candidate pool
    pytest.param(3, 12, 44, 200, id="W200"),  # int32 backpointers
    pytest.param(3, 8, 130, 300, id="W300-C130"),  # past the old limits; the pool in L2
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "char", "word"])
@pytest.mark.parametrize("b,t,c,w", BEAM_SHAPES)
def test_beam_kernel_matches_reference(mode, b, t, c, w, cuda):  # noqa: F811
    alphabet = _beam_alphabet(c)
    lp, lengths = _beam_inputs(cuda, b, t, c, seed=b + t)
    kw = dict(beam_width=w, blank_id=0, cutoff_top_n=40, **_beam_lm(mode, alphabet, cuda))
    before = beam_scan.launches
    got = beam_scan(lp, lengths, **kw)
    torch.cuda.synchronize()
    assert beam_scan.launches == before + 1
    _assert_beam_equal(got, beam_scan_reference(lp, lengths, **kw))
    if b > 2:
        assert bool((got[1][2] == -1).all())  # the length-0 row


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "char", "word"])
def test_beam_kernel_stateful_chunks(mode, cuda):  # noqa: F811
    b, t, c, w = 4, 32, 5, 5
    alphabet = Alphabet(labels="_AB C")
    lp, lengths = _beam_inputs(cuda, b, t, c, seed=9)
    kw = dict(beam_width=w, blank_id=0, **_beam_lm(mode, alphabet, cuda))
    full = beam_scan(lp, lengths, return_state=True, **kw)
    ring = 0 if mode == "none" else 2  # trigrams: a 2-token ring or 2-char context
    state = make_beam_state(b, w, lm_mode=mode, ring_len=ring, device=cuda)
    state_ref = state
    ps, cs = [], []
    for t0 in range(0, t, 8):  # 4 chunks
        n = torch.clamp(lengths - t0, 0, 8).to(torch.int32)
        chunk = lp[:, t0:t0 + 8].contiguous()
        p, ch, scores, state = beam_scan(chunk, n, state=state, return_state=True, **kw)
        ref = beam_scan_reference(chunk, n, state=state_ref, return_state=True, **kw)
        state_ref = ref[3]
        _assert_beam_equal((p, ch, scores), ref)
        for a, e in zip(state, state_ref):
            assert a.dtype == e.dtype and torch.equal(a, e)
        ps.append(p)
        cs.append(ch)
    torch.cuda.synchronize()
    _assert_beam_equal((torch.cat(ps, 1), torch.cat(cs, 1), scores), full)
    for a, e in zip(state, full[3]):
        assert torch.equal(a, e)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [10, 100])
def test_beam_kernel_fuses_a_seven_gram_char_lm(w, cuda):  # noqa: F811
    """A char 7-gram's context rides in K3 as 6 class ids a beam; against
    the plain version, stateless and in 3 chunks."""
    alphabet = Alphabet(labels=("_" + "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789ÀÁÂÃÇÉÊÍ")[:43] + " ")
    lp, lengths = _beam_inputs(cuda, 6, 36, 44, seed=w)
    kw = dict(beam_width=w, blank_id=0, **_beam_lm("char", alphabet, cuda, order=7))
    before = beam_scan.launches
    got = beam_scan(lp, lengths, return_state=True, **kw)
    torch.cuda.synchronize()
    assert beam_scan.launches == before + 1
    want = beam_scan_reference(lp, lengths, return_state=True, **kw)
    _assert_beam_equal(got[:3], want[:3])
    assert all(torch.equal(a, e) for a, e in zip(got[3], want[3]))
    state = make_beam_state(6, w, lm_mode="char", ring_len=6, device=cuda)
    ps = []
    for t0 in range(0, 36, 12):
        n = torch.clamp(lengths - t0, 0, 12).to(torch.int32)
        p, _, scores, state = beam_scan(lp[:, t0:t0 + 12].contiguous(), n, state=state,
                                        return_state=True, **kw)
        ps.append(p)
    assert torch.equal(torch.cat(ps, 1), got[0]) and torch.equal(scores, got[2])


@pytest.mark.cuda
def test_beam_decoder_raises_past_k3(cuda):  # noqa: F811
    """What K3 once refused (the name is from then) it now decodes: the
    decoder on the card at W=254 over 126 classes, whose pool does not
    fit shared memory, and with a char 12-gram over 70 classes, one K3
    launch each, equal to the plain version."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.ops.beam import _k3_plan

    assert _k3_plan(254, 126, 0, 0, 0, "none", 0, cuda)[0] == 1  # the pool in the workspace
    alphabet = _beam_alphabet(70)
    twelve = train_ngram(_beam_lines("char", alphabet), order=12)
    cases = [(DeviceBeamDecoder(_beam_alphabet(126), beam_width=254), 126),
             (DeviceBeamDecoder(alphabet, beam_width=10, char_lm=twelve, alpha=0.8, beta=0.6), 70)]
    for dec, c in cases:
        lp, lengths = _beam_inputs(cuda, 3, 9, c, seed=c)
        before = beam_scan.launches
        got = dec.search(lp, lengths)
        torch.cuda.synchronize()
        assert beam_scan.launches == before + 1
        kw = dict(beam_width=dec.cfg.beam_width, blank_id=0, cutoff_top_n=40,
                  **dec.kernel_lm_kwargs(c, cuda))
        _assert_beam_equal(got, beam_scan_reference(lp, lengths, **kw))
        assert dec.decode(lp, lengths) == dec.decode(lp.cpu(), lengths.cpu())


@pytest.mark.cuda
def test_beam_kernel_fuses_a_word_nine_gram(cuda):  # noqa: F811
    """A word 9-gram (an 8-token ring) in K3 against the plain version,
    stateless and in 2 stateful chunks."""
    alphabet = _beam_alphabet(5)
    kw = dict(beam_width=8, blank_id=0, **_beam_lm("word", alphabet, cuda, order=9))
    lp, lengths = _beam_inputs(cuda, 4, 24, 5, seed=9)
    got = beam_scan(lp, lengths, return_state=True, **kw)
    want = beam_scan_reference(lp, lengths, return_state=True, **kw)
    _assert_beam_equal(got[:3], want[:3])
    assert all(torch.equal(a, e) for a, e in zip(got[3], want[3]))
    state = make_beam_state(4, 8, lm_mode="word", ring_len=8, device=cuda)
    ps = []
    for t0 in range(0, 24, 12):
        n = torch.clamp(lengths - t0, 0, 12).to(torch.int32)
        p, _, scores, state = beam_scan(lp[:, t0:t0 + 12].contiguous(), n, state=state,
                                        return_state=True, **kw)
        ps.append(p)
    assert torch.equal(torch.cat(ps, 1), got[0]) and torch.equal(scores, got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "char", "word"])
def test_beam_kernel_pool_placements_are_bit_equal(mode, cuda):  # noqa: F811
    """A shape whose arrays fit shared memory, run with the W x C pool
    forced into the global workspace and with the beam state there too:
    all three placements give the same bits, state included."""
    from tpuasr_torch.ops.beam import _k3_plan

    alphabet = _beam_alphabet(44)
    lp, lengths = _beam_inputs(cuda, 5, 30, 44, seed=4)
    kw = dict(beam_width=12, blank_id=0, return_state=True, **_beam_lm(mode, alphabet, cuda))
    assert _k3_plan(12, 44, 0, 0, 0, "none", 0, cuda)[0] == 0  # fits shared memory
    outs = [beam_scan(lp, lengths, **kw, _min_place=place) for place in (0, 1, 2)]
    torch.cuda.synchronize()
    for got in outs[1:]:
        assert all(torch.equal(a, e) for a, e in zip(got[:3], outs[0][:3]))
        assert all(torch.equal(a, e) for a, e in zip(got[3], outs[0][3]))
    _assert_beam_equal(outs[0], beam_scan_reference(lp, lengths, **kw))


@pytest.mark.cuda
def test_beam_frame_timer_splits_without_changing_the_result(cuda):  # noqa: F811
    """With ``k3_parts`` set, a launch hands back each block's clock64
    sums a phase, its barriers and its frames; the outputs are the same
    bits as without the timer."""
    import tpuasr_torch.ops.beam as beam_mod

    lp, lengths = _beam_inputs(cuda, 4, 20, 44, seed=2)
    kw = dict(beam_width=10, blank_id=0, **_beam_lm("word", _beam_alphabet(44), cuda))
    plain = beam_scan(lp, lengths, **kw)
    beam_mod.k3_parts = []
    try:
        timed = beam_scan(lp, lengths, **kw)
        torch.cuda.synchronize()
        parts = beam_mod.k3_parts
    finally:
        beam_mod.k3_parts = None
    assert all(torch.equal(a, e) for a, e in zip(timed, plain))
    timer = parts[0]["timer"].cpu()
    names = beam_mod.K3_PARTS
    assert timer.shape == (4, len(names))
    assert timer[:, names.index("frames")].tolist() == lengths.cpu().tolist()
    live = lengths.cpu() > 0
    assert bool((timer[live, names.index("loop")] > 0).all())
    assert bool((timer[live, names.index("barriers")] >= 5 * lengths.cpu()[live]).all())
    assert bool((timer[:, :names.index("loop")].sum(1) <= timer[:, names.index("loop")]).all())


@pytest.mark.cuda
def test_beam_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    lp, lengths = _beam_inputs(cuda, 3, 6, 5)
    kw = dict(beam_width=4, blank_id=0)
    with pytest.raises(ValueError, match="contiguous"):
        beam_scan(lp.transpose(0, 1).contiguous().transpose(0, 1), lengths, **kw)
    with pytest.raises(ValueError, match="int32"):
        beam_scan(lp, lengths.long(), **kw)
    with pytest.raises(ValueError, match="blank_id"):
        beam_scan(lp, lengths, beam_width=255, blank_id=5)
    with pytest.raises(ValueError, match="fields"):
        beam_scan(lp, lengths, **kw, state=make_beam_state(3, 4, device=cuda)[:4])
    word = _beam_lm("word", Alphabet(labels="_AB C"), "cpu")
    with pytest.raises(ValueError, match="LM tables"):
        beam_scan(lp, lengths, **kw, **word)


@pytest.mark.cuda
def test_augment_applies_on_the_card_match_the_cpu(cuda):  # noqa: F811
    """Each augmentation apply on the card against the CPU with the same
    parameters, drawn on the card: atol 1e-5 (the same f32 operations),
    lengths equal."""
    from tpuasr_torch.audio import augment as aug

    cfg = aug.AugmentConfig(noise_prob=0.5, n_freq_masks=2, n_time_masks=2)
    rng = np.random.RandomState(0)
    lengths = torch.tensor([16000, 12345, 800, 1], device=cuda)
    waves = torch.from_numpy((0.3 * rng.randn(4, 16000)).astype(np.float32)).to(cuda)
    waves = waves * (torch.arange(16000, device=cuda)[None] < lengths[:, None])
    bank = torch.from_numpy((0.2 * rng.randn(7001)).astype(np.float32)).to(cuda)
    feats = torch.randn(4, 101, 161, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    rates, gains = aug.draw_tempo_gain(gen, 4, cfg)
    noise = aug.draw_noise(gen, 4, bank.shape[0], cfg)
    freq, tmask = aug.draw_spec_augment(gen, torch.tensor([101, 80, 5, 1], device=cuda), 101,
                                        161, cfg)
    for mode in ("wsola", "resample"):
        got = aug.tempo_and_gain(rates, gains, waves, lengths, aug.AugmentConfig(tempo_mode=mode))
        want = aug.tempo_and_gain(rates.cpu(), gains.cpu(), waves.cpu(), lengths.cpu(),
                                  aug.AugmentConfig(tempo_mode=mode))
        assert (got[0].cpu() - want[0]).abs().max() <= 1e-5
        assert torch.equal(got[1].cpu(), want[1])
    got = aug.inject_noise(*noise, waves, lengths, bank)
    want = aug.inject_noise(*(t.cpu() for t in noise), waves.cpu(), lengths.cpu(), bank.cpu())
    assert (got.cpu() - want).abs().max() <= 1e-5
    got = aug.spec_augment(freq, tmask, feats)
    want = aug.spec_augment([[t.cpu() for t in m] for m in freq],
                            [[t.cpu() for t in m] for m in tmask], feats.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_resident_chunk_runs_without_a_sync_and_equals_the_per_batch_steps(cuda):  # noqa: F811
    """A tiny model's augmented resident chunk (two steps) under
    sync-debug "error" equals the same two per-batch steps bit for bit."""
    from types import SimpleNamespace

    from tpuasr_torch.audio.augment import AugmentConfig, make_augment_fn
    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.compat.weights import init_train_variables, model_from_variables
    from tpuasr_torch.model.ds2 import ModelConfig
    from tpuasr_torch.train.loop import read_back
    from tpuasr_torch.train.step import (
        TrainConfig,
        make_resident_epoch_runner,
        make_train_step,
        step_generator,
    )

    cfg = ModelConfig(hidden_size=32, hidden_layers=1, rnn_impl="pallas")
    variables = init_train_variables(cfg, seed=1)
    rng = np.random.RandomState(2)
    bank = SimpleNamespace(
        waves=torch.from_numpy((rng.randn(6, 16000) * 3000).astype(np.int16)).to(cuda),
        wave_lengths=torch.tensor([16000, 15000, 9000, 16000, 12000, 8000],
                                  dtype=torch.int32, device=cuda),
        labels=torch.from_numpy(rng.randint(1, 30, (6, 30)).astype(np.int32)).to(cuda),
        label_lengths=torch.tensor([20, 18, 9, 25, 12, 7], dtype=torch.int32, device=cuda))
    idx = np.array([[0, 2, 4], [5, 1, 1]], np.int32)
    valid = np.array([[True, True, True], [True, True, False]])
    fn = make_augment_fn(AugmentConfig(spec_augment=True))
    steps = []
    for resident in (True, False):
        model = model_from_variables(variables, cfg, cuda, trainable=True)
        step = make_train_step(model, FrontendConfig(), TrainConfig(), fn)
        if resident:
            runner = make_resident_epoch_runner(step, seed=9)
            read_back(runner(bank, idx, valid, 3e-4, 0))  # warm
            model = model_from_variables(variables, cfg, cuda, trainable=True)
            runner = make_resident_epoch_runner(
                make_train_step(model, FrontendConfig(), TrainConfig(), fn), seed=9)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                metrics = runner(bank, idx, valid, 3e-4, 0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            steps.append(read_back(metrics)["loss"].tolist())
        else:
            losses = []
            for k in range(2):
                rows = torch.from_numpy(idx[k]).long().to(cuda)
                m = step(bank.waves[rows], bank.wave_lengths[rows], bank.labels[rows],
                         bank.label_lengths[rows], torch.from_numpy(valid[k]).to(cuda), 3e-4,
                         step_generator(cuda, 9, k))
                losses.append(float(m["loss"]))
            steps.append(losses)
    assert steps[0] == steps[1] and all(np.isfinite(steps[0]))


def _uni_variables(seed=3):
    from tpuasr_torch.compat.weights import init_variables
    from tpuasr_torch.model.ds2 import ModelConfig

    cfg = ModelConfig(n_classes=4, hidden_size=32, hidden_layers=2, bidirectional=False,
                      lookahead_context=4, compute_dtype="float32")
    return cfg, init_variables(cfg, seed=seed)


@pytest.mark.cuda
def test_streaming_on_the_card_matches_the_cpu(cuda):  # noqa: F811
    """The streaming step on the card (f32 products, TF32 off) gives the
    CPU's logits within the f32 kernel tolerance, and the same text."""
    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.stream import StreamingTranscriber

    cfg, variables = _uni_variables()
    wave = (np.random.RandomState(7).randn(21000) * 0.1).astype(np.float32)
    runs = []
    for device in ("cuda", "cpu"):
        st = StreamingTranscriber(variables, cfg, FrontendConfig(normalize=False),
                                  Alphabet(labels="_ AB"), chunk_frames=16,
                                  collect_logits=True, device=device)
        for i in range(0, len(wave), 777):
            st.feed(wave[i:i + 777])
        st.flush()
        runs.append((st.logits(), st.text))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4, atol=1e-4)
    assert runs[0][1] == runs[1][1]


@pytest.mark.cuda
def test_device_beam_streams_on_the_card_match_the_cpu(cuda):  # noqa: F811
    """DeviceBeamStreams (K3 stateful, two slots, ragged windows, a word
    LM) commits the same ids and frames on the card as K3's plain version
    on the CPU, and K3 launches once a tick."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.device_stream import DeviceBeamStreams

    alphabet = Alphabet(labels="_ AB")
    dec = DeviceBeamDecoder(alphabet, beam_width=6, alpha=0.5, beta=0.3,
                            word_lm=train_ngram(["AB A B", "B AB", "A AB B"], order=2))
    rng = np.random.RandomState(5)
    ticks = [(rng.randn(2, 8, 4).astype(np.float32) * 3, rng.randint(0, 3, 2),
              rng.randint(3, 6, 2)) for _ in range(6)]
    out = []
    for device in (cuda, torch.device("cpu")):
        eng = DeviceBeamStreams(dec, 2, alphabet.size, 8, device=device)
        eng.reset_slot(1)
        before = beam_scan.launches
        for logits, lo, lens in ticks:
            eng.advance(torch.from_numpy(logits).to(device), lo, lens)
        out.append(([eng.committed(i) for i in range(2)], [eng.finalize(i)[:2] for i in range(2)],
                     beam_scan.launches - before))
    assert out[0][:2] == out[1][:2]
    assert out[0][2] == len(ticks) and out[1][2] == 0


@pytest.mark.cuda
def test_host_decoders_read_logits_on_the_card(cuda):  # noqa: F811
    """The C++ host beam and the Python host beam take logits (and
    lengths) that K1f's eval forward left on the card, and give the texts,
    offsets and n-best rows they give for the same logits moved to the
    CPU first."""
    from tpuasr_torch.compat.weights import init_variables, model_from_variables
    from tpuasr_torch.decode.beam_host import BeamCTCDecoder
    from tpuasr_torch.decode.native import NativeBeamDecoder
    from tpuasr_torch.model.ds2 import ModelConfig

    alphabet = Alphabet()
    cfg = ModelConfig(n_classes=alphabet.size, hidden_size=64, hidden_layers=2,
                      compute_dtype="float32")
    model = model_from_variables(init_variables(cfg, seed=3), cfg, cuda)
    feats = torch.from_numpy(np.random.RandomState(4).randn(3, 120, 161).astype(np.float32))
    lengths = torch.tensor([120, 87, 40], dtype=torch.int32)
    before = bigru_forward.launches
    with torch.inference_mode():
        logits, out_len = model(feats.to(cuda), lengths.to(cuda))
    assert bigru_forward.launches > before and logits.is_cuda and out_len.is_cuda
    for dec in (NativeBeamDecoder(alphabet, beam_width=8, num_processes=2),
                BeamCTCDecoder(alphabet, beam_width=8)):
        on_card = dec.decode(logits, out_len, return_offsets=True)
        on_host = dec.decode(logits.cpu(), out_len.cpu(), return_offsets=True)
        assert on_card[0] == on_host[0]
        for a, b in zip(on_card[1], on_host[1]):
            np.testing.assert_array_equal(a, b)
        nb_card = dec.decode_nbest(logits, out_len, n_best=3)
        nb_host = dec.decode_nbest(logits.cpu().numpy(), out_len.cpu().numpy(), n_best=3)
        assert [[(t, s) for t, s, _ in rows] for rows in nb_card] == \
            [[(t, s) for t, s, _ in rows] for rows in nb_host]
