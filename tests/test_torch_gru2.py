"""tpuasr_torch.ops.gru2 vs tpuasr.ops.gru2: the plain PyTorch
gate-major BiGRU loops (forward, and backward through BiGRU2Function,
whose wrappers run them on the CPU) against the JAX Pallas kernels in
interpreter mode and the JAX scan oracle of the same math
(tpuasr.ops.gru.bigru_reference on the relaid-out arrays); and the
port's K5 plain path against its K1 plain path on the same weights.
The Hopper kernels are held to the plain loops on a GPU in
test_torch_kernels.py.

Tolerances are K1's (test_torch_gru.py, test_torch_train_kernels.py):
ys 2e-5 and dxg, dw, db 3e-4 in f32; in bf16 ys within 3e-2 max-abs and
1e-3 mean-abs, gradients within 2e-2 of the largest and 1e-3 of it on
average (the carried h and the emitted gradients are rounded to bf16 in
both packages, and an ulp moved by another summation order is carried
on). K5 plain vs K1 plain: the same f32 products, grouped per gate
instead of in one (B, H) @ (H, 3H) product, so 1e-6 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuasr.ops.gru as jax_gru
import tpuasr.ops.gru2 as jax_gru2
from torch_helpers import gate_major, gru_inputs, one_intra_op_thread  # noqa: F401 (fixture)
from tpuasr_torch.ops.gru import BiGRUFunction, bigru_backward_reference, bigru_reference
from tpuasr_torch.ops.gru2 import (
    BiGRU2Function,
    bigru2_backward,
    bigru2_backward_reference,
    bigru2_forward,
    bigru2_reference,
)


@pytest.fixture
def interpret_mode():
    jax_gru2.INTERPRET = True
    yield
    jax_gru2.INTERPRET = False


CASES = [  # (T, B, H, D, lengths)
    pytest.param(10, 4, 16, 2, [10, 7, 2, 9], id="bidir-ragged"),
    pytest.param(7, 3, 16, 2, [7, 0, 4], id="T7-not-multiple-of-4-zero-row"),
    pytest.param(9, 5, 8, 1, [9, 3, 1, 6, 8], id="unidir-D1"),
    pytest.param(1, 1, 8, 2, [1], id="T1-B1"),
]


def _inputs(seed, t, b, h, nd, lengths):
    """K1-layout arrays and their gate-major relayout (xg, w_h, b_h, mask)."""
    xg, w_h, b_h, mask = gru_inputs(np.random.RandomState(seed), t, b, h, nd, lengths)
    return (xg, w_h, b_h, mask), (*gate_major(xg, w_h, b_h), mask)


@pytest.mark.parametrize("t,b,h,nd,lengths", CASES)
def test_reference_matches_jax_pallas2_and_scan(t, b, h, nd, lengths, interpret_mode):
    k1, k5 = _inputs(t * 100 + b + nd, t, b, h, nd, lengths)
    ys = bigru2_reference(*map(torch.from_numpy, k5)).numpy()
    assert ys.shape == (t, nd, b, h)
    ys_pallas2 = np.asarray(jax_gru2.bigru_pallas2(*map(jnp.asarray, k5), 4))
    ys_scan = np.asarray(jax_gru.bigru_reference(*map(jnp.asarray, k1)))
    np.testing.assert_allclose(ys, ys_pallas2, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ys, ys_scan, rtol=2e-5, atol=2e-5)


def test_reference_bf16_matches_jax_pallas2(interpret_mode):
    _, (xg, w_h, b_h, mask) = _inputs(5, 9, 5, 16, 2, [9, 4, 0, 1, 8])
    ys = bigru2_reference(torch.from_numpy(xg).bfloat16(), torch.from_numpy(w_h).bfloat16(),
                          torch.from_numpy(b_h), torch.from_numpy(mask))
    ys_j = jax_gru2.bigru_pallas2(jnp.asarray(xg, jnp.bfloat16), jnp.asarray(w_h, jnp.bfloat16),
                                  jnp.asarray(b_h), jnp.asarray(mask), 4)
    assert ys.dtype == torch.bfloat16
    diff = np.abs(ys.float().numpy() - np.asarray(ys_j, np.float32))
    assert diff.max() <= 3e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


def _grads_torch(fn, xg, w_h, b_h, mask, dy, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (xg, w_h)]
    leaves.append(torch.from_numpy(b_h).requires_grad_())
    ys = fn(*leaves, torch.from_numpy(mask))
    (ys.float() * torch.from_numpy(dy)).sum().backward()
    return [a.grad.float().numpy() for a in leaves]


def _grads_jax(xg, w_h, b_h, mask, dy, dtype=jnp.float32):
    def loss(xg, w_h, b_h):
        ys = jax_gru2.bigru_pallas2(xg, w_h, b_h, jnp.asarray(mask), 4)
        return jnp.sum(ys.astype(jnp.float32) * dy)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xg, dtype), jnp.asarray(w_h, dtype),
                                          jnp.asarray(b_h))
    return [np.asarray(a, np.float32) for a in g]


@pytest.mark.parametrize("t,b,h,nd,lengths", CASES)
def test_function_gradients_match_jax_pallas2_and_autograd(t, b, h, nd, lengths,
                                                           interpret_mode):
    rng = np.random.RandomState(t * 10 + b)
    _, (xg, w_h, b_h, mask) = _inputs(t * 10 + b, t, b, h, nd, lengths)
    dy = rng.randn(t, nd, b, h).astype(np.float32)
    before = (bigru2_forward.launches, bigru2_backward.launches)
    got = _grads_torch(BiGRU2Function.apply, xg, w_h, b_h, mask, dy)
    assert (bigru2_forward.launches, bigru2_backward.launches) == before  # CPU: no kernel
    for want in (_grads_jax(xg, w_h, b_h, mask, dy),
                 _grads_torch(bigru2_reference, xg, w_h, b_h, mask, dy)):
        for name, a, w in zip(("dxg", "dw", "db"), got, want):
            np.testing.assert_allclose(a, w, rtol=3e-4, atol=3e-4, err_msg=name)


def test_function_bf16_gradients_match_jax_pallas2(interpret_mode):
    rng = np.random.RandomState(8)
    _, (xg, w_h, b_h, mask) = _inputs(8, 9, 5, 16, 2, [9, 4, 0, 1, 8])
    dy = rng.randn(9, 2, 5, 16).astype(np.float32)
    got = _grads_torch(BiGRU2Function.apply, xg, w_h, b_h, mask, dy, torch.bfloat16)
    want = _grads_jax(xg, w_h, b_h, mask, dy, jnp.bfloat16)
    for name, a, w in zip(("dxg", "dw", "db"), got, want):
        scale = np.abs(w).max()
        diff = np.abs(a - w)
        assert diff.max() <= 2e-2 * scale and diff.mean() <= 1e-3 * scale, (
            name, diff.max(), diff.mean(), scale)


def test_k5_plain_path_equals_k1_plain_path_on_relaid_weights():
    k1, k5 = map(lambda a: [torch.from_numpy(x) for x in a],
                 _inputs(6, 11, 4, 16, 2, [11, 5, 0, 8]))
    ys = bigru_reference(*k1)
    np.testing.assert_allclose(bigru2_reference(*k5).numpy(), ys.numpy(), rtol=1e-6, atol=1e-6)
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    dy = torch.from_numpy(np.random.RandomState(7).randn(*ys.shape).astype(np.float32))
    packed = bigru_backward_reference(*k1, h_prev, dy)  # (T, D, B, 4H)
    dg = bigru2_backward_reference(*k5, h_prev, dy)  # (T, D, 4, B, H)
    t, nd, b, h4 = packed.shape
    np.testing.assert_allclose(
        dg.numpy(), packed.reshape(t, nd, b, 4, h4 // 4).permute(0, 1, 3, 2, 4).numpy(),
        rtol=1e-6, atol=1e-6)
    # and through the autograd functions: dw relaid out, db reshaped
    dy_np = dy.numpy()
    g1 = _grads_torch(BiGRUFunction.apply, *[a.numpy() for a in k1], dy_np)
    g5 = _grads_torch(BiGRU2Function.apply, *[a.numpy() for a in k5], dy_np)
    for a, b_ in zip(g5, gate_major(*g1)):
        np.testing.assert_allclose(a, b_, rtol=1e-6, atol=1e-6)


def test_gradient_dtypes_follow_inputs():
    """dxg and dw in the compute dtype (the model's bf16 copies), db f32."""
    _, (xg, w_h, b_h, mask) = _inputs(2, 5, 3, 8, 2, None)
    leaves = [torch.from_numpy(xg).bfloat16().requires_grad_(),
              torch.from_numpy(w_h).bfloat16().requires_grad_(),
              torch.from_numpy(b_h).requires_grad_()]
    BiGRU2Function.apply(*leaves, torch.from_numpy(mask)).float().sum().backward()
    assert [a.grad.dtype for a in leaves] == [torch.bfloat16, torch.bfloat16, torch.float32]


def test_cpu_wrappers_are_the_references_and_launch_nothing():
    _, k5 = _inputs(3, 6, 3, 8, 2, None)
    xg, w_h, b_h, mask = map(torch.from_numpy, k5)
    before = (bigru2_forward.launches, bigru2_backward.launches)
    ys = bigru2_forward(xg, w_h, b_h, mask)
    np.testing.assert_array_equal(ys.numpy(), bigru2_reference(xg, w_h, b_h, mask).numpy())
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    dy = torch.from_numpy(np.random.RandomState(4).randn(*ys.shape).astype(np.float32))
    dg = bigru2_backward(xg, w_h, b_h, mask, h_prev, dy)
    assert dg.shape == (6, 2, 4, 3, 8)
    np.testing.assert_array_equal(
        dg.numpy(), bigru2_backward_reference(xg, w_h, b_h, mask, h_prev, dy).numpy())
    assert (bigru2_forward.launches, bigru2_backward.launches) == before
