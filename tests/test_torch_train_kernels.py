"""tpuasr_torch.ops.gru's backward (BiGRUFunction around the K1b
wrapper, on the CPU its plain loop) against tpuasr.ops.gru.bigru_pallas'
custom VJP in interpreter mode, and against torch autograd through the
plain forward loop. The Hopper kernel is held to the plain loop on a GPU
in test_torch_kernels.py.

Tolerance: 3e-4 on dxg, dw and db, as the JAX suite holds its kernel's
gradients to its oracle (tests/test_pallas_gru.py). In bf16 the packed
gradients are rounded to bf16 in both packages; held to 2e-2 of the
largest gradient (one bf16 ulp, 2**-8, of a recomputed gate moved by
another f32 summation order) and 1e-3 of it on average.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuasr.ops.gru as jax_gru
from torch_helpers import gru_inputs
from tpuasr_torch.ops.gru import (
    BiGRUFunction,
    bigru_backward,
    bigru_backward_reference,
    bigru_forward,
    bigru_reference,
)


@pytest.fixture
def interpret_mode():
    jax_gru.INTERPRET = True
    yield
    jax_gru.INTERPRET = False


CASES = [  # (T, B, H, D, lengths)
    pytest.param(10, 4, 16, 2, [10, 7, 2, 9], id="bidir-ragged"),
    pytest.param(7, 3, 16, 2, [7, 0, 4], id="T7-not-multiple-of-8-zero-row"),
    pytest.param(9, 5, 8, 1, [9, 3, 1, 6, 8], id="unidir-D1"),
    pytest.param(13, 2, 32, 2, None, id="random-lengths"),
]


def _grads_torch(fn, xg, w_h, b_h, mask, dy, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (xg, w_h)]
    leaves.append(torch.from_numpy(b_h).requires_grad_())
    ys = fn(*leaves, torch.from_numpy(mask))
    (ys.float() * torch.from_numpy(dy)).sum().backward()
    return [a.grad.float().numpy() for a in leaves]


def _grads_jax(xg, w_h, b_h, mask, dy, dtype=jnp.float32):
    def loss(xg, w_h, b_h):
        ys = jax_gru.bigru_pallas(xg, w_h, b_h, jnp.asarray(mask), 4)
        return jnp.sum(ys.astype(jnp.float32) * dy)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xg, dtype), jnp.asarray(w_h, dtype),
                                          jnp.asarray(b_h))
    return [np.asarray(a, np.float32) for a in g]


@pytest.mark.parametrize("t,b,h,nd,lengths", CASES)
def test_function_gradients_match_jax_pallas_and_autograd(t, b, h, nd, lengths,
                                                          interpret_mode):
    rng = np.random.RandomState(t * 10 + b)
    xg, w_h, b_h, mask = gru_inputs(rng, t, b, h, nd, lengths)
    dy = rng.randn(t, nd, b, h).astype(np.float32)
    before = (bigru_forward.launches, bigru_backward.launches)
    got = _grads_torch(BiGRUFunction.apply, xg, w_h, b_h, mask, dy)
    assert (bigru_forward.launches, bigru_backward.launches) == before  # CPU: no kernel
    for want in (_grads_jax(xg, w_h, b_h, mask, dy),
                 _grads_torch(bigru_reference, xg, w_h, b_h, mask, dy)):
        for name, a, w in zip(("dxg", "dw", "db"), got, want):
            np.testing.assert_allclose(a, w, rtol=3e-4, atol=3e-4, err_msg=name)


def test_function_bf16_gradients_match_jax_pallas(interpret_mode):
    rng = np.random.RandomState(8)
    xg, w_h, b_h, mask = gru_inputs(rng, 9, 5, 16, 2, lengths=[9, 4, 0, 1, 8])
    dy = rng.randn(9, 2, 5, 16).astype(np.float32)
    got = _grads_torch(BiGRUFunction.apply, xg, w_h, b_h, mask, dy, torch.bfloat16)
    want = _grads_jax(xg, w_h, b_h, mask, dy, jnp.bfloat16)
    for name, a, w in zip(("dxg", "dw", "db"), got, want):
        scale = np.abs(w).max()
        diff = np.abs(a - w)
        assert diff.max() <= 2e-2 * scale and diff.mean() <= 1e-3 * scale, (
            name, diff.max(), diff.mean(), scale)


def test_gradient_dtypes_follow_inputs():
    """dxg and dw in the compute dtype (the model's bf16 copies), db f32."""
    rng = np.random.RandomState(2)
    xg, w_h, b_h, mask = (torch.from_numpy(a) for a in gru_inputs(rng, 5, 3, 8, 2))
    leaves = [xg.bfloat16().requires_grad_(), w_h.bfloat16().requires_grad_(),
              b_h.requires_grad_()]
    BiGRUFunction.apply(*leaves, mask).float().sum().backward()
    assert [a.grad.dtype for a in leaves] == [torch.bfloat16, torch.bfloat16, torch.float32]


def test_backward_wrapper_is_the_reference_on_cpu():
    rng = np.random.RandomState(3)
    xg, w_h, b_h, mask = (torch.from_numpy(a) for a in gru_inputs(rng, 6, 3, 8, 2))
    ys = bigru_reference(xg, w_h, b_h, mask)
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    dy = torch.from_numpy(rng.randn(*ys.shape).astype(np.float32))
    before = bigru_backward.launches
    packed = bigru_backward(xg, w_h, b_h, mask, h_prev, dy)
    assert packed.shape == (6, 2, 3, 32)
    np.testing.assert_array_equal(
        packed.numpy(), bigru_backward_reference(xg, w_h, b_h, mask, h_prev, dy).numpy())
    assert bigru_backward.launches == before
