"""tpuasr_torch.ops.lstm vs tpuasr.ops.lstm: the plain PyTorch BiLSTM
loops (forward and backward, the latter through BiLSTMFunction, whose
wrappers run them on the CPU) against the JAX lax.scan oracle and the
Pallas kernels in interpreter mode. The Hopper kernels are held to the
plain loops on a GPU in test_torch_kernels.py.

Tolerances, as for the BiGRU (test_torch_gru.py,
test_torch_train_kernels.py) and as the JAX suite holds its LSTM kernel
to its oracle (tests/test_pallas_lstm.py): ys and cs 2e-5 in f32;
dxg, dw and db 3e-4 in f32. In bf16 the carried h and the emitted cs
and dhg are rounded to bf16 in both packages (c is carried in f32), so
a different f32 summation order can move one rounding by an ulp (2**-8
relative), which the loop carries on: ys and cs within 3e-2 max-abs and
1e-3 mean-abs; gradients within 2e-2 of the largest and 1e-3 of it on
average.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuasr.ops.lstm as jax_lstm
from torch_helpers import gru_inputs, one_intra_op_thread  # noqa: F401 (fixture)
from tpuasr_torch.ops.lstm import (
    BiLSTMFunction,
    bilstm_backward,
    bilstm_backward_reference,
    bilstm_forward,
    bilstm_reference,
)


@pytest.fixture
def interpret_mode():
    jax_lstm.INTERPRET = True
    yield
    jax_lstm.INTERPRET = False


CASES = [  # (T, B, H, D, lengths)
    pytest.param(10, 4, 16, 2, [10, 7, 2, 9], id="bidir-ragged"),
    pytest.param(7, 3, 16, 2, [7, 0, 4], id="T7-not-multiple-of-4-zero-row"),
    pytest.param(9, 5, 8, 1, [9, 3, 1, 6, 8], id="unidir-D1"),
    pytest.param(1, 1, 8, 2, [1], id="T1-B1"),
]


def _inputs(seed, t, b, h, nd, lengths):
    return gru_inputs(np.random.RandomState(seed), t, b, h, nd, lengths, n_gates=4)


def _jax_fwd(xg, w_h, b_h, mask, dtype=jnp.float32):
    """JAX's Pallas forward (interpreted) -> ys, cs as f32 numpy."""
    ys, res = jax_lstm._bilstm_fwd(jnp.asarray(xg, dtype), jnp.asarray(w_h, dtype),
                                   jnp.asarray(b_h), jnp.asarray(mask), 4)
    return np.asarray(ys, np.float32), np.asarray(res[5], np.float32)


@pytest.mark.parametrize("t,b,h,nd,lengths", CASES)
def test_reference_matches_jax_scan_and_pallas(t, b, h, nd, lengths, interpret_mode):
    arrays = _inputs(t * 100 + b + nd, t, b, h, nd, lengths)
    ys, cs = bilstm_reference(*map(torch.from_numpy, arrays))
    assert ys.shape == cs.shape == (t, nd, b, h)
    ys_scan = np.asarray(jax_lstm.bilstm_reference(*map(jnp.asarray, arrays)))
    ys_pallas, cs_pallas = _jax_fwd(*arrays)
    np.testing.assert_allclose(ys.numpy(), ys_scan, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ys.numpy(), ys_pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(cs.numpy(), cs_pallas, rtol=2e-5, atol=2e-5)


def test_reference_bf16_matches_jax_pallas(interpret_mode):
    xg, w_h, b_h, mask = _inputs(5, 9, 5, 16, 2, [9, 4, 0, 1, 8])
    ys, cs = bilstm_reference(torch.from_numpy(xg).bfloat16(),
                              torch.from_numpy(w_h).bfloat16(),
                              torch.from_numpy(b_h), torch.from_numpy(mask))
    assert ys.dtype == cs.dtype == torch.bfloat16
    for got, want in zip((ys, cs), _jax_fwd(xg, w_h, b_h, mask, jnp.bfloat16)):
        diff = np.abs(got.float().numpy() - want)
        assert diff.max() <= 3e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


def _grads_torch(fn, xg, w_h, b_h, mask, dy, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (xg, w_h)]
    leaves.append(torch.from_numpy(b_h).requires_grad_())
    ys = fn(*leaves, torch.from_numpy(mask))
    (ys.float() * torch.from_numpy(dy)).sum().backward()
    return [a.grad.float().numpy() for a in leaves]


def _grads_jax(xg, w_h, b_h, mask, dy, dtype=jnp.float32):
    def loss(xg, w_h, b_h):
        ys = jax_lstm.bilstm_pallas(xg, w_h, b_h, jnp.asarray(mask), 4)
        return jnp.sum(ys.astype(jnp.float32) * dy)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xg, dtype), jnp.asarray(w_h, dtype),
                                          jnp.asarray(b_h))
    return [np.asarray(a, np.float32) for a in g]


@pytest.mark.parametrize("t,b,h,nd,lengths", CASES)
def test_function_gradients_match_jax_pallas_and_autograd(t, b, h, nd, lengths,
                                                          interpret_mode):
    rng = np.random.RandomState(t * 10 + b)
    xg, w_h, b_h, mask = _inputs(t * 10 + b, t, b, h, nd, lengths)
    dy = rng.randn(t, nd, b, h).astype(np.float32)
    before = (bilstm_forward.launches, bilstm_backward.launches)
    got = _grads_torch(BiLSTMFunction.apply, xg, w_h, b_h, mask, dy)
    assert (bilstm_forward.launches, bilstm_backward.launches) == before  # CPU: no kernel
    plain = _grads_torch(lambda *a: bilstm_reference(*a)[0], xg, w_h, b_h, mask, dy)
    for want in (_grads_jax(xg, w_h, b_h, mask, dy), plain):
        for name, a, w in zip(("dxg", "dw", "db"), got, want):
            np.testing.assert_allclose(a, w, rtol=3e-4, atol=3e-4, err_msg=name)


def test_function_bf16_gradients_match_jax_pallas(interpret_mode):
    rng = np.random.RandomState(8)
    xg, w_h, b_h, mask = _inputs(8, 9, 5, 16, 2, [9, 4, 0, 1, 8])
    dy = rng.randn(9, 2, 5, 16).astype(np.float32)
    got = _grads_torch(BiLSTMFunction.apply, xg, w_h, b_h, mask, dy, torch.bfloat16)
    want = _grads_jax(xg, w_h, b_h, mask, dy, jnp.bfloat16)
    for name, a, w in zip(("dxg", "dw", "db"), got, want):
        scale = np.abs(w).max()
        diff = np.abs(a - w)
        assert diff.max() <= 2e-2 * scale and diff.mean() <= 1e-3 * scale, (
            name, diff.max(), diff.mean(), scale)


def test_gradient_dtypes_follow_inputs():
    """dxg and dw in the compute dtype (the model's bf16 copies), db f32."""
    xg, w_h, b_h, mask = map(torch.from_numpy, _inputs(2, 5, 3, 8, 2, None))
    leaves = [xg.bfloat16().requires_grad_(), w_h.bfloat16().requires_grad_(),
              b_h.requires_grad_()]
    BiLSTMFunction.apply(*leaves, mask).float().sum().backward()
    assert [a.grad.dtype for a in leaves] == [torch.bfloat16, torch.bfloat16, torch.float32]


def test_cpu_wrappers_are_the_references_and_launch_nothing():
    xg, w_h, b_h, mask = map(torch.from_numpy, _inputs(3, 6, 3, 8, 2, None))
    before = (bilstm_forward.launches, bilstm_backward.launches)
    ys, cs = bilstm_forward(xg, w_h, b_h, mask)
    ys_r, cs_r = bilstm_reference(xg, w_h, b_h, mask)
    np.testing.assert_array_equal(ys.numpy(), ys_r.numpy())
    np.testing.assert_array_equal(cs.numpy(), cs_r.numpy())
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    dy = torch.from_numpy(np.random.RandomState(4).randn(*ys.shape).astype(np.float32))
    dhg = bilstm_backward(xg, w_h, b_h, mask, h_prev, c_prev, cs, dy)
    assert dhg.shape == (6, 2, 3, 32)
    np.testing.assert_array_equal(
        dhg.numpy(),
        bilstm_backward_reference(xg, w_h, b_h, mask, h_prev, c_prev, cs, dy).numpy())
    assert (bilstm_forward.launches, bilstm_backward.launches) == before
