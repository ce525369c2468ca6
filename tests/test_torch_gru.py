"""tpuasr_torch.ops.gru vs tpuasr.ops.gru: the plain PyTorch BiGRU loop
against the JAX lax.scan oracle and the Pallas kernel (interpreter
mode on the CPU). The Hopper kernel is held to the plain loop on a GPU
in test_torch_kernels.py.

Tolerances: 2e-5 in f32, as the JAX suite holds its kernel to its
oracle (tests/test_pallas_gru.py). In bf16 the carried h is rounded to
bf16 every step in both packages; a different f32 summation order can
move one rounding by an ulp (2**-8 relative) and that difference is
carried on, so bf16 is held to 3e-2 max-abs and 1e-3 mean-abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuasr.ops.gru as jax_gru
from torch_helpers import gru_inputs, one_intra_op_thread  # noqa: F401 (fixture)
from tpuasr_torch.ops.gru import bigru_forward, bigru_reference


@pytest.fixture
def interpret_mode():
    jax_gru.INTERPRET = True
    yield
    jax_gru.INTERPRET = False


CASES = [  # (T, B, H, D)
    pytest.param(10, 4, 16, 2, id="bidir"),
    pytest.param(7, 4, 16, 2, id="T7-not-multiple-of-8"),
    pytest.param(6, 96, 16, 2, id="B96"),
    pytest.param(7, 3, 8, 1, id="unidir-D1"),
]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t,b,h,nd", CASES)
def test_reference_matches_jax_scan_and_pallas(t, b, h, nd, interpret_mode):
    rng = np.random.RandomState(t * 100 + b + nd)
    arrays = gru_inputs(rng, t, b, h, nd)
    ys = bigru_reference(*_torch(*arrays)).numpy()
    ys_scan = np.asarray(jax_gru.bigru_reference(*map(jnp.asarray, arrays)))
    ys_pallas = np.asarray(jax_gru.bigru_pallas(*map(jnp.asarray, arrays), 4))
    assert ys.shape == (t, nd, b, h)
    np.testing.assert_allclose(ys, ys_scan, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ys, ys_pallas, rtol=2e-5, atol=2e-5)


def test_reference_bf16_matches_jax_pallas(interpret_mode):
    rng = np.random.RandomState(5)
    xg, w_h, b_h, mask = gru_inputs(rng, 9, 5, 16, 2, lengths=[9, 4, 0, 1, 8])
    ys = bigru_reference(torch.from_numpy(xg).to(torch.bfloat16),
                         torch.from_numpy(w_h).to(torch.bfloat16),
                         torch.from_numpy(b_h), torch.from_numpy(mask))
    ys_j = jax_gru.bigru_pallas(jnp.asarray(xg, jnp.bfloat16),
                                jnp.asarray(w_h, jnp.bfloat16),
                                jnp.asarray(b_h), jnp.asarray(mask), 4)
    assert ys.dtype == torch.bfloat16
    diff = np.abs(ys.float().numpy() - np.asarray(ys_j, np.float32))
    assert diff.max() <= 3e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


def test_cpu_wrapper_is_the_reference_and_launches_nothing():
    rng = np.random.RandomState(3)
    args = _torch(*gru_inputs(rng, 5, 3, 8, 2))
    before = bigru_forward.launches
    np.testing.assert_array_equal(bigru_forward(*args).numpy(),
                                  bigru_reference(*args).numpy())
    assert bigru_forward.launches == before
