"""tpuasr_torch.ctc.loss (CTCFromEmit around the K2a/K2b wrappers, on
the CPU their plain recursions) against tpuasr.ctc.loss: the Pallas
loss in interpreter mode and the scan loss, plus the port's own
autograd oracle and torch.nn.functional.ctc_loss on the feasible rows.
The Hopper kernels are held to the plain recursions on a GPU in
test_torch_kernels.py.

Tolerances (tests/test_pallas_ctc.py): loss 1e-5, gradient with
respect to the logits 2e-4. F.ctc_loss sums in its own log-space order:
rel 1e-4 on the loss, 2e-4 on the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.ops.ctc as jax_ctc_ops
from tpuasr.ctc.loss import ctc_loss as jax_ctc_scan
from tpuasr.ctc.loss import ctc_loss_mean as jax_ctc_loss_mean
from tpuasr.ctc.loss import ctc_loss_pallas as jax_ctc_pallas
from tpuasr_torch.ctc.loss import ctc_loss, ctc_loss_autograd, ctc_loss_mean
from tpuasr_torch.ops.ctc import CTCFromEmit, ctc_alpha, ctc_beta


@pytest.fixture
def interpret_mode():
    jax_ctc_ops.INTERPRET = True
    old = jax_ctc_ops.TIME_CHUNK
    jax_ctc_ops.TIME_CHUNK = 4  # exercise chunk boundaries on tiny T
    yield
    jax_ctc_ops.INTERPRET = False
    jax_ctc_ops.TIME_CHUNK = old


def _case(seed, b=6, t=13, c=7, l=5):
    """Rows: full, ragged, an empty label, infeasible (5 labels in 3
    frames), a padding row of 0 frames, repeated labels (no skip)."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, c) * 2).astype(np.float32)
    frames = np.array([t, t - 4, 6, 3, 0, t], np.int32)[:b]
    labels = rng.randint(1, c, size=(b, l)).astype(np.int32)
    labels[5] = [2, 2, 3, 3, 3][:l]
    n_lab = np.array([l, 3, 0, 5, 2, 5], np.int32)[:b]
    return logits, frames, labels, n_lab


def _torch_loss_grad(fn, logits, *rest, weights=None):
    lg = torch.from_numpy(logits).requires_grad_()
    loss = fn(lg, *(torch.from_numpy(a) for a in rest))
    w = torch.ones_like(loss) if weights is None else torch.from_numpy(weights)
    (loss * w).sum().backward()
    return loss.detach().numpy(), lg.grad.numpy()


def _jax_loss_grad(fn, logits, *rest, weights=None):
    rest = [jnp.asarray(a) for a in rest]
    w = jnp.ones(logits.shape[0]) if weights is None else jnp.asarray(weights)
    loss = fn(jnp.asarray(logits), *rest)
    grad = jax.grad(lambda x: jnp.sum(w * fn(x, *rest)))(jnp.asarray(logits))
    return np.asarray(loss), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("jax_impl", ["pallas", "scan"])
def test_loss_and_grad_match_jax(seed, jax_impl, interpret_mode):
    args = _case(seed)
    # weights: a zero cotangent on the infeasible row (as the train
    # step's ok mask gives it) and uneven weights elsewhere
    weights = np.array([0.5, 1.0, 2.0, 0.0, 0.0, 1.5], np.float32)
    before = (ctc_alpha.launches, ctc_beta.launches)
    loss, grad = _torch_loss_grad(ctc_loss, *args, weights=weights)
    assert (ctc_alpha.launches, ctc_beta.launches) == before  # CPU: no kernel
    fn = jax_ctc_pallas if jax_impl == "pallas" else jax_ctc_scan
    loss_j, grad_j = _jax_loss_grad(fn, *args, weights=weights)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, grad_j, rtol=2e-4, atol=2e-4)


def test_special_rows():
    logits, frames, labels, n_lab = _case(2)
    loss, grad = _torch_loss_grad(ctc_loss, logits, frames, labels, n_lab)
    assert loss[3] > 1e29 and loss[4] > 1e29  # infeasible, 0 frames: finite log-zero
    assert np.isfinite(loss).all() and np.isfinite(grad).all()
    assert np.all(grad[4] == 0)  # no valid frame, no gradient
    assert np.all(grad[1, frames[1]:] == 0)  # padded frames get none
    # empty label: the all-blank path, -sum_t log p_t(blank)
    lp = torch.log_softmax(torch.from_numpy(logits[2, :frames[2]]), -1)
    np.testing.assert_allclose(loss[2], -lp[:, 0].sum().item(), rtol=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_autograd_oracle_and_torch_ctc_loss(seed):
    args = _case(seed)
    # no cotangent on the rows with a log-zero likelihood: there the
    # autograd of the clamped recursion is no gradient of anything
    weights = np.array([1, 1, 1, 0, 0, 1], np.float32)
    loss, grad = _torch_loss_grad(ctc_loss, *args, weights=weights)
    loss_a, grad_a = _torch_loss_grad(ctc_loss_autograd, *args, weights=weights)
    np.testing.assert_allclose(loss, loss_a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, grad_a, rtol=2e-4, atol=2e-4)

    logits, frames, labels, n_lab = args
    ok = np.nonzero((n_lab <= frames) & (frames > 0))[0]
    lg = torch.from_numpy(logits[ok]).requires_grad_()
    lib = F.ctc_loss(torch.log_softmax(lg, -1).transpose(0, 1),
                     torch.from_numpy(labels[ok]).long(), torch.from_numpy(frames[ok]).long(),
                     torch.from_numpy(n_lab[ok]).long(), blank=0, reduction="none")
    lib.sum().backward()
    np.testing.assert_allclose(lib.detach().numpy(), loss[ok], rtol=1e-4)
    np.testing.assert_allclose(lg.grad.numpy(), grad[ok], rtol=2e-4, atol=2e-4)


def test_loss_mean_matches_jax():
    logits, frames, labels, n_lab = _case(5)
    mean, ok = ctc_loss_mean(*(torch.from_numpy(a) for a in (logits, frames, labels, n_lab)))
    mean_j, ok_j = jax_ctc_loss_mean(*(jnp.asarray(a) for a in (logits, frames, labels, n_lab)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(mean.item(), float(mean_j), rtol=1e-5)


def _emit_case(seed, t, b, s):
    """Inputs of ``ctc_loss_from_emit`` at (T, B, S), from numpy: log
    emissions, ragged labels (row 0 full width), row 0's frame mask with
    holes (not a prefix), row 1 of fewer frames, skips where the labels
    allow them."""
    rng = np.random.RandomState(seed)
    emit = np.log(rng.dirichlet(np.ones(6), size=(t, b, s)).max(-1)).astype(np.float32)
    n_lab = rng.randint(0, (s - 1) // 2 + 1, size=b)
    n_lab[0] = (s - 1) // 2
    s_idx = np.arange(s)[None, :]
    valid_s = (s_idx < 2 * n_lab[:, None] + 1).astype(np.float32)
    skip = ((s_idx % 2 == 1) & (s_idx >= 2) & (rng.rand(b, s) < 0.7)).astype(np.float32)
    fv = np.ones((t, b), np.float32)
    fv[1::3, 0] = 0.0
    if b > 1:
        fv[t - 2:, 1] = 0.0
    init = np.full((b, s), -1e30, np.float32)
    init[:, 0] = 0.0
    init[:, 1] = np.where(n_lab > 0, 0.0, -1e30)
    end = 2 * n_lab
    end_mask = ((s_idx == end[:, None])
                | ((s_idx == np.maximum(end - 1, 0)[:, None]) & (n_lab > 0)[:, None]))
    return emit, init, skip, valid_s, fv, end_mask.astype(np.float32)


@pytest.mark.parametrize("t,b,s", [(13, 3, 9), (6, 2, 5001)], ids=["small", "S5001"])
def test_emit_loss_and_vjp_match_jax(t, b, s, interpret_mode):
    """CTCFromEmit (on the CPU: K2a's and K2b's plain versions, K2b's
    shift, mask and cotangent folded in) against jax.vjp of
    ctc_loss_from_emit in interpret mode, at the emission level, with an
    uneven cotangent that is zero on the last row; S=5001 is past the
    kernels' old 4096 cap."""
    args = _emit_case(11, t, b, s)
    dloss = np.linspace(0.5, 2.0, b).astype(np.float32)
    dloss[-1] = 0.0
    emit = torch.from_numpy(args[0]).requires_grad_()
    loss = CTCFromEmit.apply(emit, *(torch.from_numpy(a) for a in args[1:]))
    loss.backward(torch.from_numpy(dloss))
    loss_j, vjp = jax.vjp(lambda e: jax_ctc_ops.ctc_loss_from_emit(
        e, *(jnp.asarray(a) for a in args[1:])), jnp.asarray(args[0]))
    (grad_j,) = vjp(jnp.asarray(dloss))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emit.grad.numpy(), np.asarray(grad_j), rtol=2e-4, atol=2e-4)
    assert np.all(emit.grad.numpy()[:, -1] == 0)  # the zero cotangent
    assert np.all(emit.grad.numpy()[1::3, 0] == 0)  # row 0's masked frames
