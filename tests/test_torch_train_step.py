"""tpuasr_torch.train.step against tpuasr.train.step: three train steps
of a small DS2 (hidden 16, 2 layers) from the same numpy weights on the
same batch (a padding row, an infeasible row, ragged lengths), and the
pieces they are made of: train-mode MaskedBatchNorm, the optimizer
(optax clip_by_global_norm + trace(nesterov) vs the port's clip + torch
SGD), the flax-tree mapping of weights and optimizer state, and the
flax init distributions.

Tolerances: f32, 1e-4 relative and absolute on loss, grad_norm,
param_norm, every parameter and every running statistic after each
step (the same f32 arithmetic in another order, through three
updates). bf16 (the JAX package's Pallas kernels in interpreter mode,
whose numerics the port follows): loss, grad_norm and param_norm within
rel 2e-2 and every parameter within 2e-3 after the step (bf16 rounds
activations at 2**-8; an lr of 1e-3 scales what that moves).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuasr.ops.ctc as jax_ctc_ops
import tpuasr.ops.gru as jax_gru
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.model.ds2 import DeepSpeech2 as JaxDeepSpeech2
from tpuasr.model.ds2 import MaskedBatchNorm as JaxMaskedBatchNorm
from tpuasr.model.ds2 import ModelConfig as JaxModelConfig
from tpuasr.train.step import TrainConfig as JaxTrainConfig
from tpuasr.train.step import TrainState, make_optimizer
from tpuasr.train.step import make_train_step as jax_make_train_step
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.compat.weights import (
    from_jax_variables,
    init_train_variables,
    load_momentum,
    model_from_variables,
    momentum_to_opt_state,
    to_jax_variables,
)
from tpuasr_torch.model.ds2 import MaskedBatchNorm, ModelConfig
from tpuasr_torch.train.step import (
    TrainConfig,
    clip_by_global_norm_,
    global_norm,
    make_optimizer as torch_make_optimizer,
    make_train_step,
)

CFG = dict(n_classes=12, hidden_size=16, hidden_layers=2, conv_channels=4)


def _cfgs(dtype="float32", rnn_impl="scan"):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return (ModelConfig(compute_dtype=dtype, rnn_impl=rnn_impl, **CFG),
            JaxModelConfig(compute_dtype=jdt, rnn_impl=rnn_impl, **CFG))


def _batch(seed=0):
    """6 rows: ragged waves, row 4 an infeasible label (20 labels in 6
    frames), row 5 a padding repeat of row 4 (valid False)."""
    rng = np.random.RandomState(seed)
    lengths = np.array([8000, 6400, 5000, 7200, 1700, 1700], np.int32)
    waves = np.zeros((6, 8000), np.int16)
    for i, n in enumerate(lengths):
        waves[i, :n] = (rng.randn(n) * 3000).astype(np.int16)
    n_lab = np.array([6, 3, 5, 4, 20, 20], np.int32)
    labels = np.zeros((6, 20), np.int32)
    for i, n in enumerate(n_lab):
        labels[i, :n] = rng.randint(1, CFG["n_classes"], size=n)
    labels[5] = labels[4]
    valid = np.array([True] * 5 + [False])
    return waves, lengths, labels, n_lab, valid


def _jax_state(variables, jtc):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return TrainState(params=params,
                      batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                      opt_state=make_optimizer(jtc).init(params),
                      step=jnp.zeros((), jnp.int32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _run_both(dtype, rnn_impl, ctc_impl, lrs, max_norm=400.0):
    cfg, jcfg = _cfgs(dtype, rnn_impl)
    variables = init_train_variables(cfg, seed=3)
    tc = TrainConfig(max_norm=max_norm, ctc_impl=ctc_impl)
    jtc = JaxTrainConfig(max_norm=max_norm, ctc_impl=ctc_impl)
    model = model_from_variables(variables, cfg, torch.device("cpu"), trainable=True)
    step = make_train_step(model, FrontendConfig(), tc)
    jstep = jax_make_train_step(jcfg, JaxFrontendConfig(), jtc)
    state = _jax_state(variables, jtc)
    batch = _batch()
    rows = []
    for i, lr in enumerate(lrs):
        m = step(*batch, lr)
        state, mj = jstep(state, *map(jnp.asarray, batch), jnp.float32(lr),
                          jax.random.PRNGKey(i))
        # the JAX step donates its state: copy it out before the next one
        rows.append((m, jax.tree.map(np.asarray, mj), to_jax_variables(model),
                     jax.tree.map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})))
    return rows, step, model, state


def test_three_steps_match_jax_f32():
    rows, *_ = _run_both("float32", "scan", "scan", lrs=[3e-3, 3e-3, 2.5e-3], max_norm=100.0)
    for m, mj, tv, jv in rows:
        assert int(m["n_ok"]) == int(mj["n_ok"]) == 4  # padding and infeasible rows dropped
        assert int(m["n_frames"]) == int(mj["n_frames"])
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(m[k]), float(mj[k]), rtol=1e-4, err_msg=k)
        got, want = _flat(tv), _flat(jv)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    norms = [float(m["grad_norm"]) for m, *_ in rows]
    assert max(norms) > 100.0 > min(norms)  # steps on both sides of the clip


@pytest.fixture
def interpret_mode():
    jax_gru.INTERPRET = jax_ctc_ops.INTERPRET = True
    yield
    jax_gru.INTERPRET = jax_ctc_ops.INTERPRET = False


def test_step_matches_jax_bf16(interpret_mode):
    rows, *_ = _run_both("bfloat16", "pallas", "pallas", lrs=[1e-3])
    m, mj, tv, jv = rows[0]
    assert int(m["n_ok"]) == int(mj["n_ok"]) == 4
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(float(m[k]), float(mj[k]), rtol=2e-2, err_msg=k)
    got, want = _flat(tv), _flat(jv)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-3, err_msg=k)


def test_masked_batchnorm_train_mode_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 5).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([7, 3, 0])[:, None]
    scale, bias = rng.rand(5).astype(np.float32) + 0.5, rng.randn(5).astype(np.float32)
    mean0, var0 = rng.randn(5).astype(np.float32), rng.rand(5).astype(np.float32) + 0.5
    gy = rng.randn(3, 7, 5).astype(np.float32)
    bn = JaxMaskedBatchNorm()
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          x, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * gy), upd

    (_, upd), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables["params"])
    m = MaskedBatchNorm(5)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.copy_(torch.from_numpy(mean0))
        m.var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_()
    (m(xt, torch.from_numpy(mask), train=True) * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(m.mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.var.numpy(), upd["batch_stats"]["var"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), grads[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.scale.grad.numpy(), grads[1]["scale"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.bias.grad.numpy(), grads[1]["bias"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grad_scale", [0.1, 1000.0], ids=["below-max-norm", "clipped"])
def test_optimizer_equals_optax_clip_and_nesterov_trace(grad_scale):
    """Three updates from the first step on, both sides of the clip."""
    rng = np.random.RandomState(1)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * grad_scale).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(40.0), optax.trace(decay=0.9, nesterov=True))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = torch.optim.SGD(tp, lr=0.1, momentum=0.9, nesterov=True, dampening=0.0)
    for lr, g in zip((0.1, 0.05, 0.05), grads):
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, [-lr * u for u in upd])
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        norm = global_norm([p.grad for p in tp])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        clip_by_global_norm_([p.grad for p in tp], 40.0, norm)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_weight_and_optimizer_state_trees_match_flax_and_optax():
    cfg, jcfg = _cfgs()
    flax_vars = JaxDeepSpeech2(jcfg).init_variables(jax.random.PRNGKey(0), t_max=32)
    ours = init_train_variables(cfg, seed=0)
    flax_vars = flax.serialization.to_state_dict(jax.tree.map(np.asarray, flax_vars))
    assert ({k: a.shape for k, a in _flat(ours).items()}
            == {k: a.shape for k, a in _flat(flax_vars).items()})
    # flax's distributions: orthogonal rows, zero biases, unit BN
    w = ours["params"]["rnn1"]["bi"]["recurrent_kernel"].reshape(-1, 3 * CFG["hidden_size"])
    np.testing.assert_allclose(w @ w.T, np.eye(w.shape[0]), atol=1e-5)
    assert not ours["params"]["rnn0"]["bi"]["input_bias"].any()
    k = ours["params"]["head"]["kernel"]
    assert np.abs(k).max() <= 2.0 / np.sqrt(16) / 0.8796 + 1e-6  # truncated at 2 sigma
    # the weights round-trip through the port's model unchanged
    model = model_from_variables(ours, cfg, torch.device("cpu"), trainable=True)
    back = to_jax_variables(model)
    for key, a in _flat(ours).items():
        np.testing.assert_array_equal(_flat(back)[key], a)
    assert from_jax_variables(back, cfg).keys() == model.state_dict().keys()
    # the momentum buffers as optax's state dict, and back
    opt = torch_make_optimizer(model, TrainConfig())
    tx = make_optimizer(JaxTrainConfig())
    optax_state = flax.serialization.to_state_dict(tx.init(flax_vars["params"]))
    state = momentum_to_opt_state(model, opt)
    assert state["0"] == optax_state["0"] == {}
    assert ({k: a.shape for k, a in _flat(state["1"]).items()}
            == {k: a.shape for k, a in _flat(optax_state["1"]).items()})
    assert not any(a.any() for a in jax.tree.leaves(state))  # optax starts from zero
    rng = np.random.RandomState(5)
    state = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), state)
    load_momentum(model, opt, state)
    again = momentum_to_opt_state(model, opt)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
