"""One train step of the port's BiLSTM (rnn_type="lstm", K4) and
gate-major BiGRU (rnn_impl="pallas2", K5) models against tpuasr's, from
the same numpy weights on the same batch (a padding row, an infeasible
row, ragged lengths), in f32 against the JAX scan path and in bf16
against the JAX Pallas kernels in interpreter mode.

Tolerances, test_torch_train_step.py's: f32 loss, grad_norm, param_norm
and every parameter and running statistic within 1e-4 (the same f32
arithmetic in another order); bf16 loss, grad_norm and param_norm within
rel 2e-2 and every parameter within 2e-3 after the step (bf16 rounds
activations at 2**-8; an lr of 1e-3 scales what that moves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.ops.ctc as jax_ctc_ops
import tpuasr.ops.gru2 as jax_gru2
import tpuasr.ops.lstm as jax_lstm
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr.train.step import TrainConfig as JaxTrainConfig
from tpuasr.train.step import TrainState, make_optimizer
from tpuasr.train.step import make_train_step as jax_make_train_step
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.compat.weights import (
    init_train_variables,
    model_from_variables,
    to_jax_variables,
)
from tpuasr_torch.model.ds2 import ModelConfig
from tpuasr_torch.train.step import TrainConfig, make_train_step

CPU = torch.device("cpu")
CFG = dict(n_classes=12, hidden_size=16, hidden_layers=2, conv_channels=4)


@pytest.fixture
def interpret_mode():
    jax_lstm.INTERPRET = jax_gru2.INTERPRET = jax_ctc_ops.INTERPRET = True
    yield
    jax_lstm.INTERPRET = jax_gru2.INTERPRET = jax_ctc_ops.INTERPRET = False


def _batch(seed=0):
    """6 rows: ragged waves, row 4 an infeasible label, row 5 padding."""
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
    return waves, lengths, labels, n_lab, np.array([True] * 5 + [False])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("rnn_type,rnn_impl,dtype,jax_impl", [
    pytest.param("lstm", "pallas", "float32", "scan", id="lstm-f32-vs-scan"),
    pytest.param("lstm", "pallas", "bfloat16", "pallas", id="lstm-bf16-vs-pallas"),
    pytest.param("gru", "pallas2", "float32", "scan", id="gru-pallas2-f32-vs-scan"),
    pytest.param("gru", "pallas2", "bfloat16", "pallas2", id="gru-pallas2-bf16-vs-pallas2"),
])
def test_train_step_matches_jax(rnn_type, rnn_impl, dtype, jax_impl, interpret_mode):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = ModelConfig(compute_dtype=dtype, rnn_type=rnn_type, rnn_impl=rnn_impl, **CFG)
    jcfg = JaxConfig(compute_dtype=jdt, rnn_type=rnn_type, rnn_impl=jax_impl, **CFG)
    ctc = "pallas" if dtype == "bfloat16" else "scan"
    variables = init_train_variables(cfg, seed=3)
    model = model_from_variables(variables, cfg, CPU, trainable=True)
    m = make_train_step(model, FrontendConfig(), TrainConfig(ctc_impl=ctc))(*_batch(), 1e-3)
    jtc = JaxTrainConfig(ctc_impl=ctc)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=make_optimizer(jtc).init(params),
                       step=jnp.zeros((), jnp.int32))
    state, mj = jax_make_train_step(jcfg, JaxFrontendConfig(), jtc)(
        state, *map(jnp.asarray, _batch()), jnp.float32(1e-3), jax.random.PRNGKey(0))
    assert int(m["n_ok"]) == int(mj["n_ok"]) == 4
    got = _flat(to_jax_variables(model))
    want = _flat({"params": state.params, "batch_stats": state.batch_stats})
    assert got.keys() == want.keys()
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(float(m[k]), float(mj[k]),
                                   rtol=1e-4 if dtype == "float32" else 2e-2, err_msg=k)
    for k in want:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-3, err_msg=k)
