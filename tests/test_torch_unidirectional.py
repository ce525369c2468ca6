"""The port's unidirectional models (GRU on K1 and LSTM on K4 with one
direction, the vanilla RNN's plain loop) with and without the Lookahead
layer, and the bidirectional vanilla RNN, against tpuasr's on one set of
seeded weights: eval logits, the weight tree, one train step, and
``.tpuasr`` checkpoints written by either package loaded by the other.

Tolerances: f32 logits 2e-4 against the JAX scan path (as
test_torch_model.py); one f32 train step's loss, grad_norm, param_norm
and every parameter and running statistic within 1e-4
(test_torch_rnn_train_step.py's f32 tolerances: the same f32 arithmetic
in another order).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.model.ds2 import DeepSpeech2 as JaxDS2
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr.train import checkpoint as jax_ckpt
from tpuasr.train.step import TrainConfig as JaxTrainConfig
from tpuasr.train.step import TrainState, make_optimizer
from tpuasr.train.step import make_train_step as jax_make_train_step
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.compat.weights import (
    init_train_variables,
    init_variables,
    model_from_variables,
    to_jax_variables,
    variable_paths,
)
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model import ds2
from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.ops import lstm as lstm_mod
from tpuasr_torch.train import checkpoint as ckpt
from tpuasr_torch.train.step import TrainConfig, make_train_step

CPU = torch.device("cpu")
ARCHS = [
    pytest.param("gru", False, 4, id="gru-uni-la4"),
    pytest.param("gru", False, 0, id="gru-uni-la0"),
    pytest.param("lstm", False, 4, id="lstm-uni-la4"),
    pytest.param("lstm", False, 0, id="lstm-uni-la0"),
    pytest.param("rnn", False, 4, id="rnn-uni-la4"),
    pytest.param("rnn", False, 0, id="rnn-uni-la0"),
    pytest.param("rnn", True, 20, id="rnn-bi"),
]


def _cfg(rnn_type, bidirectional, lookahead, **kw):
    return ModelConfig(**{**dict(hidden_size=32, hidden_layers=2, compute_dtype="float32",
                                 rnn_type=rnn_type, bidirectional=bidirectional,
                                 lookahead_context=lookahead), **kw})


def _feats(seed, b=4, t=37):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, 161).astype(np.float32)
    lengths = np.array([t, 23, 0, 9][:b], np.int32)  # ragged + empty slot
    feats *= (np.arange(t)[None, :, None] < lengths[:, None, None])
    return feats, lengths


def _jax_logits(variables, cfg, feats, lengths):
    lo, ol = JaxDS2(JaxConfig.from_dict(cfg.to_dict())).apply(
        variables, jnp.asarray(feats), jnp.asarray(lengths), train=False)
    return np.asarray(lo), np.asarray(ol)


def _port_logits(variables, cfg, feats, lengths):
    model = model_from_variables(variables, cfg, CPU)
    with torch.inference_mode():
        lo, ol = model(torch.from_numpy(feats), torch.from_numpy(lengths))
    return lo.numpy(), ol.numpy()


@pytest.mark.parametrize("rnn_type,bidirectional,lookahead", ARCHS)
def test_logits_match_jax_f32(rnn_type, bidirectional, lookahead):
    cfg = _cfg(rnn_type, bidirectional, lookahead)
    variables = init_variables(cfg, seed=7)
    feats, lengths = _feats(1)
    lo_j, ol_j = _jax_logits(variables, cfg, feats, lengths)
    lo_t, ol_t = _port_logits(variables, cfg, feats, lengths)
    np.testing.assert_array_equal(ol_t, ol_j)
    assert lo_t.shape == lo_j.shape and lo_t.dtype == np.float32
    np.testing.assert_allclose(lo_t, lo_j, rtol=2e-4, atol=2e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("rnn_type,bidirectional,lookahead", [
    ("gru", False, 4), ("rnn", True, 20)])
def test_weight_tree_matches_flax_init(rnn_type, bidirectional, lookahead):
    """Same paths and shapes as flax's init (``fwd``/``input_proj``,
    ``lookahead/Conv_0``, G=1 for the vanilla RNN), both of which the
    state dict names one to one."""
    cfg = _cfg(rnn_type, bidirectional, lookahead, hidden_size=16, n_classes=12,
               conv_channels=4)
    flax_vars = flax.serialization.to_state_dict(jax.tree.map(
        np.asarray, JaxDS2(JaxConfig.from_dict(cfg.to_dict())).init_variables(
            jax.random.PRNGKey(0), t_max=32)))
    ours = init_train_variables(cfg, seed=0)
    assert ({k: a.shape for k, a in _flat(ours).items()}
            == {k: a.shape for k, a in _flat(flax_vars).items()})
    names = {name for name, _, _ in variable_paths(cfg)}
    assert names == set(DeepSpeech2(cfg).state_dict())
    assert ("lookahead.kernel" in names) == (not bidirectional and lookahead > 0)


@pytest.mark.parametrize("rnn_type,kernel", [("gru", "bigru"), ("lstm", "bilstm")])
def test_unidirectional_runs_its_kernel_at_one_direction(rnn_type, kernel, monkeypatch):
    """Inference calls the forward wrapper with D=1; training its
    autograd function (forward and backward wrappers, D=1). ``pallas2``
    keeps K1 for a unidirectional GRU (K5 is bidirectional only)."""
    calls = []
    for mod in (ds2, gru_mod, lstm_mod):
        for name in (f"{kernel}_forward", f"{kernel}_backward"):
            if hasattr(mod, name):
                fn = getattr(mod, name)
                monkeypatch.setattr(mod, name, lambda *a, n=name, f=fn: (
                    calls.append((n, a[0].shape[1])), f(*a))[1])
    cfg = _cfg(rnn_type, False, 3, hidden_size=8, hidden_layers=1, rnn_impl="pallas2")
    model = model_from_variables(init_variables(cfg, seed=0), cfg, CPU, trainable=True)
    feats, lengths = _feats(3, t=21)
    with torch.no_grad():
        model(torch.from_numpy(feats), torch.from_numpy(lengths))
    assert calls == [(f"{kernel}_forward", 1)]
    logits, _ = model(torch.from_numpy(feats), torch.from_numpy(lengths), train=True)
    logits.sum().backward()
    assert calls == [(f"{kernel}_forward", 1)] * 2 + [(f"{kernel}_backward", 1)]


TRAIN_CFG = dict(n_classes=12, hidden_size=16, hidden_layers=2, conv_channels=4)


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
        labels[i, :n] = rng.randint(1, TRAIN_CFG["n_classes"], size=n)
    labels[5] = labels[4]
    return waves, lengths, labels, n_lab, np.array([True] * 5 + [False])


@pytest.mark.parametrize("rnn_type,bidirectional,lookahead", [
    pytest.param("gru", False, 4, id="gru-uni-la4"),
    pytest.param("lstm", False, 0, id="lstm-uni"),
    pytest.param("rnn", True, 20, id="rnn-bi"),
])
def test_train_step_matches_jax(rnn_type, bidirectional, lookahead):
    cfg = ModelConfig(compute_dtype="float32", rnn_type=rnn_type, bidirectional=bidirectional,
                      lookahead_context=lookahead, **TRAIN_CFG)
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    variables = init_train_variables(cfg, seed=3)
    model = model_from_variables(variables, cfg, CPU, trainable=True)
    m = make_train_step(model, FrontendConfig(), TrainConfig(ctc_impl="scan"))(*_batch(), 1e-3)
    jtc = JaxTrainConfig(ctc_impl="scan")
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
        np.testing.assert_allclose(float(m[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


UNI = _cfg("gru", False, 4, hidden_size=16)
VANILLA = _cfg("rnn", False, 3, hidden_size=16)


@pytest.mark.parametrize("cfg", [pytest.param(UNI, id="gru-uni"),
                                 pytest.param(VANILLA, id="rnn-uni")])
def test_checkpoints_load_across_packages(cfg, tmp_path):
    """A checkpoint the port writes loads in tpuasr and one tpuasr
    writes loads in the port: the same config, and the same logits."""
    feats, lengths = _feats(6)
    port_path, jax_path = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    ckpt.save_checkpoint(port_path, ckpt.CheckpointPackage(
        model_config=cfg, frontend_config=FrontendConfig(), labels=Alphabet().labels,
        variables=init_variables(cfg, seed=5)))
    jax_ckpt.save_checkpoint(jax_path, jax_ckpt.CheckpointPackage(
        model_config=JaxConfig.from_dict(cfg.to_dict()),
        frontend_config=JaxFrontendConfig(), labels=Alphabet().labels,
        variables=init_variables(cfg, seed=6)))
    for path in (port_path, jax_path):
        jpkg, pkg = jax_ckpt.load_checkpoint(path), ckpt.load_checkpoint(path)
        assert pkg.model_config == cfg
        assert jpkg.model_config.to_dict() == cfg.to_dict()
        lo_j, _ = _jax_logits(jpkg.variables, cfg, feats, lengths)
        lo_t, _ = _port_logits(pkg.variables, pkg.model_config, feats, lengths)
        np.testing.assert_allclose(lo_t, lo_j, rtol=2e-4, atol=2e-4)
