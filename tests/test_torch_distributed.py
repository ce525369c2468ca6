"""tpuasr_torch.train.mesh against tpuasr.train.mesh: the sharding rule,
and distributed train steps of the port in gloo ranks on the CPU against
the JAX package's single-device step on the global batch.

The ranks are fresh interpreters that import tpuasr_torch and nothing of
JAX (``torch_helpers.run_ranks``, a file:// rendezvous in tmp_path, every
rank under a timeout); the JAX side runs in the pytest process on the
same numpy weights (``init_train_variables``) and batch.

  * the rule: ``param_sharding_specs`` names the same spec for every
    parameter as tpuasr's on the GRU, LSTM, gate-major GRU and
    unidirectional trees, tp 2 and 4, direction TP on and off (a
    6-wide gate axis does not divide by 4 and replicates);
  * data parallelism, 2 ranks of 4 rows against JAX's step on the 8
    rows (tests/test_dp.py's setting): loss, param_norm, parameters and
    BatchNorm statistics within 1e-5, grad_norm within 1e-5 of the
    single-process port (which is 2.3e-5 from JAX's, as in
    tests/test_torch_train_step.py's 1e-4), and both ranks
    bit-identical; the
    same with tempo, gain and SpecAugment draws against the port's
    single-process step on the 8 rows (JAX's draws differ);
  * direction TP at tp 2 (GRU, LSTM, gate-major GRU; each rank runs its
    direction at D=1) and gate-axis TP at tp 4 on 4 ranks and at dp 2 x
    tp 2, against JAX's single-device trajectory of tests/test_tp.py
    (3 steps, losses at rtol 3e-4 as there; parameters within 1e-4, as
    tests/test_torch_train_step.py holds the single-process port).

JAX runs its XLA scan here (``rnn_impl="scan"``), the plain reference of
its Pallas kernels; the port's kernels run their plain versions on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import dist_steps, one_intra_op_thread, run_ranks  # noqa: F401
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.model.ds2 import ModelConfig as JaxModelConfig
from tpuasr.train import mesh as jax_mesh
from tpuasr.train.step import TrainConfig as JaxTrainConfig
from tpuasr.train.step import TrainState, make_optimizer
from tpuasr.train.step import make_train_step as jax_make_train_step
from tpuasr_torch.compat.weights import init_train_variables, variable_paths
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
from tpuasr_torch.train.mesh import make_mesh, param_sharding_specs

N_CLASSES = Alphabet().size


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# ------------------------------------------------------------------ the rule

TREES = {
    "gru": dict(rnn_type="gru", rnn_impl="pallas"),
    "lstm": dict(rnn_type="lstm", rnn_impl="pallas"),
    "gru2": dict(rnn_type="gru", rnn_impl="pallas2"),
    "uni": dict(rnn_type="gru", bidirectional=False, lookahead_context=3),
    "narrow": dict(rnn_type="gru", hidden_size=2),  # a 6-wide gate axis
}


@pytest.fixture(scope="module")
def jax_params():
    """tpuasr's parameter tree of each TREES model (flax init; the tree
    of a Pallas impl is its scan's)."""
    from tpuasr.train.step import init_train_state

    out = {}
    for name, kw in TREES.items():
        kw = {"hidden_size": 16, **kw}
        mc = JaxModelConfig(n_classes=12, hidden_layers=2, conv_channels=4,
                            compute_dtype=jnp.float32, **{**kw, "rnn_impl": "scan"})
        out[name] = (ModelConfig(n_classes=12, hidden_layers=2, conv_channels=4,
                                 compute_dtype="float32", **kw),
                     init_train_state(mc, JaxTrainConfig(), jax.random.PRNGKey(0)).params)
    return out


@pytest.mark.parametrize("direction_tp", [False, True], ids=["gate", "direction"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_sharding_rule_names_tpuasrs_specs(jax_params, tree, tp, direction_tp):
    cfg, params = jax_params[tree]
    want = jax_mesh.param_sharding_specs(jax_mesh.make_mesh(jax.devices()[:8], tp=tp),
                                         params, direction_tp)
    got = param_sharding_specs(DeepSpeech2(cfg), tp, direction_tp)
    paths = {name: path[1:] for name, path, _ in variable_paths(cfg) if path[0] == "params"}
    assert got.keys() == paths.keys()
    for name, spec in got.items():
        leaf = want
        for k in paths[name]:
            leaf = leaf[k]
        assert spec == tuple(leaf), (name, spec, leaf)


def test_make_mesh_refuses_a_tp_that_does_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(6, tp=4)
    with pytest.raises(ValueError, match="divisible"):
        jax_mesh.make_mesh(jax.devices()[:6], tp=4)
    single = make_mesh(1, 1)  # one process: no group, no collective
    assert (single.data, single.model, single.data_size) == (None, None, 1)


# ------------------------------------------------------------- the steps

def _batch(path, b, n, n_lab, n_classes, seed=0):
    """tests/test_dp.py's and test_tp.py's batch: f32 noise waves of n
    samples, n_lab labels each, every row valid."""
    rng = np.random.RandomState(seed)
    fields = dict(waves=(rng.randn(b, n) * 0.1).astype(np.float32),
                  wave_lengths=np.full((b,), n, np.int32),
                  labels=rng.randint(1, n_classes, size=(b, n_lab)).astype(np.int32),
                  label_lengths=np.full((b,), n_lab, np.int32),
                  valid=np.ones((b,), bool))
    np.savez(path, **fields)
    return fields


def _jax_run(cfg: ModelConfig, seed: int, batch: dict, lrs) -> list:
    """JAX's single-device trajectory from the port's init weights:
    [(metrics, variables)] after each step."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cfg.compute_dtype]
    mc = JaxModelConfig(**{**cfg.to_dict(), "compute_dtype": jdt, "param_dtype": jnp.float32,
                           "rnn_impl": "scan"})
    tc = JaxTrainConfig()
    variables = init_train_variables(cfg, seed=seed)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=make_optimizer(tc).init(params), step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(mc, JaxFrontendConfig(), tc)
    args = [jnp.asarray(batch[k]) for k in
            ("waves", "wave_lengths", "labels", "label_lengths", "valid")]
    out = []
    for i, lr in enumerate(lrs):
        state, m = step(state, *args, jnp.float32(lr), jax.random.PRNGKey(i))
        out.append(({k: float(v) for k, v in m.items()},
                    jax.tree.map(np.asarray, {"params": state.params,
                                              "batch_stats": state.batch_stats})))
    return out


def _assert_ranks_identical(outs):
    first = _flat(outs[0]["variables"])
    for o in outs[1:]:
        other = _flat(o["variables"])
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
        assert o["metrics"] == outs[0]["metrics"]


DP_CFG = ModelConfig(n_classes=10, hidden_size=16, hidden_layers=1, compute_dtype="float32")


def test_data_parallel_step_equals_jax_on_the_global_batch(tmp_path):
    batch = _batch(tmp_path / "batch.npz", 8, 4000, 4, 10)
    spec = dict(model=DP_CFG.to_dict(), seed=0, batch=str(tmp_path / "batch.npz"),
                lrs=[1e-3], max_norm=400.0, augment=None, aug_seed=0, world=2, tp=1)
    outs = run_ranks(spec, tmp_path)
    _assert_ranks_identical(outs)
    (mj, vj), = _jax_run(DP_CFG, 0, batch, [1e-3])
    m = outs[0]["metrics"][0]
    assert m["n_ok"] == mj["n_ok"] == 8 and m["n_frames"] == mj["n_frames"]
    for k in ("loss", "param_norm"):
        assert abs(m[k] - mj[k]) < 1e-5 * max(1.0, abs(mj[k])), (k, m[k], mj[k])
    # grad_norm: the single-process port is 2.3e-5 (relative) from JAX's
    # here (tests/test_torch_train_step.py holds it at 1e-4); the ranks
    # are within 1e-5 of the single-process port
    one = dist_steps(spec)["metrics"][0]["grad_norm"]
    assert abs(m["grad_norm"] - one) < 1e-5 * one
    np.testing.assert_allclose(m["grad_norm"], mj["grad_norm"], rtol=1e-4)
    got, want = _flat(outs[0]["variables"]), _flat(vj)
    assert got.keys() == want.keys()
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) < 1e-5


def test_data_parallel_augmented_step_draws_for_the_global_batch(tmp_path):
    """Each rank draws tempo, gain and SpecAugment for all 8 rows and
    applies its own 4: the 2-rank step equals the single-process step
    on the 8 rows with the same generator."""
    _batch(tmp_path / "batch.npz", 8, 6000, 4, 10)
    spec = dict(model=DP_CFG.to_dict(), seed=0, batch=str(tmp_path / "batch.npz"),
                lrs=[1e-3, 1e-3], max_norm=400.0, aug_seed=11, world=2, tp=1,
                augment=dict(tempo_gain=True, spec_augment=True))
    outs = run_ranks(spec, tmp_path)
    _assert_ranks_identical(outs)
    one = dist_steps(spec)
    for m, m1 in zip(outs[0]["metrics"], one["metrics"]):
        for k in m1:
            assert abs(m[k] - m1[k]) < 1e-5 * max(1.0, abs(m1[k])), (k, m[k], m1[k])
    got, want = _flat(outs[0]["variables"]), _flat(one["variables"])
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) < 1e-5
    # the draws really moved the batch: the augmented step is not the plain one
    plain = dist_steps({**spec, "augment": None})
    assert abs(plain["metrics"][0]["loss"] - one["metrics"][0]["loss"]) > 1e-3


def _tp_case(tmp_path, cfg, world, tp, direction_tp, b, n):
    batch = _batch(tmp_path / "batch.npz", b, n, 12, 29)
    lrs = [3e-4] * 3
    spec = dict(model=cfg.to_dict(), seed=0, batch=str(tmp_path / "batch.npz"), lrs=lrs,
                max_norm=400.0, augment=None, aug_seed=0, world=world, tp=tp,
                direction_tp=direction_tp)
    outs = run_ranks(spec, tmp_path)
    ref = _jax_run(cfg, 0, batch, lrs)
    np.testing.assert_allclose([m["loss"] for m in outs[0]["metrics"]],
                               [m["loss"] for m, _ in ref], rtol=3e-4)
    got, want = _flat(outs[0]["variables"]), _flat(ref[-1][1])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    # the data ranks agree bit for bit (model ranks hold other shards)
    for o in outs[tp::tp]:
        for k, v in _flat(o["variables"]).items():
            np.testing.assert_array_equal(v, got[k], err_msg=k)
    return outs


@pytest.mark.parametrize("path", ["gru", "lstm", "gru2"])
def test_direction_tp_equals_jax_single_device(tmp_path, path):
    """tests/test_tp.py:106's run: tp 2, one direction a model rank."""
    kw = {"gru": {}, "lstm": {"rnn_type": "lstm"}, "gru2": {"rnn_impl": "pallas2"}}[path]
    cfg = ModelConfig(**{"n_classes": N_CLASSES, "hidden_size": 16, "hidden_layers": 2,
                         "compute_dtype": "float32", "rnn_impl": "pallas", **kw})
    outs = _tp_case(tmp_path, cfg, world=2, tp=2, direction_tp=True, b=8, n=4000)
    # each model rank held one direction of every recurrent leaf
    assert outs[0]["sharded"]["rnns.1.bi.recurrent_kernel"] == 0
    assert len(outs[0]["sharded"]) == 4 * cfg.hidden_layers


@pytest.mark.parametrize("world,tp", [(4, 4), (4, 2)], ids=["tp4", "dp2xtp2"])
def test_gate_axis_tp_equals_jax_single_device(tmp_path, world, tp):
    """tests/test_tp.py:59's run: the gate axis shards over the model
    ranks, each layer gathers its weights whole."""
    cfg = ModelConfig(n_classes=N_CLASSES, hidden_size=32, hidden_layers=2,
                      compute_dtype="float32")
    outs = _tp_case(tmp_path, cfg, world=world, tp=tp, direction_tp=False, b=8, n=8000)
    assert outs[0]["sharded"]["rnns.0.bi.recurrent_kernel"] == 2
    assert outs[0]["sharded"]["rnns.0.bi.input_bias"] == 1
