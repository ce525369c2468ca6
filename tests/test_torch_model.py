"""tpuasr_torch DeepSpeech2 eval logits vs tpuasr's, on one set of
seeded weights (tpuasr_torch.compat.weights.init_variables, a flax-
shaped numpy tree that both packages load).

Tolerances: f32 logits at 2e-4, as tests/test_torch_parity.py holds the
JAX model to its PyTorch reference. bf16 logits at 5e-2 max-abs and
2e-3 mean-abs: the two packages round convs, projections and the
carried GRU state to bf16 (8-bit mantissa) at the same places but sum
in different orders, so single roundings differ by an ulp and the
difference is carried through 2 GRU layers and the head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.ops.gru as jax_gru
from tpuasr.model.ds2 import DeepSpeech2 as JaxDS2
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr_torch.compat.weights import init_variables, model_from_variables
from tpuasr_torch.model.ds2 import ModelConfig, conv_out_lengths

CPU = torch.device("cpu")


def _run_both(cfg: ModelConfig, feats, lengths, rnn_impl="scan"):
    variables = init_variables(cfg, seed=7)
    jcfg = JaxConfig.from_dict(dict(cfg.to_dict(), rnn_impl=rnn_impl))
    lo_j, ol_j = JaxDS2(jcfg).apply(variables, jnp.asarray(feats),
                                    jnp.asarray(lengths), train=False)
    model = model_from_variables(variables, cfg, CPU)
    with torch.inference_mode():
        lo_t, ol_t = model(torch.from_numpy(feats), torch.from_numpy(lengths))
    return (np.asarray(lo_j), np.asarray(ol_j)), (lo_t.numpy(), ol_t.numpy())


def _inputs(seed, b=4, t=37):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, 161).astype(np.float32)
    lengths = np.array([t, 23, 0, 9][:b], np.int32)  # ragged + empty slot
    feats *= (np.arange(t)[None, :, None] < lengths[:, None, None])
    return feats, lengths


@pytest.mark.parametrize("bn_mask_mode", ["masked", "reference"])
def test_logits_match_jax_f32(bn_mask_mode):
    cfg = ModelConfig(hidden_size=24, hidden_layers=2, compute_dtype="float32",
                      bn_mask_mode=bn_mask_mode)
    feats, lengths = _inputs(1)
    (lo_j, ol_j), (lo_t, ol_t) = _run_both(cfg, feats, lengths)
    np.testing.assert_array_equal(ol_t, ol_j)
    np.testing.assert_array_equal(ol_t, conv_out_lengths(lengths))
    assert lo_t.shape == lo_j.shape and lo_t.dtype == np.float32
    np.testing.assert_allclose(lo_t, lo_j, rtol=2e-4, atol=2e-4)


def test_logits_match_jax_pallas_bf16():
    """The flagship numerics: bf16 compute, f32 params, the fused GRU."""
    cfg = ModelConfig(hidden_size=32, hidden_layers=2)
    assert cfg.compute_dtype == "bfloat16"
    feats, lengths = _inputs(2)
    jax_gru.INTERPRET = True
    try:
        (lo_j, ol_j), (lo_t, ol_t) = _run_both(cfg, feats, lengths, "pallas")
    finally:
        jax_gru.INTERPRET = False
    np.testing.assert_array_equal(ol_t, ol_j)
    diff = np.abs(lo_t - lo_j)
    assert diff.max() <= 5e-2 and diff.mean() <= 2e-3, (diff.max(), diff.mean())


def test_config_dict_round_trips_with_jax():
    cfg = ModelConfig(hidden_size=24, compute_dtype="float32", rnn_impl="pallas")
    d = cfg.to_dict()
    assert JaxConfig.from_dict(d).to_dict() == d
    assert ModelConfig.from_dict(JaxConfig(compute_dtype=jnp.bfloat16).to_dict()) \
        == ModelConfig()
    assert jax.numpy.dtype(JaxConfig.from_dict(d).compute_dtype) == jnp.float32
