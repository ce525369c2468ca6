"""The port's BiLSTM model (rnn_type="lstm", K4) and gate-major BiGRU
(rnn_type="gru", rnn_impl="pallas2", K5) against tpuasr's, on one set
of seeded weights: eval logits, the kernel dispatch, the weight tree,
.tpuasr checkpoints in both directions, and the train and transcribe
CLIs on the CPU (one train step: test_torch_rnn_train_step.py).

Tolerances, as for the GRU flagship (test_torch_model.py): f32 logits
2e-4 against the JAX scan path; bf16 logits 5e-2 max-abs and 2e-3
mean-abs against the JAX Pallas kernels in interpreter mode (both
packages round convs, projections and the carried h to bf16 at the same
places but sum in other orders).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.ops.gru2 as jax_gru2
import tpuasr.ops.lstm as jax_lstm
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.model.ds2 import DeepSpeech2 as JaxDS2
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr.train import checkpoint as jax_ckpt
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.cli import synth_corpus
from tpuasr_torch.compat.weights import (
    init_train_variables,
    init_variables,
    model_from_variables,
)
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model import ds2
from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.ops import gru2 as gru2_mod
from tpuasr_torch.ops import lstm as lstm_mod
from tpuasr_torch.serve import TranscriptionService
from tpuasr_torch.train import checkpoint as ckpt

CPU = torch.device("cpu")
VARIANTS = [pytest.param("lstm", "pallas", id="lstm"),
            pytest.param("gru", "pallas2", id="gru-pallas2")]


@pytest.fixture
def interpret_mode():
    jax_lstm.INTERPRET = jax_gru2.INTERPRET = True
    yield
    jax_lstm.INTERPRET = jax_gru2.INTERPRET = False


def _feats(seed, b=4, t=37):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, 161).astype(np.float32)
    lengths = np.array([t, 23, 0, 9][:b], np.int32)  # ragged + empty slot
    feats *= (np.arange(t)[None, :, None] < lengths[:, None, None])
    return feats, lengths


def _logits_both(cfg, jax_impl, seed):
    variables = init_variables(cfg, seed=7)
    feats, lengths = _feats(seed)
    jcfg = JaxConfig.from_dict(dict(cfg.to_dict(), rnn_impl=jax_impl))
    lo_j, ol_j = JaxDS2(jcfg).apply(variables, jnp.asarray(feats), jnp.asarray(lengths),
                                    train=False)
    model = model_from_variables(variables, cfg, CPU)
    with torch.inference_mode():
        lo_t, ol_t = model(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    assert lo_t.shape == lo_j.shape and lo_t.dtype == torch.float32
    return lo_t.numpy(), np.asarray(lo_j)


@pytest.mark.parametrize("rnn_type,rnn_impl", VARIANTS)
def test_logits_match_jax_scan_f32(rnn_type, rnn_impl):
    cfg = ModelConfig(hidden_size=24, hidden_layers=2, compute_dtype="float32",
                      rnn_type=rnn_type, rnn_impl=rnn_impl)
    lo_t, lo_j = _logits_both(cfg, "scan", seed=1)
    np.testing.assert_allclose(lo_t, lo_j, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rnn_type,rnn_impl", VARIANTS)
def test_logits_match_jax_kernels_bf16(rnn_type, rnn_impl, interpret_mode):
    """The flagship numerics: bf16 compute, f32 params, the fused loop
    (JAX: bilstm_pallas for the LSTM, bigru_pallas2 for pallas2)."""
    cfg = ModelConfig(hidden_size=32, hidden_layers=2, rnn_type=rnn_type,
                      rnn_impl=rnn_impl)
    lo_t, lo_j = _logits_both(cfg, rnn_impl, seed=2)
    diff = np.abs(lo_t - lo_j)
    assert diff.max() <= 5e-2 and diff.mean() <= 2e-3, (diff.max(), diff.mean())


CFG = dict(n_classes=12, hidden_size=16, hidden_layers=2, conv_channels=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("rnn_type,rnn_impl,kernel", [
    ("gru", "scan", "bigru"), ("gru", "pallas", "bigru"), ("gru", "pallas2", "bigru2"),
    ("lstm", "scan", "bilstm"), ("lstm", "pallas2", "bilstm"),
])
def test_model_dispatches_to_its_kernel(rnn_type, rnn_impl, kernel, monkeypatch):
    """Inference calls the forward wrapper that ds2 imported; training
    calls the autograd function's forward and backward wrappers."""
    calls = []

    def spy(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a: calls.append(name) or fn(*a))

    for mod in (ds2, gru_mod, gru2_mod, lstm_mod):
        for name in ("bigru_forward", "bigru2_forward", "bilstm_forward",
                     "bigru_backward", "bigru2_backward", "bilstm_backward"):
            if hasattr(mod, name):
                spy(mod, name)
    cfg = ModelConfig(hidden_size=8, hidden_layers=1, rnn_type=rnn_type, rnn_impl=rnn_impl)
    model = model_from_variables(init_variables(cfg, seed=0), cfg, CPU, trainable=True)
    feats, lengths = _feats(3, t=21)
    with torch.no_grad():
        model(torch.from_numpy(feats), torch.from_numpy(lengths))
    assert calls == [f"{kernel}_forward"]
    logits, _ = model(torch.from_numpy(feats), torch.from_numpy(lengths), train=True)
    logits.sum().backward()
    assert calls == [f"{kernel}_forward"] * 2 + [f"{kernel}_backward"]


def test_lstm_weight_tree_matches_flax_init():
    cfg = ModelConfig(rnn_type="lstm", **CFG)
    jcfg = JaxConfig(rnn_type="lstm", **CFG)
    flax_vars = flax.serialization.to_state_dict(jax.tree.map(
        np.asarray, JaxDS2(jcfg).init_variables(jax.random.PRNGKey(0), t_max=32)))
    ours = init_train_variables(cfg, seed=0)
    assert ({k: a.shape for k, a in _flat(ours).items()}
            == {k: a.shape for k, a in _flat(flax_vars).items()})
    assert ours["params"]["rnn1"]["bi"]["recurrent_kernel"].shape == (2, 16, 64)
    assert DeepSpeech2(cfg).rnns[0].bi.input_kernel.shape[-1] == 4 * 16


LSTM_CFG = ModelConfig(hidden_size=16, hidden_layers=2, compute_dtype="float32",
                       rnn_type="lstm")


def _wav(path, seconds, seed):
    rng = np.random.RandomState(seed)
    wavfile.write(path, 16000, (rng.randn(int(16000 * seconds)) * 3000).astype(np.int16))
    return path


def test_jax_written_lstm_checkpoint_transcribes_in_the_port(tmp_path, capsys):
    from tpuasr.cli.transcribe import main as jax_main
    from tpuasr_torch.cli.transcribe import main

    path = str(tmp_path / "j.ckpt")
    jax_ckpt.save_checkpoint(path, jax_ckpt.CheckpointPackage(
        model_config=JaxConfig.from_dict(LSTM_CFG.to_dict()),
        frontend_config=JaxFrontendConfig(), labels=Alphabet().labels,
        variables=init_variables(LSTM_CFG, seed=4)))
    args = ["--model-path", path, "--audio-path", _wav(str(tmp_path / "u.wav"), 1.3, 0),
            "--offsets"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert ckpt.load_checkpoint(path).model_config == LSTM_CFG


def test_port_written_lstm_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "p.ckpt")
    variables = init_variables(LSTM_CFG, seed=5)
    ckpt.save_checkpoint(path, ckpt.CheckpointPackage(
        model_config=LSTM_CFG, frontend_config=FrontendConfig(),
        labels=Alphabet().labels, variables=variables))
    pkg = jax_ckpt.load_checkpoint(path)
    assert pkg.model_config.rnn_type == "lstm"
    feats, lengths = _feats(6)
    lo_j, _ = JaxDS2(pkg.model_config).apply(pkg.variables, jnp.asarray(feats),
                                             jnp.asarray(lengths), train=False)
    model = model_from_variables(ckpt.load_checkpoint(path).variables, LSTM_CFG, CPU)
    with torch.inference_mode():
        lo_t, _ = model(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), rtol=2e-4, atol=2e-4)


def test_cli_trains_an_lstm_and_transcribes_it_on_the_cpu(tmp_path, capsys):
    from tpuasr_torch.cli import train as train_cli
    from tpuasr_torch.cli import transcribe

    corpus = synth_corpus.generate(str(tmp_path / "corpus"), 8, 1.0, 0.25, seed=3)
    out = tmp_path / "m"
    assert train_cli.main([
        "--train-manifest", corpus["train"], "--val-manifest", corpus["val"],
        "--hidden-size", "16", "--hidden-layers", "2", "--compute-dtype", "float32",
        "--rnn-type", "lstm", "--batch-size", "3", "--epochs", "1", "--quiet",
        "--checkpoint", "--save-folder", str(out), "--model-path", str(out / "best.ckpt"),
        "--device", "cpu"]) == 0
    pkg = ckpt.load_checkpoint(str(out / "tpuasr_1.ckpt"))
    assert pkg.model_config.rnn_type == "lstm" and pkg.epoch == 1
    assert np.isfinite(pkg.loss_history).all()
    wav = open(corpus["val"]).read().splitlines()[0].split(",")[0]
    capsys.readouterr()
    assert transcribe.main(["--model-path", str(out / "tpuasr_1.ckpt"),
                            "--audio-path", wav, "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1


def test_runtime_rnn_impl_override_selects_k5(tmp_path, capsys, monkeypatch):
    """``--rnn-impl pallas2`` runs a GRU checkpoint through K5 and prints
    what K1 prints (the same math in f32)."""
    from tpuasr_torch.cli import transcribe

    cfg = ModelConfig(hidden_size=16, hidden_layers=2, compute_dtype="float32")
    path = str(tmp_path / "g.ckpt")
    ckpt.save_checkpoint(path, ckpt.CheckpointPackage(
        model_config=cfg, frontend_config=FrontendConfig(), labels=Alphabet().labels,
        variables=init_variables(cfg, seed=6)))
    args = ["--model-path", path, "--audio-path", _wav(str(tmp_path / "u.wav"), 1.1, 1),
            "--offsets", "--device", "cpu"]
    calls = []
    for name in ("bigru_forward", "bigru2_forward"):
        fn = getattr(ds2, name)
        monkeypatch.setattr(ds2, name, lambda *a, n=name, f=fn: calls.append(n) or f(*a))
    assert transcribe.main(args) == 0
    want = capsys.readouterr().out
    assert set(calls) == {"bigru_forward"}
    calls.clear()
    assert transcribe.main(args + ["--rnn-impl", "pallas2"]) == 0
    assert capsys.readouterr().out == want
    assert set(calls) == {"bigru2_forward"}
    svc = TranscriptionService(path, device="cpu", rnn_impl="pallas2")  # cli.serve's
    try:
        assert svc.model.config.rnn_impl == "pallas2" and svc.model.rnns[0].bi.gate_major
    finally:
        svc.close()
