"""Reference ``.pth`` import and export in the port
(``tpuasr_torch/compat/torch_import.py``, ``torch_export.py``) vs a
PyTorch model of the reference family and vs tpuasr's compat modules,
on the CPU: B=1 logits at 2e-4 (as ``tests/test_torch_parity.py`` holds
tpuasr to the same architecture), equal trees from one state_dict,
packages written by one package read by the other, the export round
trip at rtol 1e-6 / atol 1e-7, and the export CLI.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.compat import torch_export as jexport
from tpuasr.compat import torch_import as jimport
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr.train.checkpoint import CheckpointPackage as JaxPackage
from tpuasr.train.checkpoint import save_checkpoint as jax_save
from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.compat import torch_export, torch_import
from tpuasr_torch.compat.weights import init_variables, model_from_variables
from tpuasr_torch.model.ds2 import ModelConfig
from tpuasr_torch.train.checkpoint import CheckpointPackage

CPU = torch.device("cpu")


# The reference family's DeepSpeech, written from its spec (a copy of
# tests/test_torch_parity.py's, with the LSTM and vanilla RNN cells).

class _SeqWrap(tnn.Module):
    def __init__(self, module):
        super().__init__()
        self.module = module


class _MaskConvNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.seq_module = tnn.Sequential(
            tnn.Conv2d(1, 32, (41, 11), stride=(2, 2), padding=(20, 5), bias=False),
            tnn.BatchNorm2d(32),
            tnn.Hardtanh(0, 20, inplace=False),
            tnn.Conv2d(32, 32, (21, 11), stride=(2, 1), padding=(10, 5), bias=False),
            tnn.BatchNorm2d(32),
            tnn.Hardtanh(0, 20, inplace=False),
        )

    def forward(self, x):
        return self.seq_module(x)


RNN_CELLS = {"gru": tnn.GRU, "lstm": tnn.LSTM, "rnn": tnn.RNN}


class _BatchRNN(tnn.Module):
    def __init__(self, in_size, hidden, batch_norm, bidirectional=True, rnn_type="gru"):
        super().__init__()
        self.batch_norm = _SeqWrap(tnn.BatchNorm1d(in_size)) if batch_norm else None
        self.bidirectional = bidirectional
        self.rnn = RNN_CELLS[rnn_type](in_size, hidden, bidirectional=bidirectional, bias=True)

    def forward(self, x):  # x: (T, B, H_in)
        if self.batch_norm is not None:
            t, b, h = x.shape
            x = self.batch_norm.module(x.reshape(t * b, h)).reshape(t, b, h)
        x, _ = self.rnn(x)
        if self.bidirectional:
            t, b, h2 = x.shape
            x = x.view(t, b, 2, h2 // 2).sum(2)  # direction-sum
        return x


class _Lookahead(tnn.Module):
    """Per-feature convolution over the current and next context-1
    frames; weight key 'lookahead.0.weight' (grouped-conv layout
    (H, 1, K))."""

    def __init__(self, h, context):
        super().__init__()
        self.context = context
        self.weight = tnn.Parameter(torch.randn(h, 1, context) * 0.1)

    def forward(self, x):  # (T, B, H)
        x = x.permute(1, 2, 0)  # (B, H, T)
        x = torch.nn.functional.pad(x, (0, self.context - 1))
        x = torch.nn.functional.conv1d(x, self.weight, groups=x.shape[1])
        return x.permute(2, 0, 1)


class _TorchDS2(tnn.Module):
    def __init__(self, n_feat=161, hidden=32, layers=2, n_class=10,
                 bidirectional=True, lookahead_context=0, rnn_type="gru"):
        super().__init__()
        self.conv = _MaskConvNet()
        f_out = ((n_feat + 2 * 20 - 41) // 2 + 1)
        f_out = (f_out + 2 * 10 - 21) // 2 + 1
        in_size = f_out * 32
        self.rnns = tnn.ModuleList([
            _BatchRNN(in_size if i == 0 else hidden, hidden, batch_norm=(i > 0),
                      bidirectional=bidirectional, rnn_type=rnn_type)
            for i in range(layers)])
        if not bidirectional and lookahead_context > 0:
            self.lookahead = tnn.Sequential(_Lookahead(hidden, lookahead_context),
                                            tnn.Hardtanh(0, 20, inplace=False))
        else:
            self.lookahead = None
        self.fc = tnn.ModuleList([_SeqWrap(tnn.Sequential(
            tnn.BatchNorm1d(hidden), tnn.Linear(hidden, n_class, bias=False)))])

    def forward(self, spect):  # (B, 1, F, T)
        x = self.conv(spect)
        b, c, f, t = x.shape
        x = x.view(b, c * f, t).permute(2, 0, 1)  # (T, B, C*F)
        for rnn in self.rnns:
            x = rnn(x)
        if self.lookahead is not None:
            x = self.lookahead(x)
        t, b, h = x.shape
        x = self.fc[0].module(x.reshape(t * b, h)).reshape(t, b, -1)
        return x.transpose(0, 1)  # (B, T, C) raw logits


# rnn_type, bidirectional, lookahead context
MODELS = {"bi-gru": ("gru", True, 0), "bi-lstm": ("lstm", True, 0),
          "uni-gru-lookahead": ("gru", False, 5), "bi-rnn": ("rnn", True, 0)}
LABELS = "_ABCDEFGH "


def _reference(name, seed=0):
    rnn_type, bi, ctx = MODELS[name]
    torch.manual_seed(seed)
    tm = _TorchDS2(hidden=32, layers=2, n_class=10, bidirectional=bi,
                   lookahead_context=ctx, rnn_type=rnn_type).eval()
    with torch.no_grad():  # random running statistics: eval BN is not trivial
        for m in tm.modules():
            if isinstance(m, (tnn.BatchNorm1d, tnn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    cfg = ModelConfig(n_classes=10, hidden_size=32, hidden_layers=2, rnn_type=rnn_type,
                      bidirectional=bi, lookahead_context=ctx, compute_dtype="float32")
    return tm, cfg


def _logits(model_or_ref, feats):
    with torch.inference_mode():
        if isinstance(model_or_ref, _TorchDS2):
            return model_or_ref(torch.from_numpy(feats.transpose(0, 2, 1))[:, None]).numpy()
        out, out_len = model_or_ref(torch.from_numpy(feats),
                                    torch.tensor([feats.shape[1]], dtype=torch.int32))
        return out[:, :int(out_len[0])].numpy()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_tree(a, b, **tol):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].shape == lb[k].shape, k
        if tol:
            np.testing.assert_allclose(la[k], lb[k], err_msg=str(k), **tol)
        else:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("t_in", [40, 37])
def test_logits_match_the_torch_reference(name, t_in):
    """B=1, eval mode: the port's model on the imported tree gives the
    reference's logits."""
    tm, cfg = _reference(name)
    variables, unused = torch_import.import_torch_state_dict(tm.state_dict(), cfg)
    assert unused == []
    feats = np.random.RandomState(1).randn(1, t_in, 161).astype(np.float32)
    ref = _logits(tm, feats)
    ours = _logits(model_from_variables(variables, cfg, CPU), feats)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(MODELS))
def test_import_equals_tpuasr(name):
    """One state_dict: the port's import and tpuasr's give equal trees."""
    tm, cfg = _reference(name, seed=3)
    sd = dict(tm.state_dict(), **{"extra.weight": torch.zeros(2)})
    ours, unused = torch_import.import_torch_state_dict(sd, cfg)
    theirs, j_unused = jimport.import_torch_state_dict(sd, JaxConfig.from_dict(cfg.to_dict()))
    assert unused == j_unused == ["extra.weight"]
    _assert_same_tree(ours, theirs)
    # a snapshot, not a view of the torch model's parameters
    head = tm.fc[0].module[1].weight
    before = head.detach().numpy().T.copy()
    with torch.no_grad():
        head.add_(1.0)
    np.testing.assert_array_equal(ours["params"]["head"]["kernel"], before)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_packages_cross_between_the_packages(tmp_path, bidirectional):
    """A ``.pth`` that tpuasr's ``save_torch_package`` wrote loads in the
    port, and one the port wrote loads in tpuasr, with the same config,
    labels, epoch, histories and weights."""
    cfg = ModelConfig(n_classes=len(LABELS), hidden_size=32, hidden_layers=2,
                      rnn_type="lstm" if bidirectional else "gru",
                      bidirectional=bidirectional, lookahead_context=6,
                      compute_dtype="float32")
    variables = init_variables(cfg, seed=2)
    hist = dict(epoch=4, loss_history=[3.0, 2.5], wer_history=[90.0, 80.0],
                cer_history=[50.0, 40.0])
    jpkg = JaxPackage(model_config=JaxConfig.from_dict(cfg.to_dict()),
                      frontend_config=JaxFrontendConfig(), labels=LABELS,
                      variables=variables, **hist)
    pkg = CheckpointPackage(model_config=cfg, frontend_config=FrontendConfig(),
                            labels=LABELS, variables=variables, **hist)
    jexport.save_torch_package(jpkg, str(tmp_path / "j.pth"))
    torch_export.save_torch_package(pkg, str(tmp_path / "t.pth"))
    blobs = [torch.load(str(tmp_path / f), map_location="cpu", weights_only=False)
             for f in ("j.pth", "t.pth")]
    assert sorted(blobs[0]) == sorted(blobs[1])
    for k in blobs[0]:
        if k != "state_dict":
            assert blobs[0][k] == blobs[1][k], k
    assert sorted(blobs[0]["state_dict"]) == sorted(blobs[1]["state_dict"])
    for k, v in blobs[0]["state_dict"].items():
        assert torch.equal(v, blobs[1]["state_dict"][k]), k

    got = torch_import.load_torch_package(str(tmp_path / "j.pth"))
    want = jimport.load_torch_package(str(tmp_path / "t.pth"))
    assert got.model_config.to_dict() == want.model_config.to_dict()
    assert (got.model_config.rnn_type, got.model_config.bidirectional) == (
        cfg.rnn_type, bidirectional)
    assert got.model_config.lookahead_context == (20 if bidirectional else 6)
    assert (got.labels, got.epoch, got.loss_history) == (want.labels, want.epoch,
                                                         want.loss_history)
    _assert_same_tree(got.variables, want.variables)
    _assert_same_tree(got.variables, variables)


@pytest.mark.parametrize("name", ["bi-gru", "uni-gru-lookahead"])
def test_export_round_trip(tmp_path, name):
    """``save_torch_package`` writes a ``.pth`` that loads strictly into
    the reference model with the port's logits, and comes back through
    ``load_torch_package`` at rtol 1e-6 / atol 1e-7."""
    _, cfg = _reference(name)
    variables = init_variables(cfg, seed=4)
    pkg = CheckpointPackage(model_config=cfg, frontend_config=FrontendConfig(),
                            labels=LABELS, variables=variables, epoch=3,
                            loss_history=[2.0, 1.0])
    pth = str(tmp_path / "exported.pth")
    torch_export.save_torch_package(pkg, pth)
    blob = torch.load(pth, map_location="cpu", weights_only=False)
    rnn_type, bi, ctx = MODELS[name]
    tm = _TorchDS2(hidden=32, layers=2, n_class=10, bidirectional=bi,
                   lookahead_context=ctx, rnn_type=rnn_type)
    tm.load_state_dict(blob["state_dict"], strict=True)
    feats = np.random.RandomState(6).randn(1, 40, 161).astype(np.float32)
    np.testing.assert_allclose(_logits(model_from_variables(variables, cfg, CPU), feats),
                               _logits(tm.eval(), feats), rtol=2e-4, atol=2e-4)
    back = torch_import.load_torch_package(pth)
    assert back.epoch == 3 and back.labels == LABELS and back.loss_history == [2.0, 1.0]
    _assert_same_tree(back.variables, variables, rtol=1e-6, atol=1e-7)


def test_unmapped_keys_raise(tmp_path):
    tm, cfg = _reference("bi-gru")
    sd = dict(tm.state_dict(), **{"decoder.weight": torch.zeros(3)})
    pth = str(tmp_path / "extra.pth")
    torch.save({"hidden_size": 32, "hidden_layers": 2, "rnn_type": "gru",
                "bidirectional": True, "labels": list(LABELS), "state_dict": sd}, pth)
    with pytest.raises(ValueError, match="unmapped torch keys.*decoder.weight"):
        torch_import.load_torch_package(pth)


def test_export_cli_matches_tpuasr(tmp_path, capsys):
    """``python -m tpuasr_torch.compat.torch_export ckpt out.pth`` prints
    tpuasr's line and writes tpuasr's state_dict."""
    cfg = ModelConfig(n_classes=len(LABELS), hidden_size=16, hidden_layers=2,
                      compute_dtype="float32")
    ckpt = str(tmp_path / "m.ckpt")
    jax_save(ckpt, JaxPackage(model_config=JaxConfig.from_dict(cfg.to_dict()),
                              frontend_config=JaxFrontendConfig(), labels=LABELS,
                              variables=init_variables(cfg, seed=5), epoch=2))
    out = str(tmp_path / "out.pth")
    assert jexport.main([ckpt, out]) == 0
    want_line = capsys.readouterr().out
    want = torch.load(out, map_location="cpu", weights_only=False)
    proc = subprocess.run([sys.executable, "-m", "tpuasr_torch.compat.torch_export", ckpt, out],
                          capture_output=True, text=True, check=True)
    assert proc.stdout == want_line == f"wrote {out}\n"
    got = torch.load(out, map_location="cpu", weights_only=False)
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    assert {k: v for k, v in got.items() if k != "state_dict"} == \
        {k: v for k, v in want.items() if k != "state_dict"}
