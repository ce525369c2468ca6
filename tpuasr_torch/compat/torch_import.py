"""Import deepspeech.pytorch-family checkpoints (port of
``tpuasr/compat/torch_import.py``).

The reference's ``.pth`` package stores a torch ``state_dict`` of its
DeepSpeech model. ``import_torch_state_dict`` maps those tensors onto
the flax-path tree of numpy arrays that a ``.tpuasr`` checkpoint holds
(``{"params", "batch_stats"}``, the same tree the JAX package's import
returns), which ``compat.weights.model_from_variables`` loads into the
port's ``DeepSpeech2``; ``load_torch_package`` reads a whole package
into a ``CheckpointPackage`` that the service, ``cli.test`` and
``cli.transcribe`` serve.

Layout conventions (torch -> flax tree):
  * Conv2d ``(out, in, kF, kT)`` over (freq, time) -> HWIO with
    time-major spatial dims ``(kT, kF, in, out)``.
  * GRU/LSTM/RNN ``weight_ih_l0 (G*H, H_in)`` -> ``(H_in, G*H)`` (the
    gate orders r,z,n / i,f,g,o are the same: both follow cuDNN). A
    bidirectional layer stacks the forward and reverse directions on a
    leading axis (``rnn{i}/bi``); a unidirectional one keeps
    ``rnn{i}/fwd/input_proj`` and ``recurrent_{kernel,bias}``.
  * The first RNN layer's input rows: torch flattens the conv output
    channel-major (``c*F' + f``), the tree feature-major (``f*C + c``).
  * BatchNorm {weight, bias, running_mean, running_var} ->
    {scale, bias} params + {mean, var} batch_stats.
  * Lookahead ``(H, 1, K)`` grouped conv -> ``lookahead/Conv_0/kernel``
    ``(K, 1, H)``.

Torch key names (the deepspeech.pytorch family):
  conv.seq_module.{0,3}.*           conv layers
  conv.seq_module.{1,4}.*           conv batch norms
  rnns.{i}.batch_norm.module.*      pre-RNN sequence-wise BN (i >= 1)
  rnns.{i}.rnn.{weight,bias}_{ih,hh}_l0[_reverse]
  lookahead.0.weight                Lookahead (unidirectional models)
  fc.0.module.0.*                   head BN
  fc.0.module.1.weight              head Linear (C, H)
Keys left unmapped are returned, not dropped silently.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.model.ds2 import ModelConfig, conv_out_features
from tpuasr_torch.train.checkpoint import CheckpointPackage


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    # a copy: torch optimizers update parameters in place and
    # tensor.numpy() shares memory, so the tree must be a snapshot
    return np.array(x, dtype=np.float32, copy=True)


def _perm(cfg: ModelConfig) -> np.ndarray:
    """Row ``f*C + c`` of the tree's first RNN input kernel reads torch's
    row ``c*F' + f``."""
    ch = cfg.conv_channels
    f_out = conv_out_features(cfg.n_features, ch) // ch
    return np.array([c * f_out + f for f in range(f_out) for c in range(ch)], np.int64)


def import_torch_state_dict(state_dict: dict, cfg: ModelConfig) -> tuple[dict, list]:
    """torch state_dict (tensors or arrays) -> (``{"params",
    "batch_stats"}``, unused keys)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    used = set()

    def take(key):
        used.add(key)
        return sd[key]

    params: dict = {}
    stats: dict = {}

    def bn(prefix):
        return ({"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")},
                {"mean": take(f"{prefix}.running_mean"), "var": take(f"{prefix}.running_var")})

    for i, conv_idx in enumerate((0, 3)):
        w = take(f"conv.seq_module.{conv_idx}.weight")  # (out, in, kF, kT)
        bp, bs = bn(f"conv.seq_module.{conv_idx + 1}")
        params[f"conv{i}"] = {"Conv_0": {"kernel": w.transpose(3, 2, 1, 0)},
                              "MaskedBatchNorm_0": bp}
        stats[f"conv{i}"] = {"MaskedBatchNorm_0": bs}

    perm = _perm(cfg)

    def fix_l0(w_ih_t, layer):  # (H_in, G*H), already transposed
        return w_ih_t[perm] if layer == 0 else w_ih_t

    for i in range(cfg.hidden_layers):
        layer_p: dict = {}
        bn_key = f"rnns.{i}.batch_norm.module"
        if f"{bn_key}.weight" in sd:
            layer_p["MaskedBatchNorm_0"], bs = bn(bn_key)
            stats[f"rnn{i}"] = {"MaskedBatchNorm_0": bs}
        rnn = f"rnns.{i}.rnn"
        if cfg.bidirectional:
            sides = ("", "_reverse")
            layer_p["bi"] = {
                "input_kernel": np.stack([fix_l0(take(f"{rnn}.weight_ih_l0{d}").T, i)
                                          for d in sides]),
                "input_bias": np.stack([take(f"{rnn}.bias_ih_l0{d}") for d in sides]),
                "recurrent_kernel": np.stack([take(f"{rnn}.weight_hh_l0{d}").T
                                              for d in sides]),
                "recurrent_bias": np.stack([take(f"{rnn}.bias_hh_l0{d}") for d in sides]),
            }
        else:
            layer_p["fwd"] = {
                "input_proj": {"kernel": fix_l0(take(f"{rnn}.weight_ih_l0").T, i),
                               "bias": take(f"{rnn}.bias_ih_l0")},
                "recurrent_kernel": take(f"{rnn}.weight_hh_l0").T,
                "recurrent_bias": take(f"{rnn}.bias_hh_l0"),
            }
        params[f"rnn{i}"] = layer_p

    if not cfg.bidirectional:
        for key in ("lookahead.0.weight", "lookahead.weight"):
            if key in sd:
                w = take(key)
                if w.ndim == 2:  # the older Parameter layout (H, K)
                    w = w[:, None, :]
                params["lookahead"] = {"Conv_0": {"kernel": w.transpose(2, 1, 0)}}
                break

    params["head_bn"], stats["head_bn"] = bn("fc.0.module.0")
    params["head"] = {"kernel": take("fc.0.module.1.weight").T}

    unused = [k for k in sd if k not in used and not k.endswith("num_batches_tracked")]
    return {"params": params, "batch_stats": stats}, unused


def load_torch_package(path: str):
    """A reference-family ``.pth`` package (hyperparameters, labels,
    audio_conf and state_dict) -> the port's ``CheckpointPackage``.
    ``rnn_type`` and ``bidirectional`` come from the package, a
    unidirectional model's lookahead width from its weights; unmapped
    keys raise ``ValueError``."""
    pkg = torch.load(path, map_location="cpu", weights_only=False)
    labels = pkg.get("labels")
    if isinstance(labels, (list, tuple)):
        labels = "".join(labels)
    audio_conf = pkg.get("audio_conf", {})
    frontend_cfg = FrontendConfig(
        sample_rate=int(audio_conf.get("sample_rate", 16000)),
        window_size=float(audio_conf.get("window_size", 0.02)),
        window_stride=float(audio_conf.get("window_stride", 0.01)),
        window=str(audio_conf.get("window", "hamming")),
    )
    bidirectional = bool(pkg.get("bidirectional", True))
    lookahead_context = 20
    if not bidirectional:
        for key in ("lookahead.0.weight", "lookahead.weight"):
            if key in pkg["state_dict"]:
                lookahead_context = int(pkg["state_dict"][key].shape[-1])
                break
        else:
            lookahead_context = 0
    model_cfg = ModelConfig(
        n_classes=len(labels),
        n_features=frontend_cfg.n_features,
        hidden_size=int(pkg.get("hidden_size", 800)),
        hidden_layers=int(pkg.get("hidden_layers", 5)),
        rnn_type=str(pkg.get("rnn_type", "gru")).lower(),
        bidirectional=bidirectional,
        lookahead_context=lookahead_context,
    )
    variables, unused = import_torch_state_dict(pkg["state_dict"], model_cfg)
    if unused:
        raise ValueError(f"unmapped torch keys: {unused[:8]}...")
    return CheckpointPackage(
        model_config=model_cfg,
        frontend_config=frontend_cfg,
        labels=labels,
        variables=variables,
        epoch=int(pkg.get("epoch", 0)),
        loss_history=[float(x) for x in np.atleast_1d(
            np.asarray(pkg.get("loss_results", []), dtype=np.float64)) if np.isfinite(x)],
    )
