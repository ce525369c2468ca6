"""Export ``.tpuasr`` checkpoints as reference-family torch ``.pth``
packages (port of ``tpuasr/compat/torch_export.py``).

The inverse of ``compat.torch_import``: the flax-path tree becomes a
``DeepSpeech.serialize()``-shaped package that the reference's
``load_model_package`` loads, so a model moves both ways
(``torch_import``'s docstring lists the layout conventions; this module
applies them in reverse).

Usage:
  python -m tpuasr_torch.compat.torch_export ckpt.tpuasr out.pth
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpuasr_torch.compat.torch_import import _perm
from tpuasr_torch.model.ds2 import ModelConfig
from tpuasr_torch.train.checkpoint import load_checkpoint


def _inv_perm(cfg: ModelConfig) -> np.ndarray:
    """Inverse of the import's conv-flattening row permutation."""
    perm = _perm(cfg)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def export_torch_state_dict(variables: dict, cfg: ModelConfig) -> dict:
    """``{"params", "batch_stats"}`` -> torch-key state_dict of f32 numpy
    arrays (with int64 ``num_batches_tracked`` zeros, so
    ``load_state_dict(strict=True)`` accepts it)."""
    p = variables["params"]
    s = variables["batch_stats"]

    def f32(x):
        return np.asarray(x, np.float32)

    out: dict = {}

    def put_bn(prefix, bn_p, bn_s):
        out[f"{prefix}.weight"] = f32(bn_p["scale"])
        out[f"{prefix}.bias"] = f32(bn_p["bias"])
        out[f"{prefix}.running_mean"] = f32(bn_s["mean"])
        out[f"{prefix}.running_var"] = f32(bn_s["var"])
        out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    for i, conv_idx in enumerate((0, 3)):
        k = f32(p[f"conv{i}"]["Conv_0"]["kernel"])  # (kT, kF, in, out)
        out[f"conv.seq_module.{conv_idx}.weight"] = k.transpose(3, 2, 1, 0)
        put_bn(f"conv.seq_module.{conv_idx + 1}", p[f"conv{i}"]["MaskedBatchNorm_0"],
               s[f"conv{i}"]["MaskedBatchNorm_0"])

    inv = _inv_perm(cfg)

    def unfix_l0(w, layer):  # (H_in, G*H) rows back to torch's order
        return w[inv] if layer == 0 else w

    for i in range(cfg.hidden_layers):
        lp = p[f"rnn{i}"]
        rnn = f"rnns.{i}.rnn"
        if "MaskedBatchNorm_0" in lp:
            put_bn(f"rnns.{i}.batch_norm.module", lp["MaskedBatchNorm_0"],
                   s[f"rnn{i}"]["MaskedBatchNorm_0"])
        if cfg.bidirectional:
            bi = lp["bi"]
            for d, side in enumerate(("", "_reverse")):
                out[f"{rnn}.weight_ih_l0{side}"] = unfix_l0(f32(bi["input_kernel"][d]), i).T
                out[f"{rnn}.weight_hh_l0{side}"] = f32(bi["recurrent_kernel"][d]).T
                out[f"{rnn}.bias_ih_l0{side}"] = f32(bi["input_bias"][d])
                out[f"{rnn}.bias_hh_l0{side}"] = f32(bi["recurrent_bias"][d])
        else:
            fwd = lp["fwd"]
            out[f"{rnn}.weight_ih_l0"] = unfix_l0(f32(fwd["input_proj"]["kernel"]), i).T
            out[f"{rnn}.bias_ih_l0"] = f32(fwd["input_proj"]["bias"])
            out[f"{rnn}.weight_hh_l0"] = f32(fwd["recurrent_kernel"]).T
            out[f"{rnn}.bias_hh_l0"] = f32(fwd["recurrent_bias"])

    if not cfg.bidirectional and "lookahead" in p:
        k = f32(p["lookahead"]["Conv_0"]["kernel"])  # (K, 1, H)
        out["lookahead.0.weight"] = k.transpose(2, 1, 0)

    put_bn("fc.0.module.0", p["head_bn"], s["head_bn"])
    out["fc.0.module.1.weight"] = f32(p["head"]["kernel"]).T
    return out


def save_torch_package(pkg, path: str) -> None:
    """``CheckpointPackage`` -> reference-family ``.pth`` file (torch
    tensors; hyperparameters, labels, audio_conf and the histories)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v).copy())
          for k, v in export_torch_state_dict(pkg.variables, pkg.model_config).items()}
    fc = pkg.frontend_config
    torch.save({
        "hidden_size": pkg.model_config.hidden_size,
        "hidden_layers": pkg.model_config.hidden_layers,
        "rnn_type": pkg.model_config.rnn_type,
        "bidirectional": pkg.model_config.bidirectional,
        "labels": list(pkg.labels),
        "audio_conf": {
            "sample_rate": fc.sample_rate,
            "window_size": fc.window_size,
            "window_stride": fc.window_stride,
            "window": fc.window,
        },
        "state_dict": sd,
        "epoch": pkg.epoch,
        "loss_results": list(pkg.loss_history),
        "wer_results": list(pkg.wer_history),
        "cer_results": list(pkg.cer_history),
    }, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="export a .tpuasr checkpoint as a reference-family .pth package")
    p.add_argument("checkpoint")
    p.add_argument("out_pth")
    args = p.parse_args(argv)
    save_torch_package(load_checkpoint(args.checkpoint), args.out_pth)
    print(f"wrote {args.out_pth}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
