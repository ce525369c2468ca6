"""Shared CLI flags (port of ``tpuasr/cli/opts.py``): audio, model,
decoder and runtime flags, plus ``--device``. The decoders are greedy,
``beam`` (the host prefix beam with a word LM), ``beam-native`` (the C++
host beam with a word LM, ``decode/native.py``) and ``beam-device`` (K3,
with a word or char LM)."""

from __future__ import annotations

import argparse
import dataclasses

from tpuasr_torch.audio.frontend import FrontendConfig
from tpuasr_torch.decode.beam import DeviceBeamDecoder
from tpuasr_torch.decode.beam_host import BeamCTCDecoder
from tpuasr_torch.decode.greedy import GreedyDecoder
from tpuasr_torch.decode.lm import load_lm
from tpuasr_torch.device import DEVICES
from tpuasr_torch.labels import Alphabet, load_labels
from tpuasr_torch.model.ds2 import ModelConfig

RNN_IMPL_HELP = ("recurrent kernel (kept in the checkpoint): a GRU runs K1 "
                 "under scan and pallas, K5 (the gate-major BiGRU) under "
                 "pallas2; an LSTM runs K4 under every choice")


def add_audio_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--window-size", type=float, default=0.02,
                   help="window size in seconds")
    p.add_argument("--window-stride", type=float, default=0.01,
                   help="window stride in seconds")
    p.add_argument("--window", default="hamming",
                   choices=["hamming", "hann", "blackman", "bartlett", "rect"])


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--hidden-size", type=int, default=800)
    p.add_argument("--hidden-layers", type=int, default=5)
    p.add_argument("--rnn-type", default="gru", choices=["gru", "lstm", "rnn"])
    p.add_argument("--no-bidirectional", dest="bidirectional",
                   action="store_false", default=True)
    p.add_argument("--lookahead-context", type=int, default=20,
                   help="unidirectional models only: Lookahead layer context frames")
    p.add_argument("--labels-path", default=None,
                   help="JSON list of characters; default PT-BR alphabet")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--rnn-impl", default="scan", choices=["scan", "pallas", "pallas2"],
                   help=RNN_IMPL_HELP)
    p.add_argument("--bn-mask-mode", default="masked",
                   choices=["masked", "reference"],
                   help="masked: BN stats/RNN carries see true lengths "
                   "only (default); reference: padding-inclusive "
                   "reference-family semantics")


def frontend_config_from(args) -> FrontendConfig:
    return FrontendConfig(sample_rate=args.sample_rate, window_size=args.window_size,
                          window_stride=args.window_stride, window=args.window)


def model_config_from(args, alphabet: Alphabet, n_features: int) -> ModelConfig:
    return ModelConfig(
        n_classes=alphabet.size, n_features=n_features,
        hidden_size=args.hidden_size, hidden_layers=args.hidden_layers,
        rnn_type=args.rnn_type, bidirectional=args.bidirectional,
        compute_dtype=args.compute_dtype, rnn_impl=args.rnn_impl,
        bn_mask_mode=args.bn_mask_mode, lookahead_context=args.lookahead_context)


def alphabet_from(args) -> Alphabet:
    return load_labels(args.labels_path)


def add_decoder_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--decoder", default="greedy",
        choices=["greedy", "beam", "beam-device", "beam-native"],
        help="greedy | beam (host Python, word LM) | beam-device (the K3 "
        "kernel on the GPU, word or char LM) | beam-native (host C++, "
        "word LM; --lm-workers threads)",
    )
    p.add_argument("--lm-path", default=None,
                   help="ARPA or binary n-gram LM for beam shallow fusion")
    p.add_argument("--alpha", type=float, default=0.8, help="LM weight")
    p.add_argument("--beta", type=float, default=1.0, help="word bonus")
    p.add_argument("--beam-width", type=int, default=10)
    p.add_argument("--cutoff-top-n", type=int, default=40)
    p.add_argument("--cutoff-prob", type=float, default=1.0)
    p.add_argument("--lm-workers", type=int, default=1)
    p.add_argument(
        "--device-lm-level", default="word", choices=["word", "char"],
        help="beam-device only: fuse --lm-path as a word n-gram "
        "(ctcdecode semantics, default) or a char n-gram",
    )


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="run on the GPU (default; fails without one) or "
                   "on the CPU")


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    """Runtime (non-weight) choices: where to run, and an override of
    the checkpoint's RNN implementation (kernel selection)."""
    p.add_argument("--rnn-impl", default=None,
                   choices=["scan", "pallas", "pallas2"],
                   help="override the checkpoint's RNN implementation: "
                   + RNN_IMPL_HELP)
    add_device_arg(p)


def apply_runtime_overrides(model_cfg: ModelConfig, args) -> ModelConfig:
    """The checkpoint's model config with ``--rnn-impl`` applied."""
    if getattr(args, "rnn_impl", None):
        model_cfg = dataclasses.replace(model_cfg, rnn_impl=args.rnn_impl)
    return model_cfg


def build_decoder(args, alphabet: Alphabet):
    kw = dict(lm_path=args.lm_path, alpha=args.alpha, beta=args.beta,
              beam_width=args.beam_width, cutoff_top_n=args.cutoff_top_n,
              cutoff_prob=args.cutoff_prob)
    if args.decoder == "beam":
        return BeamCTCDecoder(alphabet, **kw)
    if args.decoder == "beam-native":
        from tpuasr_torch.decode.native import NativeBeamDecoder

        return NativeBeamDecoder(alphabet, num_processes=args.lm_workers, **kw)
    if args.decoder == "beam-device":
        lm = load_lm(args.lm_path) if args.lm_path else None
        level = getattr(args, "device_lm_level", "word")
        return DeviceBeamDecoder(
            alphabet, beam_width=args.beam_width,
            char_lm=lm if level == "char" else None,
            word_lm=lm if level == "word" else None,
            alpha=args.alpha, beta=args.beta,
            cutoff_top_n=args.cutoff_top_n, cutoff_prob=args.cutoff_prob,
        )
    return GreedyDecoder(alphabet)
