"""Transcribe one WAV file (port of ``tpuasr/cli/transcribe.py``).

Usage:
  python -m tpuasr_torch.cli.transcribe --model-path m.ckpt \
      --audio-path x.wav [--offsets] [--device cuda|cpu] \
      [--decoder beam-device --lm-path lm.arpa --n-best 3]
  python -m tpuasr_torch.cli.transcribe --model-path uni.ckpt \
      --audio-path x.wav --streaming [--chunk-frames 32] \
      [--decoder beam --lm-path lm.arpa --beam-impl auto|host|device]

Audio past the bucket ladder decodes long-form (overlapping chunks, host
decode: the host beam for every beam decoder), printing the best text.
``--streaming`` (unidirectional checkpoints) feeds the wave in blocks of
``chunk_frames * hop`` samples through ``tpuasr_torch.stream``'s
stateful step, printing fragments as they finalize.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tpuasr_torch.audio.frontend import corpus_feature_stats
from tpuasr_torch.audio.io import load_audio
from tpuasr_torch.cli.opts import (
    add_decoder_args,
    add_runtime_args,
    apply_runtime_overrides,
    build_decoder,
)
from tpuasr_torch.compat.weights import model_from_variables
from tpuasr_torch.data.buckets import BucketSpec
from tpuasr_torch.decode.lm import load_lm
from tpuasr_torch.decode.longform import (
    pad_to_ladder,
    samples_per_frame,
    transcribe_longform,
)
from tpuasr_torch.device import resolve_device
from tpuasr_torch.train.checkpoint import load_checkpoint
from tpuasr_torch.train.step import make_eval_step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr_torch transcribe")
    p.add_argument("--model-path", required=True)
    p.add_argument("--audio-path", required=True)
    p.add_argument("--offsets", action="store_true",
                   help="print per-character frame offsets")
    p.add_argument("--n-best", type=int, default=1,
                   help="beam decoders: print the top-N hypotheses")
    p.add_argument("--chunk-overlap", type=float, default=2.0,
                   help="overlap (s) between chunks for audio longer "
                   "than the bucket ladder")
    p.add_argument("--streaming", action="store_true",
                   help="incremental decoding with carried model state "
                   "(unidirectional checkpoints); prints text fragments as "
                   "they finalize")
    p.add_argument("--chunk-frames", type=int, default=32,
                   help="streaming: feature frames per step (x10 ms)")
    p.add_argument("--beam-impl", default="auto",
                   choices=["auto", "host", "native", "device"],
                   help="streaming beam engine: K3 carrying the beam state "
                   "across chunks on the device (device), the host beam "
                   "(host), device on a GPU and host on the CPU (auto); "
                   "native is not ported")
    p.add_argument("--stream-norm-stats", default=None, metavar="MANIFEST",
                   help="streaming: prime the causal normalization with "
                   "corpus statistics of this manifest")
    p.add_argument("--stream-norm-weight", type=float, default=500.0,
                   help="prior weight of --stream-norm-stats in frames")
    add_decoder_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    pkg = load_checkpoint(args.model_path)
    alphabet = pkg.alphabet
    model = model_from_variables(pkg.variables, apply_runtime_overrides(pkg.model_config, args),
                                 device)
    eval_step = make_eval_step(model, pkg.frontend_config)
    decoder = build_decoder(args, alphabet)

    wave = load_audio(args.audio_path,
                      expected_sample_rate=pkg.frontend_config.sample_rate)
    if args.streaming:
        return _stream(args, pkg, model, wave)
    spec = BucketSpec(sample_rate=pkg.frontend_config.sample_rate)
    if len(wave) > spec.bucket_samples(spec.n_buckets - 1):
        text, offsets = transcribe_longform(
            eval_step, wave, alphabet, spec, decoder,
            overlap_seconds=args.chunk_overlap,
            spf=samples_per_frame(pkg.frontend_config),
        )
        print(text)
        if args.offsets:
            print(" ".join(map(str, offsets)))
        return 0

    padded, n = pad_to_ladder(np.asarray(wave, np.float32), spec)
    logits, out_lengths = eval_step(padded[None, :], np.array([n], np.int32))
    if args.n_best > 1:
        if not hasattr(decoder, "decode_nbest"):
            print("--n-best requires a beam decoder", file=sys.stderr)
            return 2
        for text, score, frames in decoder.decode_nbest(
                logits, out_lengths, n_best=args.n_best)[0]:
            print(f"{score:.4f}\t{text}")
            if args.offsets:
                print("\t" + " ".join(map(str, frames)))
        return 0
    texts, offsets = decoder.decode(logits, out_lengths, return_offsets=True)
    print(texts[0])
    if args.offsets:
        print(" ".join(map(str, offsets[0])))
    return 0


def _stream(args, pkg, model, wave) -> int:
    """Live-stream simulation: feed the wave in chunk-sized blocks and
    print fragments as their lookahead context completes."""
    from tpuasr_torch.stream import StreamingTranscriber

    kw = {}
    if args.decoder == "beam":
        kw = dict(decoder="beam", lm=load_lm(args.lm_path) if args.lm_path else None,
                  alpha=args.alpha, beta=args.beta, beam_width=args.beam_width,
                  cutoff_top_n=args.cutoff_top_n, cutoff_prob=args.cutoff_prob,
                  beam_impl=args.beam_impl)
    if args.stream_norm_stats:
        mean, var = corpus_feature_stats(args.stream_norm_stats, pkg.frontend_config)
        kw["prime_stats"] = (mean, var, args.stream_norm_weight)
    st = StreamingTranscriber(model, model.config, pkg.frontend_config, pkg.alphabet,
                              chunk_frames=args.chunk_frames, **kw)
    block = args.chunk_frames * pkg.frontend_config.hop
    w = np.asarray(wave, np.float32)
    for i in range(0, len(w), block):
        frag = st.feed(w[i:i + block])
        if frag:
            print(frag, end="", flush=True)
    print(st.flush())
    if args.offsets:
        print(" ".join(map(str, st.offsets)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
