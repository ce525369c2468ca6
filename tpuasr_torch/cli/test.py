"""Batch evaluation over a test manifest (port of ``tpuasr/cli/test.py``).

Runs the model over a manifest batch by batch, decodes (greedy, the host
beam, or K3 with word or char LM fusion), and prints the reference's
``Test Summary`` line of average WER and CER; ``--save-output`` dumps
hypotheses and references as JSON lines, ``--timing`` the eval's wall
time and utterances per second (of the last of ``--timing-repeats``
passes, the warm one). ``--device-resident-audio`` packs the manifest
into device memory once; greedy and ``beam-device`` then run a bucket's
batches as one chunk (``decode/resident_eval.py``), other decoders
batch by batch from the resident corpus. On the same batches the output
is the same; the resident plan keeps batches within a bucket, so where
the per-batch plan's batches span buckets, bf16 logits padded otherwise
can resolve a near tie in the beam another way.

Usage:
  python -m tpuasr_torch.cli.test --model-path m.ckpt --test-manifest val.csv \\
      [--decoder beam-device --lm-path lm.arpa --beam-width 10] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from tpuasr_torch.cli.opts import (
    add_decoder_args,
    add_runtime_args,
    apply_runtime_overrides,
    build_decoder,
)
from tpuasr_torch.compat.weights import model_from_variables
from tpuasr_torch.data.buckets import BucketSpec, make_buckets
from tpuasr_torch.data.loader import AudioBatchLoader
from tpuasr_torch.data.manifest import order_and_prune, read_manifest
from tpuasr_torch.data.resident import ResidentBatchLoader
from tpuasr_torch.decode.metrics import ErrorRateMeter
from tpuasr_torch.decode.resident_eval import ResidentEvaluator, supports_resident_eval
from tpuasr_torch.device import resolve_device
from tpuasr_torch.train.checkpoint import load_checkpoint
from tpuasr_torch.train.step import make_eval_step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr_torch test (batch eval)")
    p.add_argument("--model-path", required=True)
    p.add_argument("--test-manifest", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=2,
                   help="host prefetch depth (reference: dataloader workers)")
    p.add_argument("--device-resident-audio", action="store_true",
                   help="pack the eval corpus into device memory once; batches "
                   "assemble by a gather on the device")
    p.add_argument("--transfer-dtype", default="int16", choices=["int16", "float32"])
    p.add_argument("--save-output", default=None,
                   help="write per-utterance hyp/ref JSONL here")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--timing", action="store_true",
                   help="print eval wall time and utt/s after the summary")
    p.add_argument("--timing-repeats", type=int, default=1,
                   help="run the eval N times and report the LAST pass")
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

    entries = order_and_prune(read_manifest(args.test_manifest))
    sample_rate = pkg.frontend_config.sample_rate
    plan = make_buckets(entries, args.batch_size, BucketSpec(sample_rate=sample_rate),
                        shuffle=False)
    if args.device_resident_audio:
        loader = ResidentBatchLoader(plan, alphabet, sample_rate=sample_rate, device=device)
    else:
        loader = AudioBatchLoader(plan, alphabet, sample_rate=sample_rate,
                                  prefetch=args.num_workers, transfer_dtype=args.transfer_dtype)

    evaluator = None
    if args.device_resident_audio and supports_resident_eval(decoder):
        evaluator = ResidentEvaluator(model, pkg.frontend_config, decoder)

    def pairs():
        """(hypothesis, reference) per utterance, shortest first."""
        if evaluator is not None:
            yield from evaluator.pairs(loader)
            return
        for batch in loader.epoch(0):
            logits, out_lengths = eval_step(batch.waves, batch.wave_lengths)
            hyps = decoder.decode(logits, out_lengths)
            # batch padding (valid False) is the batch's tail
            yield from zip(hyps[:batch.size], batch.texts[:batch.size])

    out_f = open(args.save_output, "w") if args.save_output else None
    for _ in range(max(args.timing_repeats, 1)):
        meter = ErrorRateMeter()
        t_eval0 = time.time()
        for hyp, ref in pairs():
            meter.update(hyp, ref)
            if args.verbose:
                print(f"Ref: {ref}\nHyp: {hyp}\n")
            if out_f:
                out_f.write(json.dumps({"ref": ref, "hyp": hyp}, ensure_ascii=False) + "\n")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t_eval0
    if out_f:
        out_f.close()

    print(f"Test Summary \tAverage WER {meter.wer:.3f}\tAverage CER {meter.cer:.3f}")
    if args.timing:
        print(f"Timing \t{meter.n_utts} utts in {dt:.2f}s "
              f"= {meter.n_utts / max(dt, 1e-9):.1f} utt/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
