"""Training entry point (port of ``tpuasr/cli/train.py``; the same
flags, plus ``--device``).

Usage:
  python -m tpuasr_torch.cli.train --train-manifest train.csv \
      --val-manifest val.csv --epochs 70 --checkpoint [--device cuda|cpu]

``--augment`` (WSOLA tempo and gain), ``--speed-perturb`` (resampled
speed and gain), ``--noise-dir`` (noise injection), ``--spec-augment``,
``--device-resident-audio`` (the corpus packed into device memory, a
chunk of steps per bucket) and ``--profile-dir`` (a trace of steps
10-15) work as in the JAX package. The flags of paths not ported yet
(data parallelism and tensor parallelism) parse and then raise
NotImplementedError naming their ROADMAP.md item. ``--rnn-type``
and ``--rnn-impl`` pick the recurrent kernel (``gru`` runs K1 under
``scan``/``pallas`` and K5 under ``pallas2``; ``lstm`` runs K4; ``rnn``
runs the vanilla RNN's plain loop); ``--no-bidirectional`` runs K1 or K4
with one direction, then a Lookahead layer of ``--lookahead-context``
frames;
``--ctc-impl`` is recorded in the checkpoint, and the port runs one CTC
function whatever it names.
"""

from __future__ import annotations

import argparse
import sys

from tpuasr_torch.audio.augment import AugmentConfig, make_augment_fn
from tpuasr_torch.cli.opts import (
    add_audio_args,
    add_device_arg,
    add_model_args,
    alphabet_from,
    frontend_config_from,
    model_config_from,
)
from tpuasr_torch.data.buckets import BucketSpec, make_buckets
from tpuasr_torch.data.loader import AudioBatchLoader
from tpuasr_torch.data.manifest import order_and_prune, read_manifest
from tpuasr_torch.data.resident import ResidentBatchLoader
from tpuasr_torch.train.loop import LoopConfig, train
from tpuasr_torch.train.step import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpuasr_torch train")
    p.add_argument("--train-manifest", required=True)
    p.add_argument("--val-manifest", default=None)
    add_audio_args(p)
    add_model_args(p)
    # optimizer (reference defaults)
    p.add_argument("--epochs", type=int, default=70)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--max-norm", type=float, default=400.0)
    p.add_argument("--learning-anneal", type=float, default=1.1)
    p.add_argument("--ctc-impl", default="scan", choices=["scan", "pallas"],
                   help="kept for compatibility; the port runs one CTC "
                   "function (its kernels on the GPU)")
    # curriculum / duration handling
    p.add_argument("--no-shuffle", dest="shuffle", action="store_false", default=True)
    p.add_argument("--no-sortaGrad", "--no-sorta-grad", dest="sorta_grad",
                   action="store_false", default=True)
    p.add_argument("--min-duration", type=float, default=None)
    p.add_argument("--max-duration", type=float, default=None)
    # augmentation (on the device, in the train step)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--speed-perturb", action="store_true")
    p.add_argument("--noise-dir", default=None)
    p.add_argument("--noise-prob", type=float, default=0.4)
    p.add_argument("--noise-min", type=float, default=0.0)
    p.add_argument("--noise-max", type=float, default=0.5)
    p.add_argument("--spec-augment", action="store_true")
    # checkpointing
    p.add_argument("--checkpoint", action="store_true")
    p.add_argument("--checkpoint-per-batch", type=int, default=0)
    p.add_argument("--save-folder", default="models/")
    p.add_argument("--model-path", default="models/tpuasr_final.ckpt")
    p.add_argument("--continue-from", default=None)
    p.add_argument("--finetune", action="store_true")
    # logging
    p.add_argument("--log-dir", default=None)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--log-params", action="store_true")
    p.add_argument("--visdom", action="store_true",
                   help="accepted for compatibility; maps to JSONL logging")
    p.add_argument("--seed", type=int, default=123456)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--sync-every", type=int, default=10,
                   help="read device metrics every N steps (1 = "
                   "reference-style per-iteration readout)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="run validation every N epochs (the final epoch "
                   "always evaluates)")
    p.add_argument("--cuda", action="store_true", help="accepted for compatibility")
    # distributed (not ported yet)
    p.add_argument("--world-size", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--dist-url", default=None)
    p.add_argument("--dist-backend", default="nccl", help="accepted for compatibility")
    p.add_argument("--mesh-tp", type=int, default=1)
    p.add_argument("--transfer-dtype", default="int16", choices=["int16", "float32"],
                   help="wave batch dtype for the host-to-device copy "
                   "(int16 halves the bytes; rescaled on the device)")
    p.add_argument("--device-resident-audio", action="store_true")
    p.add_argument("--cache-audio", action="store_true",
                   help="keep decoded waves in RAM after the first read")
    p.add_argument("--num-workers", type=int, default=2, help="host prefetch depth")
    add_device_arg(p)
    return p


def _refuse_unported(args) -> None:
    unported = [
        (args.world_size > 1, "--world-size > 1"),
        (args.mesh_tp > 1, "--mesh-tp > 1"),
    ]
    for hit, flag in unported:
        if hit:
            raise NotImplementedError(
                f"{flag} is not yet ported (ROADMAP.md §1.6: distributed)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    alphabet = alphabet_from(args)
    frontend_cfg = frontend_config_from(args)
    model_cfg = model_config_from(args, alphabet, frontend_cfg.n_features)
    train_cfg = TrainConfig(lr=args.lr, momentum=args.momentum, max_norm=args.max_norm,
                            learning_anneal=args.learning_anneal, ctc_impl=args.ctc_impl)
    loop_cfg = LoopConfig(
        epochs=args.epochs, seed=args.seed,
        save_folder=args.save_folder if args.checkpoint else None,
        model_path=args.model_path, checkpoint_per_batch=args.checkpoint_per_batch,
        log_dir=args.log_dir, tensorboard=args.tensorboard, quiet=args.quiet,
        profile_dir=args.profile_dir, sync_every=args.sync_every, eval_every=args.eval_every)

    spec = BucketSpec(sample_rate=args.sample_rate)
    train_entries = order_and_prune(read_manifest(args.train_manifest),
                                    min_duration=args.min_duration,
                                    max_duration=args.max_duration)
    plan = make_buckets(train_entries, args.batch_size, spec, seed=args.seed,
                        sorta_grad=args.sorta_grad, shuffle=args.shuffle)
    if args.device_resident_audio:
        train_loader = ResidentBatchLoader(plan, alphabet, sample_rate=args.sample_rate,
                                           device=args.device)
    else:
        train_loader = AudioBatchLoader(plan, alphabet, sample_rate=args.sample_rate,
                                        prefetch=args.num_workers,
                                        cache_audio=args.cache_audio,
                                        transfer_dtype=args.transfer_dtype)
    val_loader = None
    if args.val_manifest:
        val_plan = make_buckets(order_and_prune(read_manifest(args.val_manifest)),
                                args.batch_size, spec, shuffle=False)
        val_loader = AudioBatchLoader(val_plan, alphabet, sample_rate=args.sample_rate,
                                      prefetch=args.num_workers)
    augment_fn = None
    if args.augment or args.speed_perturb or args.noise_dir or args.spec_augment:
        augment_fn = make_augment_fn(AugmentConfig(
            tempo_gain=args.augment or args.speed_perturb,
            tempo_mode="resample" if args.speed_perturb else "wsola",
            noise_dir=args.noise_dir, noise_prob=args.noise_prob, noise_min=args.noise_min,
            noise_max=args.noise_max, spec_augment=args.spec_augment),
            sample_rate=args.sample_rate)
    train(model_cfg, frontend_cfg, train_cfg, loop_cfg, train_loader, val_loader,
          alphabet, continue_from=args.continue_from, finetune=args.finetune,
          device=args.device, augment_fn=augment_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
