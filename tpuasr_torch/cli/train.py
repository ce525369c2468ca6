"""Training entry point (port of ``tpuasr/cli/train.py``; the same
flags, plus ``--device``).

Usage:
  python -m tpuasr_torch.cli.train --train-manifest train.csv \
      --val-manifest val.csv --epochs 70 --checkpoint [--device cuda|cpu]

``--augment`` (WSOLA tempo and gain), ``--speed-perturb`` (resampled
speed and gain), ``--noise-dir`` (noise injection), ``--spec-augment``,
``--device-resident-audio`` (the corpus packed into device memory, a
chunk of steps per bucket) and ``--profile-dir`` (a trace of steps
10-15) work as in the JAX package. ``--rnn-type``
and ``--rnn-impl`` pick the recurrent kernel (``gru`` runs K1 under
``scan``/``pallas`` and K5 under ``pallas2``; ``lstm`` runs K4; ``rnn``
runs the vanilla RNN's plain loop); ``--no-bidirectional`` runs K1 or K4
with one direction, then a Lookahead layer of ``--lookahead-context``
frames;
``--ctc-impl`` is recorded in the checkpoint, and the port runs one CTC
function whatever it names.

Distributed training runs one process a rank, started by
``cli.multiproc``:

  python -m tpuasr_torch.cli.multiproc --world-size 2 -- \
      python -m tpuasr_torch.cli.train --train-manifest train.csv \
      --world-size 2 [--mesh-tp 2] [--dist-backend gloo] [--device cpu]

(the launcher appends ``--rank``, ``--world-size`` and ``--dist-url``).
Each rank trains on its data shard of every global batch
(``train/mesh.py``); ``--mesh-tp N`` makes a (world / N, N) grid of
(data, model) ranks. At N = 2 a bidirectional GRU or LSTM shards its
recurrent layers by direction (each model rank runs its kernel at
D=1); otherwise, as tpuasr's CLI chooses, the gate axis is sharded.
``--dist-backend`` defaults to NCCL on a card and gloo on the CPU;
ranks that share one card need gloo. Rank r runs on card r % the cards
visible (``LOCAL_RANK`` when set). A single process uses one card: the
JAX package's one-process mesh over local devices has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

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
from tpuasr_torch.train.mesh import default_backend, distributed_init, make_mesh
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
    # distributed: one process a rank (cli.multiproc)
    p.add_argument("--world-size", type=int, default=1, help="number of ranks")
    p.add_argument("--rank", type=int, default=0, help="this process's rank")
    p.add_argument("--dist-url", default=None,
                   help="rendezvous address host:port (default $TPUASR_COORDINATOR)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="collectives backend (default nccl on cuda, gloo on cpu; "
                   "ranks sharing one card need gloo)")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel degree: a (world / tp, tp) grid of (data, "
                   "model) ranks; the recurrent weights shard over the model "
                   "ranks (by direction at tp 2 for a bidirectional GRU or "
                   "LSTM, else by gate columns); must divide --world-size")
    p.add_argument("--transfer-dtype", default="int16", choices=["int16", "float32"],
                   help="wave batch dtype for the host-to-device copy "
                   "(int16 halves the bytes; rescaled on the device)")
    p.add_argument("--device-resident-audio", action="store_true")
    p.add_argument("--cache-audio", action="store_true",
                   help="keep decoded waves in RAM after the first read")
    p.add_argument("--num-workers", type=int, default=2, help="host prefetch depth")
    add_device_arg(p)
    return p


def _device_and_mesh(args):
    """Check the distributed flags, join the process group when there are
    several ranks, and return (device, mesh). Every refusal comes before
    the rendezvous."""
    world, rank, tp = args.world_size, args.rank, args.mesh_tp
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"--rank {rank} must be in [0, --world-size {world})")
    if tp < 1 or world % tp:
        raise ValueError(f"--mesh-tp {tp} does not divide --world-size {world}")
    device = args.device
    if world > 1:
        backend = args.dist_backend or default_backend(device)
        if torch.device(device).type == "cuda":
            n_cards = torch.cuda.device_count()
            if n_cards == 0:
                raise RuntimeError("no CUDA device is available; pass --device cpu")
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            if backend == "nccl" and n_cards < local_world:
                raise ValueError(
                    f"NCCL needs a card a rank: {local_world} ranks on {n_cards} card(s); "
                    "pass --dist-backend gloo for ranks that share a card")
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank)) % n_cards}"
            torch.cuda.set_device(device)
        elif "OMP_NUM_THREADS" not in os.environ:
            # the host's cores shared out: ranks that each spin a thread a
            # core while they wait in collectives run ~30x slower
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
        distributed_init(args.dist_url, world, rank, backend)
    return device, make_mesh(world, tp)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device, mesh = _device_and_mesh(args)
    alphabet = alphabet_from(args)
    frontend_cfg = frontend_config_from(args)
    model_cfg = model_config_from(args, alphabet, frontend_cfg.n_features)
    # tpuasr/cli/train.py:147-160 with the port's kernel table: at tp 2 a
    # bidirectional GRU or LSTM (K1, K5 or K4 under every impl) runs one
    # direction a model rank; otherwise the gate axis is sharded
    direction_tp = (mesh.tp == 2 and model_cfg.bidirectional
                    and model_cfg.rnn_type in ("gru", "lstm"))
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
    # the ranks of one model group load the same batches: the data index
    shard = dict(rank=mesh.data_index, world=mesh.data_size)
    if args.device_resident_audio:
        train_loader = ResidentBatchLoader(plan, alphabet, sample_rate=args.sample_rate,
                                           device=device, **shard)
    else:
        train_loader = AudioBatchLoader(plan, alphabet, sample_rate=args.sample_rate,
                                        prefetch=args.num_workers,
                                        cache_audio=args.cache_audio,
                                        transfer_dtype=args.transfer_dtype, **shard)
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
    try:
        train(model_cfg, frontend_cfg, train_cfg, loop_cfg, train_loader, val_loader,
              alphabet, continue_from=args.continue_from, finetune=args.finetune,
              device=device, augment_fn=augment_fn, mesh=mesh, direction_tp=direction_tp)
    finally:
        if args.world_size > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
