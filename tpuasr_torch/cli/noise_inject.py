"""Noise-injection listen-and-check utility (port of
``tpuasr/cli/noise_inject.py``; the same flags, plus ``--device``).

Mixes a noise file (or a directory of them, as one bank) into an
utterance at a given level and writes the result, so a user can hear
what --noise-dir training augmentation does. It runs the same
augmentation code as training (``tpuasr_torch.audio.augment``): the
draw from ``torch.Generator().manual_seed(--seed)``, then the apply.

Usage:
  python -m tpuasr_torch.cli.noise_inject --input-path in.wav \\
      --noise-path noise.wav --output-path out.wav --noise-level 0.5
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from tpuasr_torch.audio.augment import AugmentConfig, draw_noise, inject_noise, load_noise_bank
from tpuasr_torch.audio.io import load_audio, save_audio
from tpuasr_torch.cli.opts import add_device_arg
from tpuasr_torch.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr_torch noise injection demo")
    p.add_argument("--input-path", required=True)
    p.add_argument("--noise-path", required=True,
                   help="a noise wav file or a directory of them")
    p.add_argument("--output-path", default="out.wav")
    p.add_argument("--noise-level", type=float, default=0.5)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    wave = load_audio(args.input_path, expected_sample_rate=args.sample_rate)
    if os.path.isdir(args.noise_path):
        bank = load_noise_bank(args.noise_path, args.sample_rate)
    else:
        bank = load_audio(args.noise_path, expected_sample_rate=args.sample_rate)

    cfg = AugmentConfig(noise_prob=1.0, noise_min=args.noise_level,
                        noise_max=args.noise_level)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    offsets, levels, on = draw_noise(gen, 1, len(bank), cfg)
    out = inject_noise(offsets, levels, on, torch.from_numpy(wave[None, :]).to(device),
                       torch.tensor([len(wave)], device=device),
                       torch.from_numpy(bank).to(device))
    save_audio(args.output_path, out[0].cpu().numpy(), args.sample_rate)
    print(f"wrote {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
