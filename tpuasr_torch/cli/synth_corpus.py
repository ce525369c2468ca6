"""Synthetic PT-BR-alphabet corpus generator (a copy of
``tpuasr/cli/synth_corpus.py``; numpy and scipy only).

Word-tone WAVs (each word a harmonic stack at its own f0, so a model can
learn them), transcript files and duration-sorted manifests, for tests
and smoke runs without downloads. ``--duration 5.0`` makes fixed-length
utterances that all land in the 5 s bucket.

Usage:
  python -m tpuasr_torch.cli.synth_corpus OUT_DIR --n 64 [--duration 5.0]
      [--val-fraction 0.25] [--seed 0] [--noise-dir]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

WORDS = [
    "ALO", "MUNDO", "BOM", "DIA", "TUDO", "BEM", "OLA", "CASA",
    "FALA", "VOZ", "REDE", "DADO", "SOM", "TOM", "MAR", "SOL",
]
SR = 16000


def _render(words: list[str], duration: float, rng) -> np.ndarray:
    """Each word = a harmonic stack at a word-specific f0, evenly
    spaced; mild noise floor."""
    n = int(SR * duration)
    wave = np.zeros(n, np.float64)
    seg = n // max(len(words), 1)
    for j, w in enumerate(words):
        f0 = 110.0 + 37.0 * (WORDS.index(w) if w in WORDS else len(WORDS))
        a, b = j * seg, min((j + 1) * seg, n)
        t = np.arange(b - a) / SR
        env = np.hanning(b - a)
        wave[a:b] += env * sum(
            np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 5)
        )
    wave += 0.02 * rng.randn(n)
    peak = np.abs(wave).max()
    return (wave / max(peak, 1e-9) * 0.8).astype(np.float32)


def generate(out_dir: str, n: int, duration: float | None,
             val_fraction: float, seed: int,
             make_noise: bool = False, span: tuple = (0.6, 1.7)) -> dict:
    """Write the corpus; without a fixed ``duration`` each utterance's
    is uniform in ``span`` seconds."""
    from scipy.io import wavfile

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        n_words = int(rng.randint(2, 5))
        words = [WORDS[rng.randint(len(WORDS))] for _ in range(n_words)]
        dur = duration if duration else float(rng.uniform(*span))
        wave = _render(words, dur, rng)
        wav = os.path.join(out_dir, f"utt{i:04d}.wav")
        txt = os.path.join(out_dir, f"utt{i:04d}.txt")
        wavfile.write(wav, SR, (wave * 32767).astype(np.int16))
        with open(txt, "w", encoding="utf-8") as f:
            f.write(" ".join(words) + "\n")
        rows.append((wav, txt, dur))

    rows.sort(key=lambda r: r[2])  # duration-sorted manifests
    n_val = int(round(n * val_fraction))
    val, train = rows[:0], rows
    if n_val:
        idx = rng.permutation(n)
        val_set = set(idx[:n_val].tolist())
        val = [r for i, r in enumerate(rows) if i in val_set]
        train = [r for i, r in enumerate(rows) if i not in val_set]

    paths = {}
    for name, subset in (("train", train), ("val", val), ("all", rows)):
        if not subset:
            continue
        p = os.path.join(out_dir, f"{name}.csv")
        with open(p, "w", encoding="utf-8") as f:
            f.writelines(f"{w},{t}\n" for w, t, _ in subset)
        paths[name] = p

    if make_noise:
        noise_dir = os.path.join(out_dir, "noise")
        os.makedirs(noise_dir, exist_ok=True)
        for i in range(3):
            m = int(SR * 2.0)
            wavfile.write(
                os.path.join(noise_dir, f"noise{i}.wav"), SR,
                (0.3 * rng.randn(m) * 32767).astype(np.int16),
            )
        paths["noise"] = noise_dir
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--duration", type=float, default=None,
                   help="fixed utterance seconds (default: random 0.6-1.7)")
    p.add_argument("--val-fraction", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-dir", action="store_true",
                   help="also synthesize a noise bank for --augment runs")
    args = p.parse_args(argv)
    paths = generate(args.out_dir, args.n, args.duration,
                     args.val_fraction, args.seed, args.noise_dir)
    for k, v in paths.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
