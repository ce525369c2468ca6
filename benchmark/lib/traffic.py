"""The benchmark's one traffic generator: utterance lengths, transcripts,
audio and arrival schedules from a mix's parameters and the run's seed.

Every seed draws the same set of lengths and inter-arrival gaps (fixed
quantiles of the mix's distributions) in another order, and its own
audio and text, so that runs of different seeds do the same work.
Audio is made on the device in one draw and kept as int16 PCM.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

SAMPLE_RATE = 16000
# the port's PT-BR alphabet without its blank, apostrophe and space
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZÀÁÂÃÇÉÊÍÓÔÕÚÜ"


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of a run's seed;
    any non-negative seed."""
    return np.random.default_rng([int(seed), int(stream)])


def quantile_lognormal(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """n values at the mid-quantiles of a lognormal, clipped to [lo, hi],
    in increasing order."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def quantile_exponential(n: int, rate: float) -> np.ndarray:
    """n gaps at the mid-quantiles of an exponential of ``rate``."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


@dataclass
class Corpus:
    seconds: np.ndarray  # (N,) float64
    samples: np.ndarray  # (N,) int64
    texts: list
    pcm: list  # N int16 arrays


def make_texts(rng: np.random.Generator, seconds: np.ndarray, chars_per_s: float,
               vocab_size: int = 2000) -> list:
    """A transcript of about ``chars_per_s`` characters a second for each
    utterance: words of 2-9 letters of a seeded vocabulary."""
    letters = np.array(list(LETTERS))
    vocab = ["".join(rng.choice(letters, size=int(rng.integers(2, 10))))
             for _ in range(vocab_size)]
    out = []
    for d in seconds:
        n = max(1, int(round(chars_per_s * d)))
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append(vocab[int(rng.integers(vocab_size))])
        out.append(" ".join(words)[:n].strip())
    return out


def make_pcm(samples: np.ndarray, seed: int, device) -> list:
    """int16 PCM of the given lengths, drawn on ``device`` in one call:
    noise under a syllable-rate envelope at a per-utterance level."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = int(samples.sum())
    counts = torch.as_tensor(samples, device=device)
    level = torch.rand(len(samples), generator=gen, device=device) * 0.2 + 0.05
    phase = torch.rand(len(samples), generator=gen, device=device) * 6.283
    start = torch.cumsum(counts, 0) - counts
    utt = torch.repeat_interleave(torch.arange(len(samples), device=device), counts)
    t = (torch.arange(total, device=device) - start[utt]).to(torch.float32) / SAMPLE_RATE
    env = 0.55 + 0.45 * torch.sin(2 * np.pi * 4.0 * t + phase[utt])
    x = torch.randn(total, generator=gen, device=device) * env * level[utt]
    pcm = (x.clamp(-1, 1) * 32767).to(torch.int16).cpu().numpy()
    return np.split(pcm, np.cumsum(samples)[:-1])


def make_corpus(n: int, mix: dict, seed: int, device, stream: int = 0) -> Corpus:
    """``n`` utterances with the mix's length distribution
    (``length_median_s``, ``length_sigma``, ``length_min_s``,
    ``length_max_s``) and ``chars_per_s``, in a seeded order."""
    rng = rng_of(seed, stream)
    seconds = quantile_lognormal(n, mix["length_median_s"], mix["length_sigma"],
                                 mix["length_min_s"], mix["length_max_s"])
    seconds = seconds[rng.permutation(n)]
    samples = np.round(seconds * SAMPLE_RATE).astype(np.int64)
    texts = make_texts(rng, seconds, mix["chars_per_s"])
    return Corpus(samples / SAMPLE_RATE, samples, texts,
                  make_pcm(samples, (int(seed) << 4) + stream, device))


@dataclass(frozen=True)
class MemoryEntry:
    """A manifest entry held in memory: ``wav_path`` is a WAV file
    object (read once), ``read_transcript`` returns the text."""

    wav_path: object
    text: str
    duration: float

    def read_transcript(self) -> str:
        return self.text


def memory_entries(corpus: Corpus) -> list:
    from scipy.io import wavfile

    out = []
    for pcm, text, sec in zip(corpus.pcm, corpus.texts, corpus.seconds):
        buf = io.BytesIO()
        wavfile.write(buf, SAMPLE_RATE, pcm)
        buf.seek(0)
        out.append(MemoryEntry(buf, text, float(sec)))
    return out


def open_loop_schedule(rate: float, seconds: float, n_clips: int, seed: int):
    """Due times (s from the window's start) of a Poisson stream at
    ``rate`` over ``seconds``, and the clip each request sends: the same
    gaps and clip counts for every seed, in a seeded order."""
    rng = rng_of(seed, 7)
    n = int(round(rate * seconds))
    gaps = quantile_exponential(n, rate)[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    clips = np.arange(n) % n_clips
    return due, clips[rng.permutation(n)]
