"""Training-time augmentation on the device (port of
``tpuasr/audio/augment.py``).

The reference augments on the host in its dataloader workers: sox tempo
in [0.85, 1.15] and gain in [-6, 8] dB, and NoiseInjection (a random
slice of a random noise file at a random level, with probability
--noise-prob). Here all of it runs on the batch's device:

  * Tempo (default): pitch-preserving overlap-add (``wsola_tempo``),
    sox "tempo" semantics without the correlation search: frames taken
    at a rate-scaled analysis hop, Hann-windowed, added at a fixed
    synthesis hop of half a frame, where the two window halves sum to 1.
  * Speed perturbation (``tempo_mode="resample"``, --speed-perturb):
    linear-interpolation resampling, which shifts pitch with the rate.
  * Gain: one scalar per utterance.
  * Noise: every noise WAV concatenated into one ring buffer (the bank),
    mixed in at a random offset and a random level relative to the
    utterance's RMS.
  * SpecAugment: random frequency and time masks on the log-spectrogram.

Every random function is split in two. A *draw* takes a
``torch.Generator`` on the batch's device and returns the parameters
(rates, gains in dB, noise offsets, levels and on-flags, mask starts and
widths) from the JAX package's distributions; an *apply* takes those
parameters and does what the JAX function does after its own draw. JAX's
``jax.random`` and torch's generators never give the same numbers, so
the applies are what the tests hold to the JAX package. Nothing here
reads a value back to the host: the functions run inside a train step
that must not wait for the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass(frozen=True)
class AugmentConfig:
    tempo_gain: bool = True
    # "wsola": pitch-preserving overlap-add (sox tempo, the reference's
    # recipe); "resample": linear-interp resampling (pitch shifts with
    # rate: speed perturbation)
    tempo_mode: str = "wsola"
    tempo_low: float = 0.85
    tempo_high: float = 1.15
    gain_db_low: float = -6.0
    gain_db_high: float = 8.0
    noise_dir: str | None = None
    noise_prob: float = 0.4
    noise_min: float = 0.0
    noise_max: float = 0.5
    spec_augment: bool = False
    freq_mask_width: int = 20
    time_mask_frac: float = 0.05
    n_freq_masks: int = 1
    n_time_masks: int = 1
    noise_bank_seconds: float = 120.0


def load_noise_bank(noise_dir: str, sample_rate: int,
                    max_seconds: float = 120.0) -> np.ndarray:
    """Concatenate noise WAVs into one 1-D ring buffer (host, once)."""
    from tpuasr_torch.audio.io import load_audio

    chunks = []
    total = 0
    cap = int(max_seconds * sample_rate)
    for wav in sorted(Path(noise_dir).rglob("*.wav")):
        w = load_audio(str(wav), expected_sample_rate=sample_rate)
        chunks.append(w)
        total += len(w)
        if total >= cap:
            break
    if not chunks:
        raise ValueError(f"no .wav noise files under {noise_dir}")
    bank = np.concatenate(chunks)[:cap]
    return bank.astype(np.float32)


# ---------------------------------------------------------------- draws


def _uniform(gen: torch.Generator, b: int, low: float, high: float) -> torch.Tensor:
    return low + (high - low) * torch.rand((b,), generator=gen, device=gen.device)


def _randint_below(gen: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """One integer in [0, high[i]) per row, for a per-row ``high`` >= 1
    on the device (torch.randint takes one scalar bound). The modulo's
    bias is below high / 2**62."""
    return torch.randint(0, 1 << 62, high.shape, generator=gen, device=gen.device) % high


def draw_tempo_gain(gen: torch.Generator, b: int, cfg: AugmentConfig):
    """(rates, gains_db), (B,) f32: rates uniform in [tempo_low,
    tempo_high), gains uniform in [gain_db_low, gain_db_high) dB."""
    rates = _uniform(gen, b, cfg.tempo_low, cfg.tempo_high)
    gains_db = _uniform(gen, b, cfg.gain_db_low, cfg.gain_db_high)
    return rates, gains_db


def draw_noise(gen: torch.Generator, b: int, n: int, cfg: AugmentConfig):
    """(offsets (B,) int64 uniform in [0, n), levels (B,) f32 uniform in
    [noise_min, noise_max), on (B,) bool with probability noise_prob)."""
    offsets = torch.randint(0, n, (b,), generator=gen, device=gen.device)
    levels = _uniform(gen, b, cfg.noise_min, cfg.noise_max)
    on = torch.rand((b,), generator=gen, device=gen.device) < cfg.noise_prob
    return offsets, levels, on


def draw_spec_augment(gen: torch.Generator, feat_lengths: torch.Tensor, t_max: int,
                      n_feat: int, cfg: AugmentConfig, rows: tuple | None = None):
    """(freq_masks, time_masks): lists of (start, width) pairs of (B,)
    int64 tensors, one pair a mask, drawn as ``tpuasr/audio/augment.py``
    draws them: a frequency mask's width in [0, freq_mask_width], its
    start in [0, max(F - width, 1)); a time mask's width as
    randint(0, T) % (max_w + 1) with max_w = max(int(len *
    time_mask_frac), 1), its start as randint(0, T) % max(len - width,
    1). ``rows`` = (first row, total rows): the draws of those B rows of
    a global batch of ``total`` (each rank of a data group draws for the
    whole batch and keeps its own rows; ``feat_lengths`` are its own)."""
    b = feat_lengths.shape[0]
    r0, total = rows or (0, b)
    own = slice(r0, r0 + b)
    lengths = feat_lengths.to(torch.int64)
    freq, time = [], []
    for _ in range(cfg.n_freq_masks):
        width = torch.randint(0, cfg.freq_mask_width + 1, (total,), generator=gen,
                              device=gen.device)
        start = _randint_below(gen, (n_feat - width).clamp(min=1))
        freq.append((start[own], width[own]))
    for _ in range(cfg.n_time_masks):
        max_w = (lengths.to(torch.float32) * cfg.time_mask_frac).to(torch.int64).clamp(min=1)
        width = (torch.randint(0, t_max, (total,), generator=gen, device=gen.device)[own]
                 % (max_w + 1))
        start = (torch.randint(0, t_max, (total,), generator=gen, device=gen.device)[own]
                 % (lengths - width).clamp(min=1))
        time.append((start, width))
    return freq, time


# -------------------------------------------------------------- applies


def _new_lengths(lengths: torch.Tensor, rates: torch.Tensor, l_max: int) -> torch.Tensor:
    """min(int32(f32(len) / rate), l_max): truncation toward zero, as
    astype(int32)."""
    new = (lengths.to(torch.float32) / rates).to(torch.int32).clamp(max=l_max)
    return new.to(lengths.dtype)


def _valid(lengths: torch.Tensor, l_max: int, dtype) -> torch.Tensor:
    return (torch.arange(l_max, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)


def speed_and_gain(rates: torch.Tensor, gains_db: torch.Tensor, waves: torch.Tensor,
                   lengths: torch.Tensor):
    """Per-utterance speed (resample gather) + gain: output sample i
    reads input position i * rate, linearly interpolated. Returns
    (waves, new lengths)."""
    _, l_max = waves.shape
    pos = torch.arange(l_max, dtype=torch.float32, device=waves.device)[None, :] * rates[:, None]
    lo = torch.floor(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    hi = (lo + 1).clamp(0, l_max - 1)
    lo = lo.clamp(0, l_max - 1)
    out = waves.gather(1, lo) * (1.0 - frac) + waves.gather(1, hi) * frac
    new_lengths = _new_lengths(lengths, rates, l_max)
    gain = torch.pow(10.0, gains_db / 20.0)
    out = out * gain[:, None] * _valid(new_lengths, l_max, out.dtype)
    return out, new_lengths


WSOLA_FRAME = 512  # 32 ms at 16 kHz; synthesis hop = half (50% overlap)


def wsola_tempo(rates: torch.Tensor, waves: torch.Tensor, lengths: torch.Tensor,
                frame: int = WSOLA_FRAME):
    """Pitch-preserving tempo change by rate (duration x 1/rate).

    Correlation-free WSOLA: analysis frames of ``frame`` samples start
    at fractional positions k * (hop * rate) (linear-interp gather);
    Hann-windowed frames overlap-add at the fixed synthesis hop
    (frame/2). Shifted periodic-Hann halves sum to 1, so the overlap-add
    is frame_k[:hop] + frame_{k-1}[hop:]; block 0 has one half and is
    renormalised by max(w[:hop], 0.5). Output past the new length is
    zeroed. Returns (waves, new lengths)."""
    b, l_max = waves.shape
    dev, dtype = waves.device, waves.dtype
    hop = frame // 2
    k_frames = max(l_max // hop, 1)
    k_idx = torch.arange(k_frames, dtype=torch.float32, device=dev)
    starts = k_idx[None, :] * (hop * rates[:, None])  # (B, K)
    i_idx = torch.arange(frame, dtype=torch.float32, device=dev)
    pos = starts[:, :, None] + i_idx[None, None, :]  # (B, K, N)
    lo = torch.floor(pos).to(torch.int64)
    frac = (pos - lo.to(torch.float32)).to(dtype)
    hi = (lo + 1).clamp(0, l_max - 1)
    lo = lo.clamp(0, l_max - 1)

    def gather(idx):
        return waves.gather(1, idx.reshape(b, -1)).reshape(b, k_frames, frame)

    frames = gather(lo) * (1.0 - frac) + gather(hi) * frac
    # periodic Hann: w[i] + w[i + hop] == 1
    w = (0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(frame, dtype=torch.float32,
                                                            device=dev) / frame)).to(dtype)
    fw = frames * w[None, None, :]
    first = fw[:, :, :hop]  # frame k -> output block k
    second = fw[:, :, hop:]  # frame k -> output block k+1
    second = torch.cat([torch.zeros_like(second[:, :1]), second[:, :-1]], dim=1)
    acc = (first + second).reshape(b, k_frames * hop)
    wnorm = torch.cat([w[:hop].clamp(min=0.5),
                       torch.ones(((k_frames - 1) * hop,), dtype=dtype, device=dev)])
    out = acc / wnorm[None, :]
    out = torch.nn.functional.pad(out, (0, l_max - k_frames * hop))
    new_lengths = _new_lengths(lengths, rates, l_max)
    return out * _valid(new_lengths, l_max, out.dtype), new_lengths


def tempo_and_gain(rates: torch.Tensor, gains_db: torch.Tensor, waves: torch.Tensor,
                   lengths: torch.Tensor, cfg: AugmentConfig):
    """Per-utterance tempo (WSOLA or resample per cfg.tempo_mode) + gain:
    the reference's augment_audio_with_sox."""
    if cfg.tempo_mode == "resample":
        return speed_and_gain(rates, gains_db, waves, lengths)
    out, new_lengths = wsola_tempo(rates, waves, lengths)
    gain = torch.pow(10.0, gains_db / 20.0).to(out.dtype)
    return out * gain[:, None], new_lengths


def inject_noise(offsets: torch.Tensor, levels: torch.Tensor, on: torch.Tensor,
                 waves: torch.Tensor, lengths: torch.Tensor, noise_bank: torch.Tensor):
    """Mix the bank's ring-buffer slice at ``offsets`` into each row at
    ``levels`` times the row's RMS over the noise slice's RMS (both over
    the row's valid samples), on the rows where ``on``."""
    _, l_max = waves.shape
    n = noise_bank.shape[0]
    idx = (offsets[:, None] + torch.arange(l_max, device=waves.device)[None, :]) % n
    noise = noise_bank[idx]  # (B, L) ring-buffer slices
    t_valid = _valid(lengths, l_max, waves.dtype)
    denom = lengths.to(waves.dtype).clamp(min=1.0)
    rms_x = torch.sqrt((waves ** 2 * t_valid).sum(dim=1) / denom + 1e-10)
    rms_n = torch.sqrt((noise ** 2 * t_valid).sum(dim=1) / denom + 1e-10)
    scale = torch.where(on, levels * rms_x / rms_n, 0.0)
    return waves + scale[:, None] * noise * t_valid


def spec_augment(freq_masks, time_masks, feats: torch.Tensor) -> torch.Tensor:
    """Frequency then time masking of (B, T, F) log-spectrograms: each
    (start, width) pair zeroes bins (or frames) [start, start + width)
    of its row."""
    _, t_max, f = feats.shape
    out = feats
    fr = torch.arange(f, device=feats.device)[None, :]
    for start, width in freq_masks:
        m = (fr >= start[:, None]) & (fr < (start + width)[:, None])
        out = out * (1.0 - m[:, None, :].to(out.dtype))
    tr = torch.arange(t_max, device=feats.device)[None, :]
    for start, width in time_masks:
        m = (tr >= start[:, None]) & (tr < (start + width)[:, None])
        out = out * (1.0 - m[:, :, None].to(out.dtype))
    return out


class AugmentFn:
    """The augmentation pair of a train step: ``waves`` runs before the
    frontend (tempo or speed with gain, then noise), ``feats`` after it
    (SpecAugment). Each draws from the generator it is given, on the
    batch's device, and is the identity where the config turns it off.
    The noise bank is copied to a device at its first use there.
    ``rows`` = (first row, total rows) draws for a global batch of
    ``total`` rows and applies the draws of rows [first, first + B) (a
    rank of a data group), so a distributed step augments as the
    single-process step on the global batch does."""

    def __init__(self, cfg: AugmentConfig, sample_rate: int):
        self.cfg = cfg
        self._bank = None
        self._banks: dict = {}  # device -> the bank on it
        if cfg.noise_dir:
            self._bank = torch.from_numpy(
                load_noise_bank(cfg.noise_dir, sample_rate, cfg.noise_bank_seconds))

    def bank(self, device) -> torch.Tensor | None:
        if self._bank is None:
            return None
        device = torch.device(device)
        if device not in self._banks:
            self._banks[device] = self._bank.to(device)
        return self._banks[device]

    def waves(self, gen: torch.Generator, waves: torch.Tensor, lengths: torch.Tensor,
              rows: tuple | None = None):
        cfg = self.cfg
        b = waves.shape[0]
        r0, total = rows or (0, b)
        if cfg.tempo_gain:
            rates, gains_db = draw_tempo_gain(gen, total, cfg)
            waves, lengths = tempo_and_gain(rates[r0:r0 + b], gains_db[r0:r0 + b], waves,
                                            lengths, cfg)
        bank = self.bank(waves.device)
        if bank is not None:
            offsets, levels, on = draw_noise(gen, total, bank.shape[0], cfg)
            waves = inject_noise(offsets[r0:r0 + b], levels[r0:r0 + b], on[r0:r0 + b], waves,
                                 lengths, bank)
        return waves, lengths

    def feats(self, gen: torch.Generator, feats: torch.Tensor, feat_lengths: torch.Tensor,
              rows: tuple | None = None):
        if not self.cfg.spec_augment:
            return feats
        freq, time = draw_spec_augment(gen, feat_lengths, feats.shape[1], feats.shape[2],
                                       self.cfg, rows)
        return spec_augment(freq, time, feats)


def make_augment_fn(cfg: AugmentConfig, sample_rate: int = 16000) -> AugmentFn:
    return AugmentFn(cfg, sample_rate)
