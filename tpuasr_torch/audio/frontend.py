"""Log-spectrogram frontend (port of ``tpuasr/audio/frontend.py``).

librosa-style STFT magnitude -> log1p -> optional per-utterance
mean/std normalization, hamming window, 20 ms window / 10 ms stride at
16 kHz, computed for a whole padded batch on the device. Framing follows
librosa's ``center=True`` convention PER UTTERANCE (reflect at 0 and at
each utterance's true length), so batch padding never leaks into the
features. The DFT is one (B*T, n_fft) @ (n_fft, 2F) matmul against a
fixed cos|sin basis in full float32 (TF32 stays off: a TF32-grade DFT
is far too coarse for the log-magnitudes of near-zero bins).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

WINDOWS = ("hamming", "hann", "blackman", "bartlett", "rect")


@dataclass(frozen=True)
class FrontendConfig:
    """Mirrors the reference's audio_conf dict (same keys as
    ``tpuasr.audio.frontend.FrontendConfig``)."""

    sample_rate: int = 16000
    window_size: float = 0.02  # seconds
    window_stride: float = 0.01  # seconds
    window: str = "hamming"
    normalize: bool = True
    dft: str = "matmul"  # the port always computes the DFT as a matmul

    @property
    def n_fft(self) -> int:
        return int(round(self.sample_rate * self.window_size))

    @property
    def hop(self) -> int:
        return int(round(self.sample_rate * self.window_stride))

    @property
    def n_features(self) -> int:
        return self.n_fft // 2 + 1

    def to_dict(self) -> dict:
        return {
            "sample_rate": self.sample_rate,
            "window_size": self.window_size,
            "window_stride": self.window_stride,
            "window": self.window,
            "normalize": self.normalize,
            "dft": self.dft,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FrontendConfig":
        return cls(**{k: d[k] for k in d if k in cls.__dataclass_fields__})


def num_frames(num_samples, hop: int):
    """Frame count under the center=True convention: 1 + floor(L/hop).
    Works on ints and integer tensors (length propagation)."""
    return 1 + num_samples // hop


def _window_np(kind: str, n: int) -> np.ndarray:
    # Periodic windows (fftbins=True), matching librosa's default
    # scipy.signal.get_window behavior used by the reference family.
    t = np.arange(n, dtype=np.float64)
    if kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * t / n)
    elif kind == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * t / n)
    elif kind == "blackman":
        w = (
            0.42
            - 0.5 * np.cos(2 * np.pi * t / n)
            + 0.08 * np.cos(4 * np.pi * t / n)
        )
    elif kind == "bartlett":
        w = 1.0 - np.abs(2.0 * t / n - 1.0)
    elif kind == "rect":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return w.astype(np.float32)


def _dft_mats(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: cos and -sin matrices of shape (n_fft, n_fft//2+1)."""
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_mat_combined(n_fft: int) -> np.ndarray:
    """cos|-sin real-DFT basis side by side, (n_fft, 2 * (n_fft//2+1))."""
    return np.concatenate(_dft_mats(n_fft), axis=1)


def _reflect(pos: torch.Tensor, lengths: torch.Tensor, l: int) -> torch.Tensor:
    """Signed sample positions -> in-range indices, reflecting at 0 and
    at each utterance's last valid sample (librosa center=True)."""
    pos = pos.abs()
    right = (lengths - 1).clamp(min=0).view(-1, *([1] * (pos.dim() - 1)))
    pos = torch.where(pos > right, 2 * right - pos, pos)
    return pos.clamp(0, l - 1)


def _frame_gather(waves, lengths, n_fft, hop, t_max):
    """General framing via reflected gather indices (exact librosa
    center=True semantics per utterance, any n_fft/hop)."""
    b, l = waves.shape
    dev = waves.device
    pos = (
        torch.arange(t_max, device=dev)[:, None] * hop
        + torch.arange(n_fft, device=dev)[None, :]
        - n_fft // 2
    )  # (T, n_fft)
    pos = _reflect(pos.unsqueeze(0).expand(b, -1, -1), lengths, l)
    return torch.gather(waves, 1, pos.reshape(b, -1)).reshape(b, t_max, n_fft)


def frame_signal(waves: torch.Tensor, lengths: torch.Tensor, n_fft: int,
                 hop: int) -> torch.Tensor:
    """(B, L) + per-utterance lengths -> (B, T, n_fft) overlapping frames.

    Fast path (the reference config, n_fft == 2*hop): frame t is
    [block_{t-1} | block_t] of hop-sized blocks after a one-block left
    reflect pad; only each utterance's frame len // hop crosses its
    true length and is fixed up with one (B, n_fft) gather.
    """
    b, l = waves.shape
    t_max = num_frames(l, hop)
    if n_fft != 2 * hop or l % hop != 0:
        return _frame_gather(waves, lengths, n_fft, hop, t_max)

    left = waves[:, 1: hop + 1].flip(1)
    padded = torch.cat([left, waves, waves.new_zeros(b, hop)], dim=1)
    blocks = padded.reshape(b, l // hop + 2, hop)
    frames = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=-1)[:, :t_max]

    t_last = torch.minimum(lengths // hop, torch.full_like(lengths, t_max - 1))
    pos = (t_last[:, None] * hop
           + torch.arange(n_fft, device=waves.device)[None, :] - n_fft // 2)
    last_frame = torch.gather(waves, 1, _reflect(pos, lengths, l))
    onehot = (torch.arange(t_max, device=waves.device)[None, :]
              == t_last[:, None])[:, :, None]
    return torch.where(onehot, last_frame[:, None, :], frames)


@functools.lru_cache(maxsize=16)
def _device_consts(window: str, n_fft: int, device: torch.device):
    """The window and the DFT basis on ``device``, copied there once: a
    blocking copy on every call would make each step wait for the card.
    Made outside inference mode, so that any caller may use them."""
    with torch.inference_mode(False):
        return (torch.from_numpy(_window_np(window, n_fft)).to(device),
                torch.from_numpy(_dft_mat_combined(n_fft)).to(device))


def log_spectrogram(waves: torch.Tensor, lengths: torch.Tensor,
                    cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded waveform batch -> normalized log-spectrogram batch.

    Args:
      waves: (B, L_max) float32 in [-1, 1], zero-padded past ``lengths``.
      lengths: (B,) integer true sample counts.
      cfg: FrontendConfig.

    Returns:
      feats: (B, T_max, F) float32, padded frames zeroed.
      feat_lengths: (B,) int64 valid frame counts (1 + len//hop).
    """
    waves = waves.to(torch.float32)
    lengths = lengths.to(device=waves.device, dtype=torch.int64)
    dev = waves.device
    frames = frame_signal(waves, lengths, cfg.n_fft, cfg.hop)
    window, dft = _device_consts(cfg.window, cfg.n_fft, dev)
    frames = frames * window
    z = torch.matmul(frames, dft)
    f = cfg.n_features
    re, im = z[..., :f], z[..., f:]
    feats = torch.log1p(torch.sqrt(re * re + im * im + 1e-30))

    feat_lengths = num_frames(lengths, cfg.hop)
    t_max = feats.shape[1]
    mask = (torch.arange(t_max, device=dev)[None, :]
            < feat_lengths[:, None])[:, :, None].to(feats.dtype)

    if cfg.normalize:
        # denom counts valid (frame, bin) cells: n_valid_frames * F
        denom = (feat_lengths.to(feats.dtype) * feats.shape[-1]).clamp(min=1.0)
        masked = feats * mask
        mean = masked.sum(dim=(1, 2)) / denom
        var = (masked * masked).sum(dim=(1, 2)) / denom - mean * mean
        std = torch.sqrt(var.clamp(min=1e-10))
        feats = (feats - mean[:, None, None]) / std[:, None, None]

    return feats * mask, feat_lengths


def corpus_feature_stats(manifest_path: str, cfg: FrontendConfig,
                         max_utts: int = 256,
                         seed: int = 0) -> tuple[float, float]:
    """Scalar (mean, var) of the un-normalized log1p spectrogram over a
    sample of a manifest's utterances (a copy of
    ``tpuasr/audio/frontend.py:264``): the corpus statistics that prime
    the streaming step's causal normalization (``stream._init_carry``
    ``prime_stats``). Pure NumPy on the host, the same sampling
    (``RandomState(seed).choice``), padding and sums."""
    import csv

    from tpuasr_torch.audio.io import load_audio

    with open(manifest_path) as f:
        rows = [r for r in csv.reader(f) if r]
    if len(rows) > max_utts:
        rng = np.random.RandomState(seed)
        rows = [rows[i] for i in
                rng.choice(len(rows), max_utts, replace=False)]
    win = _window_np(cfg.window, cfg.n_fft)
    cos_m, sin_m = _dft_mats(cfg.n_fft)
    cnt = 0
    s1 = 0.0
    s2 = 0.0
    for r in rows:
        wave = np.asarray(load_audio(r[0], cfg.sample_rate), np.float32)
        t_f = 1 + len(wave) // cfg.hop
        half = cfg.n_fft // 2
        padded = np.concatenate([wave[1:half + 1][::-1], wave,
                                 wave[-2:-half - 2:-1],
                                 np.zeros(cfg.n_fft, np.float32)])
        frames = np.stack([padded[i * cfg.hop: i * cfg.hop + cfg.n_fft]
                           for i in range(t_f)]) * win
        re = frames @ cos_m
        im = frames @ sin_m
        feats = np.log1p(np.sqrt(re * re + im * im + 1e-30))
        cnt += feats.size
        s1 += float(feats.sum())
        s2 += float((feats * feats).sum())
    mean = s1 / max(cnt, 1)
    var = max(s2 / max(cnt, 1) - mean * mean, 1e-10)
    return mean, var
