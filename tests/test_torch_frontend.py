"""tpuasr_torch.audio.frontend vs tpuasr.audio.frontend on ragged
batches: both framing paths, normalization on and off, int16 input.

Both packages are held to one float64 numpy oracle, element by element,
within a bound derived from float32 rounding, and to each other within
the sum of their bounds. A fixed 1e-5 tolerance is not safe here: the
error of a bin is set by the 320- (or 400-) term f32 DFT sum, whose
rounding scales with sum_n |x_n w_n| (about 40 for these frames) and not
with the bin's own magnitude, so a near-zero bin's log1p can move by
~1e-4 when a BLAS picks another blocking of the sum; the per-utterance
normalization then divides by the utterance's std (0.4-0.55 here).
Such a move touches a few elements only (3 of 19964 in the one run
that showed it), so 99.9% of the elements must still agree to 1e-5.

The bound is the probabilistic one for a dot product of n f32 terms,
lam * sqrt(n) * u * sum |terms| (u = 2**-24, lam = 5; Higham and Mary,
SIAM J. Sci. Comput. 2019), carried through log1p (derivative
1 / (1 + |X|)) and the normalization (its mean and second moment are
f32 sums over the N = frames * bins valid cells of the utterance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.audio.frontend import log_spectrogram as jax_log_spectrogram
from tpuasr.train.step import _waves_to_float as jax_waves_to_float
from tpuasr_torch.audio.frontend import FrontendConfig, log_spectrogram
from tpuasr_torch.train.step import _waves_to_float

U32 = 2.0 ** -24  # unit roundoff of float32
LAM = 5.0


def _batch(length, lengths, int16=False, seed=0):
    rng = np.random.RandomState(seed)
    waves = np.zeros((len(lengths), length), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = 0.3 * rng.randn(n)
    if int16:
        waves = (waves * 32767).astype(np.int16)
    return waves, np.asarray(lengths, np.int32)


def _oracle(waves, lengths, cfg):
    """float64 features and each element's f32 rounding bound."""
    x = waves.astype(np.float64)
    if waves.dtype == np.int16:
        x = x / 32768.0
    n_fft, hop, nf = cfg.n_fft, cfg.hop, cfg.n_features
    b, l = x.shape
    t_max = 1 + l // hop
    # librosa center=True framing, reflecting at 0 and at each length - 1
    pos = np.abs(np.arange(t_max)[:, None] * hop + np.arange(n_fft) - n_fft // 2)
    right = np.maximum(lengths - 1, 0)[:, None, None]
    pos = np.clip(np.where(pos > right, 2 * right - pos, pos), 0, l - 1)
    n = np.arange(n_fft)
    win = 0.54 - 0.46 * np.cos(2 * np.pi * n / n_fft)  # periodic hamming
    frames = np.take_along_axis(x[:, None, :], pos, axis=-1) * win
    ang = 2 * np.pi * n[:, None] * np.arange(nf)[None, :] / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    re, im = frames @ cos, frames @ sin
    mag = np.sqrt(re * re + im * im + 1e-30)  # as both packages define it
    feats = np.log1p(mag)
    # DFT rounding, through log1p
    dft_err = LAM * np.sqrt(n_fft) * U32 * (np.abs(frames) @ (np.abs(cos) + np.abs(sin)))
    err = dft_err / (1.0 + mag) + 4 * U32 * feats
    feat_lengths = 1 + lengths // hop
    mask = (np.arange(t_max)[None, :] < feat_lengths[:, None])[:, :, None]
    if cfg.normalize:
        cells = np.maximum(feat_lengths * nf, 1)[:, None, None]
        mean = (feats * mask).sum((1, 2), keepdims=True) / cells
        sq = (feats * feats * mask).sum((1, 2), keepdims=True) / cells
        std = np.sqrt(np.maximum(sq - mean * mean, 1e-10))
        y = (feats - mean) / std
        # the f32 sums of the mean and of the second moment
        sum_err = LAM * np.sqrt(cells) * U32
        d_mean = sum_err * mean + (err * mask).sum((1, 2), keepdims=True) / cells
        d_var = sum_err * sq + 2 * mean * d_mean + 2 * (np.abs(feats) * err * mask).sum(
            (1, 2), keepdims=True) / cells
        err = (err + d_mean + np.abs(y) * d_var / (2 * std)) / std + 4 * U32 * np.abs(y)
        feats = y
    return feats * mask, err * mask, feat_lengths


@pytest.mark.parametrize("length,window_size,normalize,int16", [
    pytest.param(4800, 0.02, True, False, id="fast-path"),
    pytest.param(4800, 0.02, False, False, id="fast-path-no-norm"),
    pytest.param(4800, 0.02, True, True, id="fast-path-int16"),
    pytest.param(4875, 0.02, True, False, id="gather-path-ragged-L"),
    pytest.param(4875, 0.02, False, True, id="gather-path-ragged-L-no-norm-int16"),
    pytest.param(4800, 0.025, True, False, id="gather-path-nfft400"),
    pytest.param(4800, 0.025, False, False, id="gather-path-nfft400-no-norm"),
])
def test_log_spectrogram_matches_jax(length, window_size, normalize, int16):
    waves, lengths = _batch(length, [length, 3001, 0, 161], int16)
    kw = dict(window_size=window_size, normalize=normalize)
    f_j, l_j = jax_log_spectrogram(jax_waves_to_float(jnp.asarray(waves)),
                                   jnp.asarray(lengths), JaxFrontendConfig(**kw))
    f_t, l_t = log_spectrogram(_waves_to_float(torch.from_numpy(waves)),
                               torch.from_numpy(lengths), FrontendConfig(**kw))
    want, bound, want_lengths = _oracle(waves, lengths, FrontendConfig(**kw))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_array_equal(l_t.numpy(), want_lengths)
    assert f_t.dtype == torch.float32 and f_t.shape == f_j.shape == want.shape
    f_t, f_j = f_t.numpy().astype(np.float64), np.asarray(f_j, np.float64)
    for name, got in (("port", f_t), ("jax", f_j)):
        excess = np.abs(got - want) - bound
        assert excess.max() <= 0, (name, np.unravel_index(excess.argmax(), excess.shape))
    assert (np.abs(f_t - f_j) <= 2 * bound).all()
    # the bound is worst-case-like; another blocking of the DFT sum moves
    # only a few ill-conditioned elements, so 99.9% stay within 1e-5
    assert np.quantile(np.abs(f_t - f_j), 0.999) <= 1e-5


def test_config_dict_round_trips_with_jax():
    d = FrontendConfig(window="hann", normalize=False).to_dict()
    assert JaxFrontendConfig.from_dict(d).to_dict() == d
    assert FrontendConfig.from_dict(JaxFrontendConfig().to_dict()) == FrontendConfig()
