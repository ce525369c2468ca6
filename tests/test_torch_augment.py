"""tpuasr_torch.audio.augment against tpuasr.audio.augment.

JAX draws through jax.random keys and the port through torch
generators, so the two never draw the same numbers. Each test therefore
reproduces the JAX function's own draws (the same key splits as
``tpuasr/audio/augment.py``, ``AugmentFn.waves`` and the train step's
split), feeds those parameters to the port's apply, and holds the
result to the JAX function's output: float32 within atol 1e-5 (both
run the same f32 operations; a sum of squares or an interpolation may
round in another order, ~1e-7 here), lengths equal. The port's draws
are checked apart: in range, and the same bits from the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr.audio import augment as jaug
from tpuasr.cli import noise_inject as jax_noise_inject
from tpuasr_torch.audio import augment as aug
from tpuasr_torch.cli import noise_inject

ATOL = 1e-5
L_MAX = 8000
LENGTHS = np.array([8000, 6123, 4000, 513, 1], np.int32)


def _waves(seed=0, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    w = np.zeros((len(lengths), L_MAX), np.float32)
    for i, n in enumerate(lengths):
        w[i, :n] = 0.3 * rng.randn(n)
    return w


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tempo_gain_draws(rng, b, cfg):
    k_rate, k_gain = jax.random.split(rng)
    rates = jax.random.uniform(k_rate, (b,), minval=cfg.tempo_low, maxval=cfg.tempo_high)
    gains = jax.random.uniform(k_gain, (b,), minval=cfg.gain_db_low, maxval=cfg.gain_db_high)
    return np.asarray(rates), np.asarray(gains)


def _jax_noise_draws(rng, b, n, cfg):
    k_off, k_lvl, k_on = jax.random.split(rng, 3)
    return (np.asarray(jax.random.randint(k_off, (b,), 0, n)),
            np.asarray(jax.random.uniform(k_lvl, (b,), minval=cfg.noise_min,
                                          maxval=cfg.noise_max)),
            np.asarray(jax.random.bernoulli(k_on, cfg.noise_prob, (b,))))


def _jax_spec_draws(rng, feat_lengths, t_max, f, cfg):
    b = len(feat_lengths)
    keys = jax.random.split(rng, 4)
    freq, time = [], []
    for i in range(cfg.n_freq_masks):
        k1, k2 = jax.random.split(jax.random.fold_in(keys[0], i))
        width = jax.random.randint(k1, (b,), 0, cfg.freq_mask_width + 1)
        start = jax.random.randint(k2, (b,), 0, jnp.maximum(f - width, 1))
        freq.append((_t(np.asarray(start)).long(), _t(np.asarray(width)).long()))
    fl = jnp.asarray(feat_lengths)
    for i in range(cfg.n_time_masks):
        k1, k2 = jax.random.split(jax.random.fold_in(keys[1], i))
        max_w = jnp.maximum((fl.astype(jnp.float32) * cfg.time_mask_frac).astype(jnp.int32), 1)
        width = jax.random.randint(k1, (b,), 0, t_max) % (max_w + 1)
        start = jax.random.randint(k2, (b,), 0, t_max) % jnp.maximum(fl - width, 1)
        time.append((_t(np.asarray(start)).long(), _t(np.asarray(width)).long()))
    return freq, time


def _close(got, want_waves, want_lengths=None, got_lengths=None):
    np.testing.assert_allclose(got.numpy(), np.asarray(want_waves), rtol=0, atol=ATOL)
    if want_lengths is not None:
        np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(want_lengths))


def test_speed_and_gain_matches_jax():
    cfg = jaug.AugmentConfig()
    waves = _waves(1)
    rng = jax.random.PRNGKey(3)
    want, want_len = jaug.speed_and_gain(rng, jnp.asarray(waves), jnp.asarray(LENGTHS), cfg)
    rates, gains = _jax_tempo_gain_draws(rng, len(LENGTHS), cfg)
    got, got_len = aug.speed_and_gain(_t(rates), _t(gains), _t(waves), _t(LENGTHS))
    _close(got, want, want_len, got_len)


@pytest.mark.parametrize("rates", [[0.85] * 5, [1.0] * 5, [1.15] * 5,
                                   [0.85, 0.93, 1.0, 1.07, 1.15]],
                         ids=["0.85", "1.0", "1.15", "ragged"])
def test_wsola_tempo_matches_jax(rates):
    waves = _waves(2)
    rates = np.asarray(rates, np.float32)
    want, want_len = jaug.wsola_tempo(jnp.asarray(rates), jnp.asarray(waves),
                                      jnp.asarray(LENGTHS))
    got, got_len = aug.wsola_tempo(_t(rates), _t(waves), _t(LENGTHS))
    _close(got, want, want_len, got_len)


@pytest.mark.parametrize("mode", ["wsola", "resample"])
def test_tempo_and_gain_matches_jax(mode):
    cfg = jaug.AugmentConfig(tempo_mode=mode)
    waves = _waves(3)
    rng = jax.random.PRNGKey(11)
    want, want_len = jaug.tempo_and_gain(rng, jnp.asarray(waves), jnp.asarray(LENGTHS), cfg)
    rates, gains = _jax_tempo_gain_draws(rng, len(LENGTHS), cfg)
    got, got_len = aug.tempo_and_gain(_t(rates), _t(gains), _t(waves), _t(LENGTHS),
                                      aug.AugmentConfig(tempo_mode=mode))
    _close(got, want, want_len, got_len)


def test_inject_noise_matches_jax_with_rows_on_and_off():
    cfg = jaug.AugmentConfig(noise_prob=0.5, noise_min=0.1, noise_max=0.9)
    waves = _waves(4)
    bank = (0.2 * np.random.RandomState(5).randn(5003)).astype(np.float32)
    rng = jax.random.PRNGKey(2)
    want = jaug.inject_noise(rng, jnp.asarray(waves), jnp.asarray(LENGTHS),
                             jnp.asarray(bank), cfg)
    offsets, levels, on = _jax_noise_draws(rng, len(LENGTHS), len(bank), cfg)
    assert on.any() and not on.all()  # both kinds of row are exercised
    got = aug.inject_noise(_t(offsets).long(), _t(levels), _t(on), _t(waves), _t(LENGTHS),
                           _t(bank))
    _close(got, want)


def test_spec_augment_matches_jax():
    cfg = jaug.AugmentConfig(spec_augment=True, n_freq_masks=2, n_time_masks=2,
                             time_mask_frac=0.2)
    rs = np.random.RandomState(6)
    feats = rs.randn(5, 40, 161).astype(np.float32)
    feat_lengths = np.array([40, 33, 17, 2, 1], np.int32)
    rng = jax.random.PRNGKey(9)
    want = jaug.spec_augment(rng, jnp.asarray(feats), jnp.asarray(feat_lengths), cfg)
    freq, time = _jax_spec_draws(rng, feat_lengths, 40, 161, cfg)
    assert any(int(w.max()) > 0 for _, w in time)  # a time mask is not empty
    got = aug.spec_augment(freq, time, _t(feats))
    _close(got, want)


def test_augment_fn_in_the_train_step_order_matches_jax(tmp_path):
    """The step's split (rng_w, rng_f), AugmentFn.waves' split (tempo
    and gain, then noise on the new lengths), then SpecAugment on the
    frontend's features."""
    from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
    from tpuasr.audio.frontend import log_spectrogram as jax_log_spectrogram

    for i in range(2):
        wavfile.write(str(tmp_path / f"n{i}.wav"), 16000,
                      (0.3 * np.random.RandomState(i).randn(3000) * 32767).astype(np.int16))
    kw = dict(noise_dir=str(tmp_path), noise_prob=0.6, spec_augment=True)
    jfn = jaug.make_augment_fn(jaug.AugmentConfig(**kw))
    fn = aug.make_augment_fn(aug.AugmentConfig(**kw))
    waves = _waves(7)
    rng_w, rng_f = jax.random.split(jax.random.PRNGKey(21))
    jw, jl = jfn.waves(rng_w, jnp.asarray(waves), jnp.asarray(LENGTHS))
    jfeats0, jfl = jax_log_spectrogram(jw, jl, JaxFrontendConfig())
    jfeats = jfn.feats(rng_f, jfeats0, jfl)

    k1, k2 = jax.random.split(rng_w)
    rates, gains = _jax_tempo_gain_draws(k1, len(LENGTHS), jfn.cfg)
    w, lens = aug.tempo_and_gain(_t(rates), _t(gains), _t(waves), _t(LENGTHS).long(), fn.cfg)
    offsets, levels, on = _jax_noise_draws(k2, len(LENGTHS), len(jfn._bank), jfn.cfg)
    w = aug.inject_noise(_t(offsets).long(), _t(levels), _t(on), w, lens, fn.bank("cpu"))
    _close(w, jw, jl, lens)
    # SpecAugment on the JAX frontend's features (the frontend's own
    # parity is test_torch_frontend.py's)
    freq, time = _jax_spec_draws(rng_f, np.asarray(jfl), jfeats0.shape[1], jfeats0.shape[2],
                                 jfn.cfg)
    _close(aug.spec_augment(freq, time, _t(jfeats0)), jfeats)


def test_load_noise_bank_matches_jax(tmp_path):
    for i, n in enumerate((3000, 1200, 5000)):
        wavfile.write(str(tmp_path / f"n{i}.wav"), 16000,
                      (0.3 * np.random.RandomState(i).randn(n) * 32767).astype(np.int16))
    for seconds in (120.0, 0.25):
        got = aug.load_noise_bank(str(tmp_path), 16000, seconds)
        want = jaug.load_noise_bank(str(tmp_path), 16000, seconds)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="no .wav noise files"):
        aug.load_noise_bank(str(tmp_path / "none"), 16000)


def test_augment_fn_is_the_identity_when_disabled():
    fn = aug.make_augment_fn(aug.AugmentConfig(tempo_gain=False))
    gen = torch.Generator().manual_seed(0)
    waves, lengths = _t(_waves(8)), _t(LENGTHS)
    w, lens = fn.waves(gen, waves, lengths)
    assert w is waves and lens is lengths
    feats = torch.randn(2, 9, 5)
    assert fn.feats(gen, feats, torch.tensor([9, 4])) is feats


def test_draws_are_in_range_and_reproduced_from_one_seed():
    cfg = aug.AugmentConfig(n_freq_masks=2, n_time_masks=2, time_mask_frac=0.3)
    fl = torch.tensor([50, 31, 7, 1, 0] * 40)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return (*aug.draw_tempo_gain(gen, 200, cfg), *aug.draw_noise(gen, 200, 777, cfg),
                *[t for pair in sum(aug.draw_spec_augment(gen, fl, 50, 161, cfg), [])
                  for t in pair])

    a, b, c = draw(4), draw(4), draw(5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    rates, gains, offsets, levels, on, *masks = a
    assert 0.85 <= rates.min() and rates.max() < 1.15
    assert -6.0 <= gains.min() and gains.max() < 8.0
    assert 0 <= offsets.min() and offsets.max() < 777 and offsets.dtype == torch.int64
    assert 0.0 <= levels.min() and levels.max() < 0.5 and on.dtype == torch.bool
    assert 0.2 < on.float().mean() < 0.6  # Bernoulli(0.4) over 200 rows
    for start, width in zip(masks[0:4:2], masks[1:4:2]):  # frequency masks
        assert 0 <= width.min() and width.max() <= 20
        assert (start >= 0).all() and (start < (161 - width).clamp(min=1)).all()
    max_w = (fl * 0.3).long().clamp(min=1)
    for start, width in zip(masks[4::2], masks[5::2]):  # time masks
        assert (width >= 0).all() and (width <= max_w).all()
        assert (start >= 0).all() and (start < (fl - width).clamp(min=1)).all()


def test_noise_inject_cli_matches_jax(tmp_path):
    """A constant-valued noise WAV: every offset gives the same slice,
    so the two packages' different draws write the same WAV."""
    sr = 16000
    wav = tmp_path / "in.wav"
    wavfile.write(str(wav), sr, (0.3 * np.random.RandomState(1).randn(4000) * 32767
                                 ).astype(np.int16))
    noise = tmp_path / "noise.wav"
    wavfile.write(str(noise), sr, np.full(2500, 4000, np.int16))
    outs = []
    for mod, name, extra in ((noise_inject, "torch.wav", ["--device", "cpu"]),
                             (jax_noise_inject, "jax.wav", [])):
        out = tmp_path / name
        assert mod.main(["--input-path", str(wav), "--noise-path", str(noise),
                         "--output-path", str(out), "--noise-level", "0.3",
                         "--seed", "3", *extra]) == 0
        outs.append(wavfile.read(str(out)))
    (sr_t, got), (sr_j, want) = outs
    assert sr_t == sr_j == sr and got.dtype == want.dtype == np.int16
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1  # one PCM step
    assert not np.array_equal(got, wavfile.read(str(wav))[1])  # noise was mixed in
