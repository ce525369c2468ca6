"""The port's host prefix beam (tpuasr_torch.decode.beam_host) and the
long-form host decode against tpuasr's on the CPU, with and without a
word LM: texts and per-character offsets equal; scores equal within
1e-6 relative on the same log-probabilities (the same float64 Python
arithmetic), and within 1e-6 relative through the batch decoders, whose
log-softmax runs in torch on one side and in JAX on the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.decode.beam_host as jhost
from tpuasr.decode.beam import DeviceBeamDecoder as JaxDeviceBeamDecoder
from tpuasr.decode.lm import train_ngram as jax_train_ngram
from tpuasr.decode.longform import host_decode as jax_host_decode
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr_torch.decode import beam_host
from tpuasr_torch.decode.beam import DeviceBeamDecoder
from tpuasr_torch.decode.lm import train_ngram
from tpuasr_torch.decode.longform import host_decode
from tpuasr_torch.labels import Alphabet

ABC, JABC = Alphabet(labels="_AB C"), JaxAlphabet(labels="_AB C")
WORDS = ["AB C AB", "C AB", "AB AB C", "C C AB", "AB", "CA AB C"]


def _logits(seed, b, t, c=5):
    return (np.random.RandomState(seed).randn(b, t, c) * 2.5).astype(np.float32)


def _lms(with_lm):
    if not with_lm:
        return None, None
    return train_ngram(WORDS, order=3), jax_train_ngram(WORDS, order=3)


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_prefix_beam_search_equals_tpuasr(with_lm):
    lm, jlm = _lms(with_lm)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(_logits(1, 1, 18)[0]), axis=-1))
    for kw in (dict(beam_width=6), dict(beam_width=4, cutoff_top_n=3, cutoff_prob=0.9)):
        got = beam_host.prefix_beam_search(lp, ABC, lm=lm, alpha=0.9, beta=0.4, **kw)
        want = jhost.prefix_beam_search(lp, JABC, lm=jlm, alpha=0.9, beta=0.4, **kw)
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-6)
    beams = beam_host.beam_init()
    jbeams = jhost.beam_init()
    for t in range(lp.shape[0]):
        beams = beam_host.beam_step(beams, lp[t], ABC, 5, lm, 0.9, 0.4, t=t)
        jbeams = jhost.beam_step(jbeams, lp[t], JABC, 5, jlm, 0.9, 0.4, t=t)
    got = beam_host.beam_results(beams, ABC, lm, 0.9, 0.4, with_offsets=True)
    want = jhost.beam_results(jbeams, JABC, jlm, 0.9, 0.4, with_offsets=True)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == pytest.approx(w[1], rel=1e-6)
        np.testing.assert_array_equal(g[2], w[2])


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_beam_ctc_decoder_equals_tpuasr(with_lm, tmp_path):
    lm_path = None
    if with_lm:
        lm_path = str(tmp_path / "lm.arpa")
        train_ngram(WORDS, order=3).save(lm_path)
    dec = beam_host.BeamCTCDecoder(ABC, lm_path=lm_path, alpha=0.9, beta=0.4, beam_width=5)
    jdec = jhost.BeamCTCDecoder(JABC, lm_path=lm_path, alpha=0.9, beta=0.4, beam_width=5)
    logits, lengths = _logits(2, 3, 14), np.array([14, 9, 3], np.int32)
    texts, offs = dec.decode(torch.from_numpy(logits), torch.from_numpy(lengths),
                             return_offsets=True)
    jtexts, joffs = jdec.decode(jnp.asarray(logits), jnp.asarray(lengths),
                                return_offsets=True)
    assert texts == jtexts
    for a, b in zip(offs, joffs):
        np.testing.assert_array_equal(a, b)
    got = dec.decode_nbest(logits, lengths, n_best=3)
    want = jdec.decode_nbest(jnp.asarray(logits), jnp.asarray(lengths), n_best=3)
    for g, w in zip(got, want):
        assert [r[0] for r in g] == [r[0] for r in w]
        np.testing.assert_allclose([r[1] for r in g], [r[1] for r in w], rtol=1e-6)


@pytest.mark.parametrize("kind", ["beam", "beam-device", "beam-device-lm"])
def test_longform_host_decode_equals_tpuasr(kind, tmp_path):
    logits = _logits(3, 1, 40)[0]
    if kind == "beam":
        lm_path = str(tmp_path / "lm.arpa")
        train_ngram(WORDS, order=3).save(lm_path)
        dec = beam_host.BeamCTCDecoder(ABC, lm_path=lm_path, alpha=0.9, beta=0.4)
        jdec = jhost.BeamCTCDecoder(JABC, lm_path=lm_path, alpha=0.9, beta=0.4)
    else:
        lm, jlm = _lms(kind == "beam-device-lm")
        dec = DeviceBeamDecoder(ABC, beam_width=6, word_lm=lm, alpha=0.9, beta=0.4)
        jdec = JaxDeviceBeamDecoder(JABC, beam_width=6, word_lm=jlm, alpha=0.9, beta=0.4,
                                    impl="xla")
    text, frames = host_decode(dec, logits, ABC)
    jtext, jframes = jax_host_decode(jdec, logits, JABC)
    assert text == jtext
    np.testing.assert_array_equal(frames, jframes)


def test_longform_char_lm_device_decoder_raises():
    char_lm = train_ngram([" ".join(s) for s in ["ABACAB", "CAB BA"]], order=2)
    dec = DeviceBeamDecoder(ABC, char_lm=char_lm, alpha=0.5)
    with pytest.raises(ValueError, match="char-level device LM"):
        host_decode(dec, _logits(4, 1, 10)[0], ABC)
