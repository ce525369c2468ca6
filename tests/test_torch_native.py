"""The port's C++ host beam (``tpuasr_torch/decode/native.py``) vs
tpuasr's native decoder and vs the port's Python host beam, on the CPU:
texts, offsets, n-best scores and frames, streaming sessions, the LM
binary's bytes and the native edit distance.

tpuasr's decoder runs on a private build of its source
(``torch_helpers.use_private_tpuasr_native``); the port never reads
``native/``.
"""

import numpy as np
import pytest
import torch

import tpuasr.decode.native as jnative
from torch_helpers import one_intra_op_thread, use_private_tpuasr_native  # noqa: F401
from tpuasr.decode import metrics as jmetrics
from tpuasr.decode.lm import train_ngram as jax_train_ngram
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr_torch.decode import metrics, native
from tpuasr_torch.decode.beam_host import BeamCTCDecoder
from tpuasr_torch.decode.lm import train_ngram
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.ops import _build

ABC = Alphabet(labels="_AB C")
JABC = JaxAlphabet(labels="_AB C")
LINES = ["AB C AB", "AB AB", "C AB C"]


@pytest.fixture(scope="module", autouse=True)
def tpuasr_native(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_private_tpuasr_native(tmp_path_factory.mktemp("jax_native"), mp)
        yield


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native_lm") / "lm.arpa")
    train_ngram(LINES, order=2).save(path)
    return path


def _logits(seed, b, t, scale=1.5):
    return (np.random.RandomState(seed).randn(b, t, 5) * scale).astype(np.float32)


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_decode_matches_tpuasr_and_the_host_beam(with_lm, arpa):
    """Texts and per-char offsets: the port's C++ decoder, tpuasr's, and
    the port's Python host beam agree exactly."""
    kw = dict(lm_path=arpa, alpha=1.0, beta=0.5) if with_lm else {}
    logits = _logits(5, 4, 18)
    lengths = np.array([18, 14, 9, 4], np.int32)
    got = native.NativeBeamDecoder(ABC, beam_width=8, num_processes=2, **kw).decode(
        torch.from_numpy(logits), torch.from_numpy(lengths), return_offsets=True)
    want = jnative.NativeBeamDecoder(JABC, beam_width=8, num_processes=2, **kw).decode(
        logits, lengths, return_offsets=True)
    host = BeamCTCDecoder(ABC, beam_width=8, **kw).decode(logits, lengths,
                                                           return_offsets=True)
    assert got[0] == want[0] == host[0] and any(got[0])
    for g, w, h in zip(got[1], want[1], host[1]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)
    # numpy logits, and texts alone
    assert native.NativeBeamDecoder(ABC, beam_width=8, **kw).decode(logits, lengths) == got[0]


def test_lm_changes_the_text(arpa):
    probs = np.full((3, 5), 1e-6)
    probs[0, 1], probs[0, 4] = 0.49, 0.51
    probs[1, 2] = 1.0
    probs[2, 3] = 1.0
    logits = np.log(probs / probs.sum(-1, keepdims=True)).astype(np.float32)[None]
    lengths = np.array([3], np.int32)
    assert native.NativeBeamDecoder(ABC, beam_width=8).decode(logits, lengths)[0] \
        .startswith("CB")
    assert native.NativeBeamDecoder(ABC, lm_path=arpa, alpha=2.0, beta=0.0,
                                    beam_width=8).decode(logits, lengths)[0].startswith("AB")


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_nbest_matches_tpuasr_and_the_host_beam(with_lm, arpa):
    """Every beam best-first: the same texts and frames as tpuasr's C++
    decoder and the port's host beam; scores equal tpuasr's to f32
    rounding (the log-softmax before the call is torch's, not JAX's) and
    the host beam's (f64) to 2e-5."""
    kw = dict(lm_path=arpa, alpha=1.0, beta=0.5) if with_lm else {}
    logits = _logits(9, 3, 14)
    lengths = np.array([14, 10, 6], np.int32)
    dec = native.NativeBeamDecoder(ABC, beam_width=6, **kw)
    got = dec.decode_nbest(logits, lengths)
    want = jnative.NativeBeamDecoder(JABC, beam_width=6, **kw).decode_nbest(logits, lengths)
    host = BeamCTCDecoder(ABC, beam_width=6, **kw).decode_nbest(logits, lengths)
    top1 = dec.decode(logits, lengths)
    for i in range(3):
        assert [r[0] for r in got[i]] == [r[0] for r in want[i]] == [r[0] for r in host[i]]
        for g, w, h in zip(got[i], want[i], host[i]):
            np.testing.assert_allclose(g[1], w[1], rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(g[1], h[1], rtol=2e-5, atol=2e-5)
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[2], h[2])
        scores = [r[1] for r in got[i]]
        assert scores == sorted(scores, reverse=True)
        assert got[i][0][0].strip() == top1[i]
    assert [len(r) for r in dec.decode_nbest(logits, lengths, n_best=2)] == [2, 2, 2]


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_session_matches_batch_and_tpuasr(with_lm):
    """A session fed in two pieces ends where the batch decoder does, and
    its prefix and best readouts equal tpuasr's session on the same rows."""
    lm = train_ngram(LINES, order=2) if with_lm else None
    jlm = jax_train_ngram(LINES, order=2) if with_lm else None
    kw = dict(alpha=1.0, beta=0.5) if with_lm else {}
    logits = _logits(6, 1, 16, scale=2.0)[0]
    logprobs = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    sess = native.NativeBeamSession(ABC, lm=lm, beam_width=8, **kw)
    jsess = jnative.NativeBeamSession(JABC, lm=jlm, beam_width=8, **kw)
    for s in (sess, jsess):
        s.feed(logprobs[:7])
    p_ids, p_frames = sess.prefix_with_frames()
    j_ids, j_frames = jsess.prefix_with_frames()
    np.testing.assert_array_equal(p_ids, j_ids)
    np.testing.assert_array_equal(p_frames, j_frames)
    assert len(p_ids) == len(p_frames)
    np.testing.assert_array_equal(sess.prefix(), p_ids)
    for s in (sess, jsess):
        s.feed(logprobs[7:])
    ids, frames, score = sess.best_with_frames()
    j_ids, j_frames, j_score = jsess.best_with_frames()
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(frames, j_frames)
    assert score == j_score and sess.best()[1] == score

    if with_lm:  # the batch decoder reads the LM from a file
        return
    texts, offs = native.NativeBeamDecoder(ABC, beam_width=8).decode(
        logits[None], np.array([16], np.int32), return_offsets=True)
    text = ABC.decode([int(x) for x in ids])
    lpad = len(text) - len(text.lstrip())
    rpad = len(text) - len(text.rstrip())
    assert text.strip() == texts[0]
    np.testing.assert_array_equal(frames[lpad:len(frames) - rpad], offs[0])
    sess.reset()  # a reset session decodes afresh
    sess.feed(logprobs)
    np.testing.assert_array_equal(sess.best_with_frames()[0], ids)


def test_lm_binary_bytes_equal_tpuasr(tmp_path, arpa):
    """write_lm_binary writes tpuasr's bytes, so the ``.tpuasrlm`` cache
    beside an ARPA file serves both packages."""
    lines = LINES + ["OLA MUNDO", "BOM DIA MUNDO", "TUDO BEM"]
    ours, theirs = tmp_path / "a.tpuasrlm", tmp_path / "b.tpuasrlm"
    native.write_lm_binary(train_ngram(lines, order=3), str(ours))
    jnative.write_lm_binary(jax_train_ngram(lines, order=3), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    native.NativeBeamDecoder(ABC, lm_path=arpa)  # writes the cache beside the ARPA
    cache = arpa + ".tpuasrlm"
    jnative.write_lm_binary(jnative.ArpaLM.load(arpa), str(theirs))
    with open(cache, "rb") as f:
        assert f.read() == theirs.read_bytes()


def test_kenlm_binary_is_refused(tmp_path):
    path = tmp_path / "lm.binary"
    path.write_bytes(b"mmap lm http://kheafield.com/code format version 5\0" + bytes(64))
    for cls, abc in ((native.NativeBeamDecoder, ABC), (jnative.NativeBeamDecoder, JABC)):
        with pytest.raises(ValueError, match="enumerable n-grams"):
            cls(abc, lm_path=str(path))


def test_inputs_are_checked_before_the_call():
    dec = native.NativeBeamDecoder(ABC)
    logits = _logits(1, 2, 6)
    for lengths in ([7, 2], [6], [-1, 2]):
        with pytest.raises(ValueError, match="lengths"):
            dec.decode(logits, np.array(lengths, np.int32))
    with pytest.raises(ValueError, match="want"):
        dec.decode_nbest(logits[..., :4], np.array([6, 6], np.int32))
    with pytest.raises(ValueError, match="want"):
        native.NativeBeamSession(ABC).feed(np.zeros((3, 4), np.float32))


def test_native_edit_distance_equals_numpy(monkeypatch):
    """The C++ distance behind ``levenshtein`` equals the numpy recurrence
    (its plain version) and tpuasr's, on seeded strings and word lists."""
    assert metrics._load_native()  # built, not the fallback
    monkeypatch.setattr(jmetrics, "_native_dist", False)  # tpuasr's numpy path
    rng = np.random.RandomState(0)
    for _ in range(60):
        a = "".join(rng.choice(list("ab c"), size=rng.randint(0, 30)))
        b = "".join(rng.choice(list("abc "), size=rng.randint(0, 30)))
        for x, y in ((a, b), (a.split(), b.split())):
            d = metrics.levenshtein(x, y)
            assert d == jmetrics.levenshtein(x, y)
            if len(x) and len(y):
                assert d == metrics._lev_numpy(*metrics._ids(*sorted((x, y), key=len,
                                                                      reverse=True)))
    meter = metrics.ErrorRateMeter()
    meter.update("OLA MUNDU", "OLA MUNDO")
    assert (meter.wer, meter.cer) == (50.0, 100.0 / 9)


def test_library_is_built_under_build_from_the_ports_source():
    """The port compiles its own copy of the C++ source into ``build/``
    (a content-hashed name) and never reads ``native/``."""
    lib = native._load_lib()
    path = _build.host_library_path(native.SOURCE)
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert lib._name == str(path) and lib.tpuasr_abi_version() == native.ABI_VERSION
    assert native.SOURCE.parts[-4:] == ("tpuasr_torch", "decode", "csrc", "ctc_beam.cpp")


@pytest.mark.parametrize("seed", range(4))
def test_exact_ties_break_alike(seed):
    """Logits on a coarse grid (as bf16 logits are): classes often share
    a log-probability, and two extensions of one beam then score exactly
    alike at the width cut. The C++ and the Python searches break such
    ties alike: the same n-best texts and frames, and the same stream."""
    rng = np.random.RandomState(seed)
    logits = (np.round(rng.randn(3, 30, 5) * 4) / 2).astype(np.float32)
    lengths = np.array([30, 24, 17], np.int32)
    got = native.NativeBeamDecoder(ABC, beam_width=4).decode_nbest(logits, lengths)
    want = BeamCTCDecoder(ABC, beam_width=4).decode_nbest(logits, lengths)
    for g, w in zip(got, want):
        assert [r[0] for r in g] == [r[0] for r in w]
        for rg, rw in zip(g, w):
            np.testing.assert_allclose(rg[1], rw[1], rtol=2e-5, atol=2e-5)
            np.testing.assert_array_equal(rg[2], rw[2])
    from tpuasr_torch.decode.beam_host import beam_init, beam_results, beam_step

    lp = torch.log_softmax(torch.from_numpy(logits[0]), -1).numpy()
    sess, beams = native.NativeBeamSession(ABC, beam_width=4), beam_init()
    for t in range(30):
        sess.feed(lp[t:t + 1])
        beams = beam_step(beams, lp[t].astype(np.float64), ABC, 4, t=t)
        host_best = beam_results(beams, ABC, with_offsets=True)[0]
        ids, frames, _ = sess.best_with_frames()
        assert ABC.decode([int(x) for x in ids]) == host_best[0]
        np.testing.assert_array_equal(frames, host_best[2])


def test_a_failed_compile_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        _build.build_host(bad)
    assert not _build.host_library_path(bad).exists()


def test_sessions_share_one_lm_handle():
    """The first session built from an ArpaLM converts it once; later
    sessions borrow the same handle."""
    lm = train_ngram(LINES, order=2)
    first = native.NativeBeamSession(ABC, lm=lm)
    second = native.NativeBeamSession(ABC, lm=lm)
    assert first._lm == second._lm == lm._tpuasr_native_handle
