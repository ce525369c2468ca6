"""The port's device beam search (tpuasr_torch.decode.beam and
tpuasr_torch.ops.beam) against tpuasr's on the CPU.

* The host half is bit-identical: hash math, packed LM tables (keys,
  caps, salts, values), the one-transfer output packing and the
  backtrack.
* ``beam_scan_reference`` (the plain version of K3) against
  ``tpuasr.ops.beam.beam_scan_pallas`` run in interpret mode, as
  tests/test_pallas_beam.py runs it, on the same log-probabilities:
  parents and chars equal; scores within 1e-5 (relative and absolute:
  the exp/log1p of the two frameworks may differ in the last bit, and
  the TPU kernel's char table is looked up as bf16 hi + lo halves).
* ``DeviceBeamDecoder`` against tpuasr's XLA path (``impl="xla"``):
  texts, n-best lists and offsets equal, scores within 1e-5. The XLA
  pool holds the top ``cutoff_top_n`` classes in rank order where K3's
  holds all classes in class order, so backpointers may differ there
  on exact ties; texts and scores may not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.decode.beam as jbeam
import tpuasr.ops.beam as jbeam_ops
import tpuasr_torch.decode.beam as tbeam
from tpuasr.decode.lm import train_ngram as jax_train_ngram
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr_torch.decode.lm import train_ngram
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.ops import beam as ops

ABC = Alphabet(labels="_AB C")  # blank, A, B, space, C
JABC = JaxAlphabet(labels="_AB C")
WORDS = ["AB C AB", "C AB", "AB AB C", "C C AB", "AB", "CA AB C"]
CHARS = [" ".join(s) for s in ["ABACAB", "CABBA", "BACBACABA", "ABCABA", "AB CAB"]] * 3


def _logprobs(seed, b, t, c, scale=2.0):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(b, t, c) * scale).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(lg), axis=-1))


def test_hash_math_equals_numpy():
    rng = np.random.RandomState(0)
    h = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    x = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:3], x[:3] = [0, 2**32 - 1, 2**31], [2**32 - 1, 0, 2**31 + 5]
    th, tx = torch.from_numpy(h.astype(np.int64)), torch.from_numpy(x.astype(np.int64))
    for mult in (jbeam._M1, jbeam._M2):
        np.testing.assert_array_equal(ops._mix32(th, tx, mult).numpy(),
                                      jbeam._np_mix32(h, x, mult).astype(np.int64))
    np.testing.assert_array_equal(ops._fmix32(th).numpy(),
                                  jbeam._np_fmix32(h).astype(np.int64))
    for salt in (0, 5):
        homes = [jbeam._np_home(v, 1024, salt) for v in h[:64]]
        assert [tbeam._np_home(v, 1024, salt) for v in h[:64]] == homes


@pytest.mark.parametrize("kind", ["char", "word", "word-salted"])
def test_packed_tables_equal_jax(kind, monkeypatch):
    if kind == "word-salted":
        monkeypatch.setattr(jbeam, "_PACK_SALTS", (5,))
        monkeypatch.setattr(tbeam, "_PACK_SALTS", (5,))
    lines = CHARS if kind == "char" else WORDS * 2
    lm, jlm = train_ngram(lines, order=3), jax_train_ngram(lines, order=3)
    if kind == "char":
        got, want = tbeam.pack_lm_tables(lm, ABC), jbeam.pack_lm_tables(jlm, JABC)
    else:
        got, want = (tbeam.pack_word_lm_tables(lm, ABC),
                     jbeam.pack_word_lm_tables(jlm, JABC))
    assert (got.order, got.n_probes, got.salts) == (want.order, want.n_probes, want.salts)
    if kind == "word-salted":
        assert set(got.salts) == {5}
    for field in ("keys1", "keys2", "logps", "backoffs"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape  # caps equal
            np.testing.assert_array_equal(a, b)


def test_output_packing_and_backtrack_equal_jax():
    rng = np.random.RandomState(3)
    b, t, w, c = 3, 7, 5, 44
    parents = rng.randint(0, w, size=(b, t, w)).astype(np.int8)
    chars = rng.randint(-1, c, size=(b, t, w)).astype(np.int8)
    scores = rng.randn(b, w).astype(np.float32) * 30
    scores[0, 0] = -1e30
    want = np.asarray(jbeam.pack_decode_outputs(
        jnp.asarray(parents), jnp.asarray(chars), jnp.asarray(scores)))
    got = tbeam.pack_decode_outputs(torch.from_numpy(parents), torch.from_numpy(chars),
                                    torch.from_numpy(scores)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    unpacked = tbeam.unpack_decode_outputs(got, t, w)
    for a, e in zip(unpacked, (parents, chars, scores)):
        np.testing.assert_array_equal(a, e)
    for a, e in zip(tbeam._backtrack(*unpacked), jbeam._backtrack(*unpacked)):
        np.testing.assert_array_equal(a, e)
    assert tbeam._packable(w, c) and not tbeam._packable(w, 127)


def _lm_case(mode):
    """(port kwargs, tpuasr beam_scan_pallas kwargs) for an LM mode."""
    if mode == "none":
        return {}, {}
    kind, order = mode[:-1], int(mode[-1])
    lines = CHARS if kind == "char" else WORDS
    lm, jlm = train_ngram(lines, order=order), jax_train_ngram(lines, order=order)
    common = dict(alpha=0.7, beta=0.5, space_id=ABC.space_id)
    if kind == "char":
        jt = jbeam.pack_lm_tables(jlm, JABC)
        table, k_ctx = jbeam.dense_char_lm_table(jt, 5)
        return (dict(char_tables=ops.flat_tables(tbeam.pack_lm_tables(lm, ABC), "cpu"),
                     **common),
                dict(char_table=jnp.asarray(table), ctx_len=k_ctx, **common))
    return (dict(word_tables=ops.flat_tables(tbeam.pack_word_lm_tables(lm, ABC), "cpu"),
                 **common),
            dict(word_tables=jbeam.pack_word_lm_tables(jlm, JABC), **common))


@pytest.mark.parametrize("mode", ["none", "char2", "char3", "word2", "word3"])
def test_reference_matches_pallas_interpret(mode, monkeypatch):
    monkeypatch.setattr(jbeam_ops, "INTERPRET", True)
    b, t, c, w = 3, 12, 5, 5
    lp = _logprobs(40 + len(mode), b, t, c)
    lengths = np.array([12, 7, 0], np.int32)
    kw, jkw = _lm_case(mode)
    common = dict(beam_width=w, blank_id=0, cutoff_top_n=4)
    parents, chars, scores = ops.beam_scan_reference(
        torch.from_numpy(lp), torch.from_numpy(lengths), **common, **kw)
    jp, jc, js = jbeam_ops.beam_scan_pallas(jnp.asarray(lp), jnp.asarray(lengths),
                                            **common, **jkw)
    assert parents.dtype == torch.int8 and np.asarray(jp).dtype == np.int8
    np.testing.assert_array_equal(parents.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(chars.numpy(), np.asarray(jc))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    assert (chars[2] == -1).all()  # the length-0 row stays empty


def _wide_word_lm():
    """A word trigram over the default alphabet whose unigram and
    bigram caps exceed 8192 (tpuasr's wide-table threshold), made the
    way bench.py makes its large-vocabulary LM."""
    rng = np.random.RandomState(0)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    vocab = sorted({"".join(rng.choice(letters, size=rng.randint(3, 8)))
                    for _ in range(8400)})[:7000]
    order = rng.permutation(len(vocab))
    return [" ".join(vocab[i] for i in order[s:s + 6]) for s in range(0, len(order), 6)]


@pytest.mark.parametrize("mode", ["none", "char", "word", "word-wide-caps"])
def test_decoder_matches_xla(mode):
    if mode == "word-wide-caps":
        alphabet, jalphabet = Alphabet(), JaxAlphabet()
        c = alphabet.size
        lines = _wide_word_lm()
    else:
        alphabet, jalphabet, c = ABC, JABC, 5
        lines = CHARS if mode == "char" else WORDS
    kw = dict(beam_width=5, alpha=0.9, beta=0.4)
    if mode != "none":
        lm, jlm = train_ngram(lines, order=3), jax_train_ngram(lines, order=3)
        key = "char_lm" if mode == "char" else "word_lm"
        kw_p, kw_j = {key: lm, **kw}, {key: jlm, **kw}
    else:
        kw_p = kw_j = kw
    port = tbeam.DeviceBeamDecoder(alphabet, **kw_p)
    xla = jbeam.DeviceBeamDecoder(jalphabet, impl="xla", **kw_j)
    if mode == "word-wide-caps":
        caps = [len(k) for k in port._word_tables.keys1]
        assert max(caps) > jbeam.DeviceBeamDecoder.MAX_KERNEL_WORD_CAP
    rng = np.random.RandomState(len(mode))
    logits = (rng.randn(3, 16, c) * 2.5).astype(np.float32)
    lengths = np.array([16, 11, 4], np.int32)
    got = port.decode_nbest(torch.from_numpy(logits), torch.from_numpy(lengths))
    want = xla.decode_nbest(jnp.asarray(logits), jnp.asarray(lengths))
    for g, e in zip(got, want):
        assert [r[0] for r in g] == [r[0] for r in e]
        for rg, re in zip(g, e):
            np.testing.assert_allclose(rg[1], re[1], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(rg[2], re[2])
    texts, offs = port.decode(logits, lengths, return_offsets=True)
    jtexts, joffs = xla.decode(jnp.asarray(logits), jnp.asarray(lengths), return_offsets=True)
    assert texts == jtexts
    for a, e in zip(offs, joffs):
        np.testing.assert_array_equal(a, e)


@pytest.mark.parametrize("mode", ["none", "char", "word"])
def test_stateful_chunks_equal_one_call(mode):
    b, t, c, w = 3, 24, 5, 5
    lp = torch.from_numpy(_logprobs(7, b, t, c))
    lengths = torch.tensor([24, 24, 17], dtype=torch.int32)
    kw = {"none": {}, "char": _lm_case("char3")[0], "word": _lm_case("word3")[0]}[mode]
    kw.update(beam_width=w, blank_id=0)
    p0, c0, s0, st0 = ops.beam_scan_reference(lp, lengths, return_state=True, **kw)
    ring = 0 if mode == "none" else 2  # trigrams: a 2-token ring or 2-char context
    state = ops.make_beam_state(b, w, lm_mode=mode, ring_len=ring)
    ps, cs = [], []
    for t0 in range(0, t, 6):  # 4 chunks
        chunk_len = torch.clamp(lengths - t0, 0, 6).to(torch.int32)
        pi, ci, scores, state = ops.beam_scan_reference(
            lp[:, t0:t0 + 6].contiguous(), chunk_len, state=state, return_state=True, **kw)
        ps.append(pi)
        cs.append(ci)
    assert torch.equal(torch.cat(ps, 1), p0) and torch.equal(torch.cat(cs, 1), c0)
    assert torch.equal(scores, s0)
    for a, e in zip(state, st0):
        assert a.dtype == e.dtype and torch.equal(a, e)


def test_cutoff_pruning_matches_xla():
    b, t, c = 3, 14, 5
    rng = np.random.RandomState(9)
    logits = (rng.randn(b, t, c) * 3).astype(np.float32)
    lengths = np.array([14, 9, 5], np.int32)
    for kw in (dict(beam_width=5, cutoff_prob=0.9),
               dict(beam_width=4, cutoff_top_n=3, cutoff_prob=0.8, prune_logp=-3.0)):
        port = tbeam.DeviceBeamDecoder(ABC, **kw)
        xla = jbeam.DeviceBeamDecoder(JABC, impl="xla", **kw)
        got = port.decode_nbest(logits, lengths)
        want = xla.decode_nbest(jnp.asarray(logits), jnp.asarray(lengths))
        for g, e in zip(got, want):
            assert [r[0] for r in g] == [r[0] for r in e]
            np.testing.assert_allclose([r[1] for r in g], [r[1] for r in e],
                                       rtol=1e-5, atol=1e-5)


def test_wrapper_routes_and_refuses():
    lp = torch.from_numpy(_logprobs(1, 2, 5, 5))
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    before = ops.beam_scan.launches
    got = ops.beam_scan(lp, lengths, beam_width=3, blank_id=0)
    want = ops.beam_scan_reference(lp, lengths, beam_width=3, blank_id=0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.beam_scan.launches == before  # the CPU never launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.beam_scan(lp.to("meta"), lengths.to("meta"), beam_width=3, blank_id=0)
    with pytest.raises(ValueError, match="beam_width"):
        ops.beam_scan_reference(lp, lengths, beam_width=0, blank_id=0)
    # K3 has no limits left: no refusal, and the state it reads holds a
    # char context of any order as class ids (one int32 row each) and a
    # word ring of any length
    assert not hasattr(ops, "k3_refusal")
    assert ops._out_dtype(127, 126) == torch.int8 and ops._out_dtype(254, 126) == torch.int32
    assert ops._out_dtype(255, 5) == torch.int32 and ops._out_dtype(10, 127) == torch.int32
    st = ops.make_beam_state(2, 3, lm_mode="char", ring_len=11)  # a 12-gram's context
    assert len(st) == 6 + 11 and all(f.dtype == torch.int32 for f in st[6:])
    assert ops._stack_state(st).shape == (17, 2, 3)
    # a stateful char trigram over 65 classes: its context holds ids past 63
    abc65 = Alphabet(labels="_" + "".join(chr(0x100 + i) for i in range(63)) + " ")
    tri = train_ngram([" ".join(chr(0x100 + (7 * k + i) % 63) for i in range(9))
                       for k in range(20)], order=3)
    kw65 = tbeam.DeviceBeamDecoder(abc65, char_lm=tri, alpha=0.5).kernel_lm_kwargs(65)
    peaked = torch.full((2, 5, 65), -30.0)
    peaked[:, :, 62] = 0.0  # class 62, then 63 and 64 (the space) stand out
    peaked[:, 2:, 63] = 1.0
    peaked[:, 4, 64] = 2.0
    out = ops.beam_scan_reference(torch.log_softmax(peaked, -1), lengths, beam_width=3,
                                  blank_id=0, state=ops.make_beam_state(2, 3, lm_mode="char",
                                                                        ring_len=2),
                                  return_state=True, **kw65)
    assert len(out[3]) == 6 + 2 and int(out[3][-1][0].max()) == 64
    st = ops.make_beam_state(2, 3, lm_mode="word", ring_len=8)  # a 9-gram's ring
    assert len(st) == 6 + 3 + 16 and ops._stack_state(st).shape == (25, 2, 3)
    # the plain version, the CPU's, takes what K3 takes (on a card, beam_scan
    # launches K3 for it)
    wide = ops.beam_scan_reference(lp, lengths, beam_width=300, blank_id=0)
    assert wide[0].shape == (2, 5, 300) and wide[0].dtype == torch.int32
    lm = train_ngram(CHARS, order=12)
    dec = tbeam.DeviceBeamDecoder(ABC, beam_width=300, char_lm=lm, alpha=0.5)
    kw = dec.kernel_lm_kwargs(5)
    assert kw["char_tables"].order == 12 and kw["char_tables"].meta_rows.shape == (12, 3)
    assert kw["char_tables"].meta_rows.dtype == torch.int32
    want = ops.beam_scan_reference(lp, lengths, beam_width=300, blank_id=0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(dec.search(lp, lengths), want))
    assert ops.beam_scan.launches == before
    with pytest.raises(ValueError, match="impl"):
        tbeam.DeviceBeamDecoder(ABC, impl="bogus")
    dec = tbeam.DeviceBeamDecoder(ABC, impl="pallas")  # accepted; K3 runs regardless
    assert dec.decode(lp, lengths) == tbeam.DeviceBeamDecoder(ABC, impl="xla").decode(
        lp, lengths)
