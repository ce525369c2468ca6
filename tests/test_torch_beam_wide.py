"""The port's device beam at configurations its kernel K3 once refused,
against tpuasr's on the CPU.

tpuasr's ``DeviceBeamDecoder(impl="auto")`` decodes any beam width and
any LM order: what its TPU kernel cannot fuse goes to its XLA path
(``make_beam_search``), which on the CPU is where "auto" goes anyway.
The port's decoder runs ``beam_scan_reference`` (K3's plain version) on
the CPU; on a card it runs K3, which takes any width and order. Here
both packages decode the
same seeded logits at W=100 (no LM, a char and a word trigram) and with
a 7-gram char LM (W=10 and W=100): the texts of every live beam are
equal and their scores within 1e-5, the tolerance of
tests/test_torch_beam.py (the exp/log1p of the two frameworks may differ
in the last bit).

A 7-gram char context is the class ids of a beam's last 6 chars: the
stateful plain version carries them as K3 does, one int32 state row
each, and chunked calls equal one call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
import tpuasr.decode.beam as jbeam
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

CASES = {  # name: (beam width, LM kind, LM order)
    "W100": (100, None, 0),
    "W100-char3": (100, "char", 3),
    "W100-word3": (100, "word", 3),
    "char7": (10, "char", 7),
    "W100-char7": (100, "char", 7),
}


def _decoders(name):
    w, kind, order = CASES[name]
    kw = dict(beam_width=w, alpha=0.9, beta=0.4)
    if kind is not None:
        lines = CHARS if kind == "char" else WORDS
        key = f"{kind}_lm"
        kw_p = {key: train_ngram(lines, order=order), **kw}
        kw_j = {key: jax_train_ngram(lines, order=order), **kw}
    else:
        kw_p = kw_j = kw
    return (tbeam.DeviceBeamDecoder(ABC, **kw_p),
            jbeam.DeviceBeamDecoder(JABC, impl="auto", **kw_j))


@pytest.mark.parametrize("name", list(CASES))
def test_wide_and_high_order_beams_match_tpuasr(name):
    port, ref = _decoders(name)
    w, kind, order = CASES[name]
    rng = np.random.RandomState(len(name))
    logits = (rng.randn(3, 14, 5) * 2.5).astype(np.float32)
    lengths = np.array([14, 9, 3], np.int32)
    got = port.decode_nbest(torch.from_numpy(logits), torch.from_numpy(lengths))
    want = ref.decode_nbest(jnp.asarray(logits), jnp.asarray(lengths))
    n_live = 0
    for g, e in zip(got, want):
        live = [r for r in e if r[1] > -1e29]  # beams that hold a prefix
        n_live += len(live)
        assert [r[0] for r in g[:len(live)]] == [r[0] for r in live]
        np.testing.assert_allclose([r[1] for r in g[:len(live)]], [r[1] for r in live],
                                   rtol=1e-5, atol=1e-5)
    assert n_live > 3 * min(w, 20) // 2  # the width is really used
    texts = port.decode(logits, lengths)
    assert texts == ref.decode(jnp.asarray(logits), jnp.asarray(lengths))
    if kind == "char" and order > 6:  # K3 reads every order's table row
        assert port.kernel_lm_kwargs(5)["char_tables"].meta_rows.shape == (order, 3)


def test_seven_gram_context_rides_in_64_bits_across_chunks():
    """The stateful plain version carries a 7-gram char context as K3
    carries it, 6 class ids a beam in 6 int32 rows; 3 chunked calls equal
    one call."""
    lm = train_ngram(CHARS, order=7)
    tables = ops.flat_tables(tbeam.pack_lm_tables(lm, ABC), "cpu")
    b, t, w = 3, 18, 6
    rng = np.random.RandomState(5)
    lp = torch.log_softmax(torch.from_numpy((rng.randn(b, t, 5) * 2.5).astype(np.float32)), -1)
    lengths = torch.tensor([18, 11, 0], dtype=torch.int32)
    kw = dict(beam_width=w, blank_id=0, char_tables=tables, alpha=0.9, beta=0.4, space_id=3)
    p0, c0, s0, st0 = ops.beam_scan_reference(lp, lengths, return_state=True, **kw)
    ctx = torch.stack(st0[6:], -1)  # (B, W, 6) class ids, oldest first
    assert len(st0) == 6 + 6 and ctx.dtype == torch.int32
    assert int(ctx.min()) >= 0 and int(ctx.max()) < 5 and int(ctx.max()) > 0
    state = ops.make_beam_state(b, w, lm_mode="char", ring_len=6)
    ps, cs = [], []
    for t0 in range(0, t, 6):
        n = torch.clamp(lengths - t0, 0, 6).to(torch.int32)
        pi, ci, scores, state = ops.beam_scan_reference(
            lp[:, t0:t0 + 6].contiguous(), n, state=state, return_state=True, **kw)
        ps.append(pi)
        cs.append(ci)
    assert torch.equal(torch.cat(ps, 1), p0) and torch.equal(torch.cat(cs, 1), c0)
    assert torch.equal(scores, s0)
    for a, e in zip(state, st0):
        assert a.dtype == e.dtype and torch.equal(a, e)
    # K3's state rows: one int32 row a context char, and back
    rows = ops._stack_state(st0)
    assert rows.shape == (len(st0), b, w) and torch.equal(rows[6:], ctx.permute(2, 0, 1))
    back = ops._unstack_state(rows, ops._state_dtypes("char", 6))
    assert len(back) == len(st0)
    assert all(a.dtype == e.dtype and torch.equal(a, e) for a, e in zip(back, st0))
    with pytest.raises(ValueError):  # a wrong ring length drops no field silently
        ops._unstack_state(rows, ops._state_dtypes("char", 0))
