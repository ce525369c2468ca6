"""The port's device beam past every limit its kernel K3 once had, against
tpuasr's XLA search on the CPU.

K3 used to refuse beam widths past 254, classes past 126, char LMs over
more than 64 classes or of order > 11 and word LMs of order > 8; tpuasr
decodes all of them through its XLA search (``impl="xla"``). The port's
decoder runs ``beam_scan_reference`` (K3's plain version) on the CPU and
K3 on a card, for any of them. Here both packages decode the same seeded
logits at W=260 (no LM), over 130 classes with a word trigram, with a
char 12-gram over 70 classes and with a word 9-gram: the texts of every
live beam are equal and their scores within 1e-5 (rtol and atol; the
exp/log1p of the two frameworks may differ in the last bit), as in
tests/test_torch_beam_wide.py. A stateful 12-gram decode over 70 classes
in 3 chunks equals one call. Shapes are small (T <= 16, B <= 3) to keep
the file to seconds.
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


def _labels(c_num):
    """Blank, c_num - 2 letters (Latin Extended code points), space."""
    return "_" + "".join(chr(0x100 + i) for i in range(c_num - 2)) + " "


def _lines(c_num, kind, seed):
    """Seeded lines over the alphabet's first 12 letters: words of 1-3
    letters, 5 to a line; char LMs see them letter by letter."""
    rng = np.random.RandomState(seed)
    letters = [chr(0x100 + i) for i in range(min(12, c_num - 2))]
    words = ["".join(rng.choice(letters, size=rng.randint(1, 4))) for _ in range(12)]
    lines = [" ".join(rng.choice(words, size=5)) for _ in range(30)]
    if kind == "char":
        lines = [" ".join("<sp>" if ch == " " else ch for ch in ln) for ln in lines]
    return lines


CASES = {  # name: (beam width, classes, LM kind, LM order)
    "W260": (260, 5, None, 0),
    "C130-word3": (10, 130, "word", 3),
    "C70-char12": (10, 70, "char", 12),
    "word9": (10, 5, "word", 9),
}


def _logits(c_num, seed, b=3, t=14):
    """Seeded logits with the first 12 letters, the space and the blank
    peaked over the rest, so that the LM's words are spelled."""
    rng = np.random.RandomState(seed)
    lg = (rng.randn(b, t, c_num) * 2.5).astype(np.float32)
    lg[:, :, 12:c_num - 1] -= 6.0
    return lg


@pytest.mark.parametrize("name", list(CASES))
def test_beam_past_k3s_old_limits_matches_tpuasr(name):
    w, c_num, kind, order = CASES[name]
    labels = "_AB C" if c_num == 5 else _labels(c_num)
    kw = dict(beam_width=w, alpha=0.9, beta=0.4)
    kw_p, kw_j = dict(kw), dict(kw)
    if kind is not None:
        lines = (["AB C AB", "C AB", "AB AB C", "C C AB", "AB", "CA AB C", "AB C C AB"]
                 if c_num == 5 else _lines(c_num, kind, seed=order))
        kw_p[f"{kind}_lm"] = train_ngram(lines, order=order)
        kw_j[f"{kind}_lm"] = jax_train_ngram(lines, order=order)
    port = tbeam.DeviceBeamDecoder(Alphabet(labels=labels), **kw_p)
    ref = jbeam.DeviceBeamDecoder(JaxAlphabet(labels=labels), impl="xla", **kw_j)
    logits = _logits(c_num, seed=len(name))
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
    assert port.decode(logits, lengths) == ref.decode(jnp.asarray(logits), jnp.asarray(lengths))
    if kind is not None:  # the kernel's arguments: one table row an order
        tabs = port.kernel_lm_kwargs(c_num)[f"{kind}_tables"]
        assert tabs.order == order and tabs.meta_rows.shape == (order, 3)


def test_twelve_gram_context_over_70_classes_across_chunks():
    """A stateful char 12-gram over 70 classes carries each beam's last 11
    class ids, one int32 row each (ids past 63 included); 3 chunked calls
    equal one call, state and all."""
    alphabet = Alphabet(labels=_labels(70))
    lm = train_ngram(_lines(70, "char", seed=3), order=12)
    tables = ops.flat_tables(tbeam.pack_lm_tables(lm, alphabet), "cpu")
    b, t, w = 3, 15, 6
    logits = _logits(70, seed=11, b=b, t=t)
    logits[:, ::4, 68] += 5.0  # class 68, a letter past 63, on every 4th frame
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    lengths = torch.tensor([15, 8, 0], dtype=torch.int32)
    kw = dict(beam_width=w, blank_id=0, char_tables=tables, alpha=0.9, beta=0.4,
              space_id=alphabet.space_id)
    p0, c0, s0, st0 = ops.beam_scan_reference(lp, lengths, return_state=True, **kw)
    ctx = torch.stack(st0[6:], -1)
    assert ctx.shape == (b, w, 11) and ctx.dtype == torch.int32 and int(ctx.max()) > 63
    state = ops.make_beam_state(b, w, lm_mode="char", ring_len=11)
    ps, cs = [], []
    for t0 in range(0, t, 5):
        n = torch.clamp(lengths - t0, 0, 5).to(torch.int32)
        pi, ci, scores, state = ops.beam_scan_reference(
            lp[:, t0:t0 + 5].contiguous(), n, state=state, return_state=True, **kw)
        ps.append(pi)
        cs.append(ci)
    assert torch.equal(torch.cat(ps, 1), p0) and torch.equal(torch.cat(cs, 1), c0)
    assert torch.equal(scores, s0)
    for a, e in zip(state, st0):
        assert a.dtype == e.dtype and torch.equal(a, e)
