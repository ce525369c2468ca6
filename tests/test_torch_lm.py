"""The port's n-gram LM modules (tpuasr_torch.decode.lm, .lm_binary and
cli.train_lm) against tpuasr's: the same LM from the same corpus, ARPA
and KenLM-binary files that round-trip and are byte-identical to
tpuasr's, and the same Katz-backoff scores (exactly: both run the same
float64 Python arithmetic)."""

import numpy as np
import pytest

import tpuasr.decode.lm as jlm
import tpuasr.decode.lm_binary as jlm_binary
from tpuasr_torch.decode import lm, lm_binary

CORPUS = ["ALO MUNDO BOM DIA", "BOM DIA TUDO BEM", "TUDO BEM ALO", "CASA SOM BOM",
          "MUNDO CASA", "DIA SOM TUDO BEM BOM DIA"] * 2
QUERIES = [((), "BOM"), (("<s>",), "ALO"), (("ALO",), "MUNDO"), (("BOM", "DIA"), "TUDO"),
           (("XYZ",), "BOM"), (("BOM",), "XYZ"), (("CASA", "SOM"), "BOM"),
           (("<s>", "TUDO"), "</s>"), (("MUNDO",), "<unk>")]


def _ngrams(model):
    return [dict(t) for t in model.ngrams]


@pytest.mark.parametrize("order", [2, 3])
def test_train_ngram_and_scores_equal_tpuasr(order):
    got, want = lm.train_ngram(CORPUS, order=order), jlm.train_ngram(CORPUS, order=order)
    assert got.order == want.order and got.vocab == want.vocab
    assert _ngrams(got) == _ngrams(want)
    for ctx, word in QUERIES:
        assert got.score_word(ctx, word) == want.score_word(ctx, word)
    for line in CORPUS[:4] + ["ALO XYZ DIA"]:
        assert got.score_sequence(line.split()) == want.score_sequence(line.split())


def test_arpa_round_trip_and_cross_package(tmp_path):
    model = lm.train_ngram(CORPUS, order=3)
    ours, theirs = tmp_path / "p.arpa", tmp_path / "j.arpa"
    model.save(str(ours))
    jlm.train_ngram(CORPUS, order=3).save(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    back = lm.load_lm(str(ours))
    assert isinstance(back, lm.ArpaLM) and back.order == 3
    j_back = jlm.ArpaLM.load(str(ours))
    for ctx, word in QUERIES:
        assert back.score_word(ctx, word) == pytest.approx(model.score_word(ctx, word),
                                                           abs=1e-6)
        assert back.score_word(ctx, word) == j_back.score_word(ctx, word)


def test_kenlm_binary_round_trip(tmp_path):
    model = lm.train_ngram(CORPUS, order=3)
    path, jpath = tmp_path / "p.binary", tmp_path / "j.binary"
    lm_binary.write_kenlm_binary(model, str(path))
    jlm_binary.write_kenlm_binary(jlm.train_ngram(CORPUS, order=3), str(jpath))
    assert path.read_bytes() == jpath.read_bytes()
    back = lm.load_lm(str(path))  # dispatched by the mmap magic
    assert isinstance(back, lm_binary.KenlmBinaryLM) and back.ngrams is None
    j_back = jlm.load_lm(str(path))
    for ctx, word in QUERIES:
        assert back.score_word(ctx, word) == j_back.score_word(ctx, word)
        assert back.score_word(ctx, word) == pytest.approx(model.score_word(ctx, word),
                                                           abs=1e-5)
    assert back.score_sequence("BOM DIA ALO".split()) == pytest.approx(
        model.score_sequence("BOM DIA ALO".split()), abs=1e-5)
    assert lm_binary.murmur_hash64a(b"MUNDO") == jlm_binary.murmur_hash64a(b"MUNDO")
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"junk")
    with pytest.raises(ValueError, match="not a KenLM binary"):
        lm_binary.load_kenlm_binary(str(junk))


def test_hashed_ngram_lm_equals_tpuasr():
    model = lm.train_ngram(CORPUS, order=3)
    got = lm.HashedNGramLM.build(model)
    want = jlm.HashedNGramLM.build(jlm.train_ngram(CORPUS, order=3))
    for a, b in zip(got.keys + got.logps + got.backoffs, want.keys + want.logps + want.backoffs):
        np.testing.assert_array_equal(a, b)
    for toks in [("BOM",), ("BOM", "DIA"), ("ALO", "MUNDO", "BOM"), ("XYZ",)]:
        assert got.lookup_np(toks) == want.lookup_np(toks)
    assert lm.context_hash(("A", "B")) == jlm.context_hash(("A", "B"))


@pytest.mark.parametrize("char_level", [False, True], ids=["word", "char"])
def test_train_lm_cli_writes_tpuasr_file(char_level, tmp_path, capsys):
    from tpuasr.cli.train_lm import main as jax_main
    from tpuasr_torch.cli.train_lm import main

    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(s.lower() for s in CORPUS) + "\n", encoding="utf-8")
    flags = ["--char-level"] if char_level else []
    assert main(["--text", str(text), "--out", str(tmp_path / "p.arpa"), *flags]) == 0
    assert jax_main(["--text", str(text), "--out", str(tmp_path / "j.arpa"), *flags]) == 0
    out = capsys.readouterr().out
    assert out.count("order=3") == 2
    assert (tmp_path / "p.arpa").read_bytes() == (tmp_path / "j.arpa").read_bytes()
