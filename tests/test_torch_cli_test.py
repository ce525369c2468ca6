"""tpuasr_torch.cli.test against tpuasr.cli.test on the CPU: on the same
checkpoint (2 BiGRU-32 layers, f32, seeded weights that tpuasr wrote)
and manifest (8 synthetic 1 s utterances, two batches of 4) both print
the same ``Test Summary`` line and save the same hypotheses, for the
greedy decoder, the host beam with a word LM and the device beam with a
word LM (the port runs K3's plain version on the CPU, tpuasr its XLA
path). The LM is a word trigram that the port's ``cli.train_lm`` builds
from the manifest's transcripts; both packages read the same ARPA."""

import json

import jax
import jax.numpy as jnp
import pytest

from torch_helpers import one_intra_op_thread, use_private_tpuasr_native  # noqa: F401
from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.cli import test as jax_test_cli
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr.train.checkpoint import CheckpointPackage as JaxPackage
from tpuasr.train.checkpoint import save_checkpoint as jax_save
from tpuasr.train.step import TrainConfig, init_train_state
from tpuasr_torch.cli import synth_corpus, train_lm
from tpuasr_torch.cli import test as test_cli


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_test")
    corpus = synth_corpus.generate(str(root / "corpus"), 8, 1.0, 0.0, seed=3)
    mc = JaxConfig(n_classes=JaxAlphabet().size, hidden_size=32, hidden_layers=2,
                   compute_dtype=jnp.float32)
    state = init_train_state(mc, TrainConfig(), jax.random.PRNGKey(7))
    ckpt = str(root / "m.ckpt")
    jax_save(ckpt, JaxPackage(
        model_config=mc, frontend_config=JaxFrontendConfig(), labels=JaxAlphabet().labels,
        variables={"params": jax.device_get(state.params),
                   "batch_stats": jax.device_get(state.batch_stats)}))
    lm = str(root / "lm.arpa")
    assert train_lm.main(["--manifest", corpus["train"], "--order", "3", "--out", lm]) == 0
    return root, ckpt, corpus["train"], lm


@pytest.mark.parametrize("decoder", [["greedy"], ["beam", "lm"], ["beam-device", "lm"],
                                     ["beam-native", "lm"]],
                         ids=["greedy", "beam-word-lm", "beam-device-word-lm",
                              "beam-native-word-lm"])
def test_summary_equals_tpuasr(setup, decoder, capsys, tmp_path, monkeypatch):
    root, ckpt, manifest, lm = setup
    if decoder[0] == "beam-native":
        use_private_tpuasr_native(tmp_path, monkeypatch)
    lm_args = ["--lm-path", lm, "--alpha", "0.8", "--beta", "1.0"] if "lm" in decoder else []
    summaries, hyps = [], []
    for name, main, extra in (("jax", jax_test_cli.main, []),
                              ("port", test_cli.main, ["--device", "cpu"])):
        out = root / f"{name}-{decoder[0]}.jsonl"
        argv = ["--model-path", ckpt, "--test-manifest", manifest, "--batch-size", "4",
                "--decoder", decoder[0], "--beam-width", "5", *lm_args,
                "--save-output", str(out), "--timing", *extra]
        assert main(argv) == 0
        lines = capsys.readouterr().out.splitlines()
        summaries.append([ln for ln in lines if ln.startswith("Test Summary")])
        assert any(ln.startswith("Timing \t8 utts in ") for ln in lines), lines
        hyps.append([json.loads(ln) for ln in out.read_text().splitlines()])
    assert len(summaries[0]) == 1 and summaries[1] == summaries[0]
    assert len(hyps[0]) == 8 and hyps[1] == hyps[0]


@pytest.mark.parametrize("decoder", ["beam", "beam-device", "beam-native"])
def test_transcribe_n_best_equals_tpuasr(setup, decoder, capsys, tmp_path, monkeypatch):
    """``cli.transcribe --n-best 3 --offsets`` prints tpuasr's rows with
    the word LM: texts and frames exact, the printed scores within 1e-5
    relative (the device beam's f32 scores may differ from the XLA
    path's in the last bits, and so round to another 4th decimal)."""
    from tpuasr.cli import transcribe as jax_transcribe
    from tpuasr_torch.cli import transcribe

    root, ckpt, manifest, lm = setup
    if decoder == "beam-native":
        use_private_tpuasr_native(tmp_path, monkeypatch)
    wav = open(manifest).readline().split(",")[0]
    argv = ["--model-path", ckpt, "--audio-path", wav, "--decoder", decoder,
            "--lm-path", lm, "--alpha", "0.8", "--beta", "1.0", "--beam-width", "5",
            "--n-best", "3", "--offsets"]
    assert jax_transcribe.main(argv) == 0
    want = capsys.readouterr().out
    assert transcribe.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    want, got = want.splitlines(), got.splitlines()
    assert len(want) == 6 and len(got) == 6
    for row_got, row_want in zip(got, want):
        score_got, text_got = row_got.split("\t", 1)
        score_want, text_want = row_want.split("\t", 1)
        assert text_got == text_want
        if score_want:
            assert float(score_got) == pytest.approx(float(score_want), rel=1e-5)
