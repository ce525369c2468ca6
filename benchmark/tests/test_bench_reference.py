"""The plain reference against the port at a tiny size on the CPU: the
same weights and inputs give the same features, logits and training
step when the port computes in float32."""

import numpy as np
import pytest
import torch

from benchmark.lib import reference
from benchmark.lib.traffic import make_corpus
from benchmark.lib.weights import make_weights
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def corpus():
    mix = {"length_median_s": 1.5, "length_sigma": 0.5, "length_min_s": 1.0,
           "length_max_s": 3.0, "chars_per_s": 14.0}
    return make_corpus(6, mix, 2 ** 31 + 7, torch.device("cpu"))


def test_features_match_the_port(corpus):
    from tpuasr_torch.audio.frontend import FrontendConfig, log_spectrogram

    n = int(corpus.samples.max())
    waves = np.zeros((len(corpus.pcm), n), np.float32)
    for j, p in enumerate(corpus.pcm):
        waves[j, :len(p)] = p / 32768.0
    got, got_len = log_spectrogram(torch.from_numpy(waves), torch.from_numpy(corpus.samples),
                                   FrontendConfig())
    want, want_len = reference.features(corpus.pcm)
    assert torch.equal(got_len, want_len)
    assert torch.allclose(got[:, :want.shape[1]], want, atol=2e-4)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_the_port(corpus, rnn_type, train):
    from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig

    cfg = tiny.context("ds2_bigru800.train", rnn_type=rnn_type, compute_dtype="float32").cfg
    model = DeepSpeech2(ModelConfig(**cfg["model"]))
    w = make_weights({k: tuple(v.shape) for k, v in model.state_dict().items()}, 5, "cpu", 4.0)
    model.load_state_dict(w)
    feats, lengths = reference.features(corpus.pcm)
    with torch.no_grad():
        got, got_len = model(feats, lengths, train=train)
        want, want_len = reference.forward(cfg["model"], w, feats, lengths, train=train)
    assert torch.equal(got_len, want_len)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_train_step_matches_the_port_in_float32():
    ctx = tiny.context("ds2_bigru800.train", compute_dtype="float32")
    got = tiny.entry("train").control_readings(ctx, {}, False)["program"]
    # f32 on both sides: a tenth of what bf16 compute reads at this size
    # or less (the worst leaf is a conv BatchNorm's, a sum over every position)
    assert got["loss1_rel_gap"] < 1e-4
    assert got["grad1_median_leaf_gap"] < 1e-4
    assert got["grad1_leaf_gap"] < 1e-3
    assert got["change3_median_leaf_gap"] < 1e-3
