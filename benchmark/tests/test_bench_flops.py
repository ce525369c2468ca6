"""The yardstick's counts against sums worked by hand."""

import pytest

from benchmark.lib import bounds


def hand_forward(g: int, n_classes: int = 42) -> float:
    conv1 = 2 * 41 * 11 * 32 * 81
    conv2 = 2 * 21 * 11 * 32 * 32 * 41
    layers = (2 * 2 * 1312 * g * 800 + 2 * 2 * 800 * g * 800
              + 4 * (2 * 2 * 800 * g * 800 + 2 * 2 * 800 * g * 800))
    return conv1 + conv2 + layers + 2 * 800 * n_classes


@pytest.mark.parametrize("rnn_type,g,approx", [("gru", 3, 103.5e6), ("lstm", 4, 130.8e6)])
def test_forward_flops_per_frame(rnn_type, g, approx):
    cfg = {"n_features": 161, "conv_channels": 32, "hidden_size": 800, "hidden_layers": 5,
           "rnn_type": rnn_type, "n_classes": 42}
    got = bounds.forward_flops_per_frame(cfg)
    assert got == hand_forward(g)
    assert abs(got - approx) < 0.1e6


def test_frames():
    # 5 s: 501 spectrogram frames, 251 after the convs' time stride of 2
    assert bounds.frames_of_samples(80000) == 501
    assert bounds.conv_out_frames(501) == 251
    assert bounds.conv_out_features(161, 32) == 1312


def test_rnn_bound_by_hand():
    # K1f at T'=251, B=32, H=800, D=2, bf16: operations bound the loop
    flops = 2.0 * 2 * 251 * 32 * 800 * 2400
    ms, kind = bounds.rnn_bound(251, 32, 800, 2, 2, 3)
    assert kind == "operations" and ms == pytest.approx(1e3 * flops / 989e12)
    # the backward does twice the operations
    ms_b, _ = bounds.rnn_bound(251, 32, 800, 2, 2, 3, backward=True)
    assert ms_b == pytest.approx(2 * ms)
    # one row, one step of the LSTM forward (ys and cs out): the weights' bytes bound it
    ms_1, kind_1 = bounds.rnn_bound(1, 1, 800, 2, 2, 4)
    nbytes = 2 * (4 * 800 + 2 * 800) * 2 + 2 * 800 * 3200 * 2 + 2 * 3200 * 4 + 2 * 4
    assert kind_1 == "bytes" and ms_1 == pytest.approx(1e3 * nbytes / 3.35e12)
