"""The vanilla (tanh) RNN on its fused kernels' path (``ops/birnn.py``:
K6f and K6b, and ``BiRNNFunction``), on the CPU, where the wrappers run
their plain versions with the kernels' numerics; and the benchmark's
reference copy for that model (``benchmark/lib/reference_rnn.py``)
against PyTorch's own ``nn.RNN``. No GPU, no JAX: the kernels themselves
are held to these plain versions in ``test_torch_kernels.py`` on a card.

Tolerances, all f32. The op against the reference's recurrence: ys
within 1e-6 (the same f32 operations in the same order; only the
library's matmul blocking may move a last bit), gradients within 1e-5
of their largest entry (autograd sums the steps' dw in another order
than the op's einsum). The reference's layer against ``nn.RNN``: 1e-5
(the same products, cuDNN-free CPU kernels, summed in another order).
The whole model against the reference copy: 1e-4, as
``benchmark/tests/test_bench_reference.py`` holds the GRU and LSTM.
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.lib import bounds, bounds_rnn, reference_rnn
from benchmark.lib.harness import BENCH_DIR, Context, read_json
from benchmark.lib.traffic import make_corpus
from benchmark.lib.weights import make_weights
from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr_torch import profiling
from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
from tpuasr_torch.ops.birnn import (
    BiRNNFunction,
    birnn_backward,
    birnn_backward_reference,
    birnn_forward,
    birnn_reference,
)

CELL = "ds2_birnn1280.train_rnn"


def _inputs(t, b, h, nd, seed, lengths):
    """f32 inputs of the op, every direction with the prefix mask of
    ``lengths``, and the same as the reference's recurrence takes them."""
    rng = np.random.RandomState(seed)
    xg = torch.from_numpy((rng.randn(t, nd, b, h) * 0.5).astype(np.float32))
    w_h = torch.from_numpy((rng.randn(nd, h, h) / np.sqrt(h)).astype(np.float32))
    b_h = torch.from_numpy((rng.randn(nd, h) * 0.1).astype(np.float32))
    valid = torch.arange(t)[:, None] < torch.as_tensor(lengths)[None, :]  # (T, B)
    mask = valid[:, None, :].expand(t, nd, b).float().contiguous()
    return xg, w_h, b_h, mask, valid.t()


@pytest.mark.parametrize("nd", [1, 2], ids=["D1", "D2"])
def test_op_matches_the_reference_recurrence(nd):
    t, b, h = 13, 5, 24
    xg, w_h, b_h, mask, valid = _inputs(t, b, h, nd, seed=nd, lengths=[13, 7, 0, 1, 10])
    dy = torch.from_numpy(np.random.RandomState(9).randn(t, nd, b, h).astype(np.float32))
    grads = []
    for run in ("op", "reference"):
        leaves = [a.clone().requires_grad_() for a in (xg, w_h, b_h)]
        if run == "op":
            ys = BiRNNFunction.apply(*leaves, mask)
        else:  # (D, B, T, H) in and out
            ys = reference_rnn.recurrence("rnn", leaves[0].permute(1, 2, 0, 3), leaves[1],
                                          leaves[2], valid).permute(2, 0, 1, 3)
        (ys * dy).sum().backward()
        grads.append((ys.detach(), [a.grad for a in leaves]))
    (ys_op, g_op), (ys_ref, g_ref) = grads
    assert (ys_op - ys_ref).abs().max().item() <= 1e-6
    for name, a, r in zip(("dxg", "dw_h", "db_h"), g_op, g_ref):
        assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item(), name
    assert not ys_op[:, :, 2].any()  # the 0-length row holds h_0 = 0 throughout


def test_op_backward_wrapper_is_its_plain_version_on_the_cpu():
    xg, w_h, b_h, mask, _ = _inputs(6, 3, 8, 2, seed=4, lengths=[6, 2, 0])
    ys = birnn_forward(xg, w_h, b_h, mask)
    assert torch.equal(ys, birnn_reference(xg, w_h, b_h, mask))
    dy = torch.randn(ys.shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(birnn_backward(w_h, mask, ys, dy),
                       birnn_backward_reference(w_h, mask, ys, dy))


def test_vanilla_layer_calls_count_only_under_a_profile():
    xg, w_h, b_h, mask, _ = _inputs(4, 2, 8, 2, seed=5, lengths=[4, 3])
    profiling.reset()
    birnn_forward(xg, w_h, b_h, mask)
    assert profiling.recorded()["counters"] == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        birnn_forward(xg, w_h, b_h, mask)
        BiRNNFunction.apply(xg, w_h, b_h, mask)
    assert profiling.recorded()["counters"] == {"rnn.tanh_loop_calls": 2}
    profiling.reset()


def test_reference_layer_matches_torch_nn_rnn():
    """The reference copy's bidirectional layer against ``nn.RNN(tanh,
    bidirectional)`` on packed ragged rows: the reference repository's
    ``--rnn-type rnn`` layer, its two directions summed."""
    torch.manual_seed(3)
    b, t, h_in, h = 4, 11, 10, 12
    lengths = torch.tensor([11, 8, 3, 1])
    x = torch.randn(b, t, h_in) * (torch.arange(t)[None, :, None] < lengths[:, None, None])
    rnn = torch.nn.RNN(h_in, h, nonlinearity="tanh", bidirectional=True, batch_first=True)
    w = {}
    for key, sfx in (("input_kernel", "weight_ih_l0"), ("recurrent_kernel", "weight_hh_l0")):
        w["bi." + key] = torch.stack([getattr(rnn, sfx).t(),
                                      getattr(rnn, sfx + "_reverse").t()]).detach()
    for key, sfx in (("input_bias", "bias_ih_l0"), ("recurrent_bias", "bias_hh_l0")):
        w["bi." + key] = torch.stack([getattr(rnn, sfx),
                                      getattr(rnn, sfx + "_reverse")]).detach()
    with torch.no_grad():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths, batch_first=True)
        out, _ = rnn(packed)
        out, _ = torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=t)
        got = reference_rnn.bidirectional_layer("rnn", x, lengths, w, "bi.")
    want = out[..., :h] + out[..., h:]
    assert (got - want).abs().max().item() <= 1e-5


@pytest.fixture(scope="module")
def corpus():
    mix = {"length_median_s": 1.5, "length_sigma": 0.5, "length_min_s": 1.0,
           "length_max_s": 3.0, "chars_per_s": 14.0}
    return make_corpus(4, mix, 2 ** 31 + 9, torch.device("cpu"))


def _tiny_cfg(**model) -> dict:
    cfg = read_json(BENCH_DIR / "configs" / "ds2_birnn1280.json")
    cfg["model"].update({"hidden_size": 32, "hidden_layers": 2}, **model)
    return cfg


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_matches_the_reference_copy(corpus, train):
    """DeepSpeech2 at ``rnn_type="rnn"`` (its layers on BiRNNFunction's
    CPU path) against the reference copy's forward, f32, same weights."""
    cfg = _tiny_cfg(compute_dtype="float32")
    model = DeepSpeech2(ModelConfig(**cfg["model"]))
    w = make_weights({k: tuple(v.shape) for k, v in model.state_dict().items()}, 5, "cpu", 4.0)
    model.load_state_dict(w)
    feats, lengths = reference_rnn.features(corpus.pcm)
    with torch.no_grad():
        got, got_len = model(feats, lengths, train=train)
        want, want_len = reference_rnn.forward(cfg["model"], w, feats, lengths, train=train)
    assert torch.equal(got_len, want_len)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_cell_runs_correct_on_the_cpu_at_a_tiny_size():
    """The cell's entry, configuration, mix and limits at a tiny width
    (24 utterances of 1-3 s, B=4), bf16 compute as the cell runs: the
    check steps against the reference copy pass the cell's limits."""
    from benchmark.run import load_module

    bench = read_json(BENCH_DIR.parent / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    mix = read_json(BENCH_DIR / "mixes" / f"{cell['traffic']}.json")
    mix.update({"utterances": 24, "batch_size": 4, "length_median_s": 1.5, "length_max_s": 3.0})
    ctx = Context(cell=cell, cfg=_tiny_cfg(), mix=mix,
                  limits=read_json(BENCH_DIR / "limits" / f"{CELL}.json"), seed=2 ** 31 + 11,
                  seconds=0.5, trace=False, device=torch.device("cpu"), t0=time.perf_counter())
    res = load_module(BENCH_DIR / "entries" / "train_rnn.py", "test_entry_train_rnn").run(ctx)
    assert res.correct, res.checks
    assert res.attempted > 0 and res.failed == 0
    assert res.e2e["train_audio_s_per_s"] > 0
    json.dumps(res.work["cfg"])  # what the readers read is plain data


def test_bounds_count_one_gate():
    """The cell's FLOPs are the shared count at one gate: the GRU's
    recurrent FLOPs are three times the vanilla RNN's, the rest alike;
    K6's bound counts one H x H product a step and direction."""
    cfg = _tiny_cfg()["model"]
    gru = {**cfg, "rnn_type": "gru"}
    rest = bounds_rnn.forward_flops_per_frame({**cfg, "hidden_layers": 0})
    assert bounds_rnn.forward_flops_per_frame(gru) == bounds.forward_flops_per_frame(gru)
    assert (bounds_rnn.forward_flops_per_frame(gru) - rest
            == pytest.approx(3 * (bounds_rnn.forward_flops_per_frame(cfg) - rest)))
    ms, by = bounds_rnn.tanh_rnn_bound(826, 32, 1280, 2, 2)
    assert by == "operations" and ms == pytest.approx(2 * 2 * 826 * 32 * 1280 ** 2 / 989e9)
    assert bounds_rnn.tanh_rnn_bound(826, 32, 1280, 2, 2, backward=True)[0] == ms
