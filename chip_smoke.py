#!/usr/bin/env python3
"""GPU smoke run of tpuasr_torch: the training, beam-search evaluation
and batch serving paths on one card, for the BiGRU flagship and for its
BiLSTM and gate-major BiGRU variants, the unidirectional flagship's
training, serving and live streaming, reference ``.pth`` packages and
the C++ host beam, and data- and tensor-parallel training on two ranks.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

(``python3 chip_smoke.py --time-beam WORK LABEL [ROOT]`` only times the
device-beam path from a work directory a full run left: time_beam_path.
``--time-bwd LABEL [ROOT]`` only times the backward kernels and splits
their loop's step (bwd_times), with the tpuasr_torch of ROOT if given;
``--time-rnn LABEL [ROOT]`` times the forward kernels K1f, K4f and K6f
(fwd_times) and then runs bwd_times, and prints the RNN libraries'
registers and spills; ``--time-dw LABEL [ROOT]`` times the backward's
weight gradients at the training cells' shapes (dw_times) and prints the
same.
``python3 chip_smoke.py --stream-only`` runs phase 10 alone, on a corpus
and word LM of its own, and prints no result line; ``--dist-only`` does
the same for phase 13. ``--dist-worker SPEC --rank R --world-size N
--dist-url URL`` is one rank of phase 13, which starts its ranks through
tpuasr_torch.cli.multiproc.)

Phases, one JSON line each; any failure raises and the run exits
non-zero without printing a result:

  1. device  — the card's name, count, and nvidia-smi name and power limit.
  2. build   — nvcc builds every kernel of the paths from the sources in
               tpuasr_torch/ops/csrc (sm_90a), one nvcc per source, and
               the host compiler the C++ beam search
               (tpuasr_torch/decode/csrc/ctc_beam.cpp), all started
               together; build seconds and ptxas' registers, shared
               memory and spills.
  3. kernel  — each kernel's wrapper against its plain PyTorch version
               on the card, at the main paths' shapes and small edge
               shapes, with the tolerances below; then CUDA-event times
               of the kernel, the plain version and one library call
               (cuDNN nn.GRU forward, its backward, F.ctc_loss; timed
               only as yardsticks) beside the bound computed from the
               shapes: K1f (BiGRU forward), K1b (BiGRU backward), K2a
               and K2b (CTC alpha and beta: through the loss at both
               train buckets, their own outputs there and at S=5001, T=1
               and a frame mask that is not a prefix, each twice for bit
               equality; timed with the launches queued behind a
               torch.cuda._sleep, time_queued, at T'=251 and 826), then
               ctc_split: their step split (clock64: inputs, lse3,
               stores, exchange) at both buckets. Then K4f and K4b (BiLSTM
               forward, ys and cs, and backward) and K5f and K5b (the
               gate-major BiGRU) the same way at B=32, H=800, D=2, bf16,
               T'=251 and 826, and at the edges T=1 with B=1, D=1, f32
               and ragged tiles (the flagship cases hold a length-0
               row), each also through its whole autograd function; K5
               must equal K1 bit for bit on the relaid-out inputs; the
               yardsticks are cuDNN nn.LSTM and nn.GRU, each the median
               and range of 5 timings of 10 calls. The forward kernels
               (K1f, K4f, K5f: one persistent cooperative launch a call)
               and the backward kernels (K1b, K4b, K5b: an hg GEMM and one
               persistent cooperative loop, two launches a call) also run
               the edges of their launch plans (H=1760 with w_h partly in
               L2, B=96, B=1, every row of length 0, B=448 for the GRU and
               B=320 for the LSTM, where the backward runs in two row
               groups), in f32 and bf16, must give bit-identical results
               on two calls, and are timed whole and split: the forward's
               step into its barrier wait, h load, product and gate math
               (clock64 spans), the backward into the GEMM and the loop,
               and the loop's step into its hg wait, gate math, barrier
               wait, dhg wait and product (clock64 spans; bwd_split).
               Then K6f and K6b (the vanilla tanh RNN, one gate) at B=32,
               H=1280, D=2, bf16, T'=251 and 826, with D=1, f32 edges and
               the plan's edges above, each also through BiRNNFunction,
               timed and split beside cuDNN's nn.RNN (tanh). Then
               bwd_times: K1b, K4b and K5b per call at B=32, 128 and past
               one plan's rows, K1b at D=1, K6b at H=1280 (D=2 and 1),
               each with its loop's step split. Then dw_times: the
               weight gradients' kernel dw_gemm_bf16 at B=32, D=2, T'=251
               and 826, GRU (G=2,400), LSTM (3,200) and vanilla (H=G=
               1,280) widths, against the f64 sums of the same bf16
               products (relative Frobenius gap <= 1e-4 for dw and db,
               DW_REL_ERR_F64; the f32 einsum's own gap to them and the
               gap between the two reported), timed beside that einsum
               and the bound.
               With the forward plan's row limit set to 7, B=20 runs in 3
               row groups, one launch each, equal bit for bit to one
               launch.
  4. train   — the training main path: a synthetic 5 s corpus (64
               training and 32 validation utterances) and
               tpuasr_torch.cli.train.main on the full-width flagship
               (5 BiGRU-800 layers, 44 classes, bf16, batch 32, 2
               epochs, checkpoints). Every step's loss and grad_norm must
               be finite with 32 usable utterances, the launch counts of
               all five kernels (the RNN's two, CTC's two and the weight
               gradients'; zeroed just before) must have grown, and
               the written checkpoint must transcribe a WAV through the
               serving path. Then one train step through the kernels
               against the plain versions on the same weights and batch,
               and the time split of one train step.
  5. beam    — K3 (prefix beam search) against its plain version on the
               card in four LM modes (none; a char and a word trigram of
               the corpus; a word trigram of a 50k synthetic vocabulary,
               158,337 entries, whose packing is timed) at B=32, W=10,
               C=44, T'=251 and 826, on peaked logits of the corpus
               sentences and on the trained checkpoint's logits, and at
               T'=251 with W=100 (no LM, char, word) and a char 7-gram;
               4 chunked stateful calls against one call; then its times
               and the plain version's beside the bound. Then its frame
               split (beam_split: clock64 spans of each phase and the
               barriers a frame, B=32, T'=251, W=10 and 100, three LM
               modes) and K3 past every limit it once had (beam_limits:
               W=300 over 130 classes, W=254 over 126 with its pool in
               the global workspace, a char 12-gram over 70 classes, also
               in 3 stateful chunks, a word 9-gram; B=8, T'=48) against
               its plain version.
  6. decode  — the evaluation main path: tpuasr_torch.cli.train_lm builds
               a word and a char trigram ARPA from the training
               transcripts; tpuasr_torch.cli.test --decoder beam-device
               (B=32, W=10, --timing-repeats 2) on the trained checkpoint
               over the validation manifest with the word LM, the char LM
               and no LM, K3's launch count (zeroed before each run)
               grown each time, and the word-LM run repeated with K3's
               plain version must print the same summary and hypotheses;
               cli.transcribe --n-best 3 on a 5 s WAV (one K3 launch) and
               a 20 s WAV (long-form, the host beam); TranscriptionService
               with the device beam, whose warm-up of the 5 s and 16.5 s
               buckets launches K3 twice, answering the 5 s WAV; then the
               time split of one 32-row decode batch.
  7. serve   — a full-width flagship checkpoint (5 BiGRU-800 layers,
               44 classes, bf16 compute, seeded random weights) written
               with the port's save_checkpoint and served by
               TranscriptionService + make_http_server on 127.0.0.1:
               after a warm-up of the 5 s and 16.5 s bucket shapes,
               concurrent WAV POSTs of 1-5 s plus one 20 s (long-form)
               request. Every request must answer without error, the
               kernels' launch counts (zeroed just before) must have
               grown, and one batch's logits must match the model run
               with the plain GRU on the card.
               Then one lone request's latency and a time split of one
               service batch (frontend, convs, RNN layers, GRU kernel and
               its step split, head, decode).
  8. lstm, gru2 — the BiLSTM (``--rnn-type lstm``) and the gate-major
               BiGRU (``--rnn-impl pallas2``) at the flagship's width
               (5 layers of 800, bf16, batch 32) through
               tpuasr_torch.cli.train.main on phase 4's corpus: one
               epoch (2 steps and a validation), every step finite, the
               path's kernels and K2a/K2b launched and no other RNN
               kernel (the lstm path launches K4f/K4b and not K1; the
               gru2 path K5f/K5b and not K1f/K1b); one train step,
               kernels vs plain; the train step's time split; then the
               written checkpoint served as in phase 7 (four concurrent
               1-5 s requests and a lone one, the path's forward kernel
               launched, one batch vs the plain loop) with its batch's
               time split.
  9. augment_resident — slice 9's paths at the flagship's width (5
               BiGRU-800 layers, bf16, batch 32): each augmentation apply
               (speed and gain, WSOLA tempo, tempo and gain in both modes,
               noise, SpecAugment) on the card vs the CPU with the same
               parameters drawn from a CUDA generator, on phase 4's first
               32 x 5 s batch (atol 1e-5, lengths equal); one train step
               through make_resident_epoch_runner vs the per-batch step
               (train_parity's tolerances); the augmentation's device ms
               in a step; then tpuasr_torch.cli.train --device-resident-
               audio --augment --noise-dir --spec-augment --profile-dir
               for 2 epochs on 1,024 synthetic utterances of 2-10 s (7
               buckets): every loss finite, K1f, K1b, K2a and K2b
               launched, the trace of steps 10-15 naming the RNN and CTC
               kernels, with the device's idle share over it; a warm
               chunk again under torch.cuda.set_sync_debug_mode("error");
               the same training through AudioBatchLoader (the warm
               epoch's utt/s beside the resident one); cli.test
               --device-resident-audio, greedy and beam-device with a
               word trigram, on 32 utterances of each of two buckets,
               printing what the per-batch run prints (K3 launched); and
               cli.noise_inject writing a WAV.
 10. stream  — slice 10's paths. K1f, K1b, K4f and K4b with one direction
               (D=1, B=32, H=800, bf16, T'=251 and 826) against their plain
               loops with the tolerances below, the autograd functions too
               at T'=251, timed beside cuDNN's unidirectional nn.GRU and
               nn.LSTM and the bounds, with their launch plans. Then the
               unidirectional flagship (5 GRU-800 layers, lookahead 20,
               bf16) through tpuasr_torch.cli.train --no-bidirectional
               --lookahead-context 20 for one epoch on phase 4's corpus
               (every loss finite, K1f, K1b, K2a and K2b launched, no other
               RNN kernel), one train step kernels vs plain, its checkpoint
               served as in phase 7 (K1f launched, a 32 x 5 s batch vs the
               plain loop); one 20 s stream through StreamingTranscriber
               against the offline model on the same wave (normalize off;
               serve_parity's bf16 tolerances); the device beam engine (K3
               stateful, launched) against the host engine with the word
               trigram of phase 6 (same text and offsets; the model's
               head scaled by BEAM_HEAD_GAIN, so that the one-epoch
               model's near-uniform posteriors hold no near-ties that
               f64 and f32 scores break apart); ms per warm
               tick at 8 streams, greedy and device beam, with the share
               of the plain chunk recurrence, and a warm tick under
               sync-debug "error" stopping first at its one read-back
               (then retried in full); then cli.serve --streaming
               --max-streams 8 (greedy, and --decoder beam
               --stream-beam-impl device) started as processes and each
               driven by scripts/stream_load_test.py --streams 8 --seconds
               20 (x_realtime, feed and close latencies), every stream
               finished, both servers stopped.
 11. compat_native — slice 11's paths. The BiGRU and BiLSTM checkpoints
               of phases 4 and 8 exported by ``python -m
               tpuasr_torch.compat.torch_export`` (both processes started
               together), each ``.pth`` read by load_torch_package and
               served by TranscriptionService beside its ``.tpuasr``
               (warm-up, phase 7's 32 x 5 s batch, one request): logits
               bit-equal, the same texts, K1f or K4f launched. Then
               cli.test --decoder beam-native (the C++ host beam, 8
               threads) against --decoder beam (the Python host beam) with
               phase 6's word trigram on 8 validation utterances of the
               flagship with its head sharpened by BEAM_HEAD_GAIN: the
               same summary and hypotheses, utt/s of both beside
               beam-device's, K1f launched; both decoders on the trained
               head's logits of 4 utterances, their characters matched
               printed. Then StreamingTranscriber(beam_impl="native") on
               phase 10's 20 s wave and sharpened head against the host
               engine's text and offsets, and cli.transcribe --streaming
               --decoder beam --beam-impl native on the unidirectional
               checkpoint. The phase prints its wall time.
 13. distributed — slice 12's paths on the full-width flagship (5 x
               BiGRU-800, bf16, f32 parameters) and phase 4's first 32 x
               5 s batch. First K5f and K5b with one direction (B=32,
               T'=251, bf16) against bigru2_reference and its backward
               with the D=2 tolerances, timed. Then one NCCL rank (world
               1, in this process) runs the data-parallel step through
               NCCL's collectives; then two ranks (``--dist-worker``
               processes under cli.multiproc: gloo on one card, NCCL
               across two) run, each rank counting its own launches:
               data parallelism (16 rows a rank), direction TP for the
               GRU (K1 at D=1), the LSTM (K4 at D=1) and the gate-major
               GRU (K5 at D=1), and gate-axis TP (tp 2) of the
               unidirectional flagship. Rank 0 holds each step to the
               single-process step on the same 32 rows
               (train_step_parity's bounds on the loss, grad_norm and
               every parameter's update and running statistic's move),
               the ranks' whole states (sharded leaves gathered) must
               hash alike, and each path must launch its kernels and no
               other RNN kernel. Then tpuasr_torch.cli.multiproc ->
               cli.train --world-size 2 (16 rows a rank) for one epoch
               and cli.test --decoder greedy on rank 0's checkpoint. Step
               times of two ranks on one card are the shared card's, not
               a speed-up.
 14. a {"kernels": [...]} line (all twelve kernels, launches by path and
     by rank on the distributed paths, the RNN kernels' D=1 times beside
     them), then the nvidia-smi line, then the last line {"ok": true,
     "device": {...}}.

Which kernel runs the time loop (tpuasr_torch/model/ds2.py): a GRU
runs K1 under rnn_impl scan and pallas and K5 under pallas2; an LSTM
runs K4 under every impl; a unidirectional GRU or LSTM runs K1 or K4
with one direction; the streaming step's chunk recurrence is a plain
loop (tpuasr_torch/stream.py _rnn_chunk), as tpuasr's is a lax.scan.
Streamed vs offline logits on the card: serve_parity's bf16 bounds
(mean-abs <= 1e-2, max-abs <= 0.25, argmax agreement >= 0.98), since
the chunk loop rounds its products and gates to bf16 where K1f keeps
f32 gate math, and the difference passes through 5 layers.

Tolerances. BiGRU kernel vs plain: f32 max-abs <= 1e-4 (both sum the
same f32 products in different orders); bf16 max-abs <= 3e-2 and
mean-abs <= 1e-3 (the carried h is rounded to bf16 every step, so a
different summation order can move one rounding by an ulp, 2**-8
relative, and the loop carries it on). Full model, kernel vs plain GRU,
bf16: logits mean-abs <= 1e-2, max-abs <= 0.25 and per-frame argmax
agreement >= 0.98 (the ulp differences above pass through 5 layers).

BiGRU backward kernel vs plain, packed gate gradients: f32 max-abs
<= 1e-4 of the largest |packed| (the same f32 products in another
order); bf16 max-abs <= 2e-2 and mean-abs <= 1e-3 of it (packed is
rounded to bf16, 2**-8 relative, and a recomputed gate whose rounding
moves flips one ulp of the output). Through the whole autograd function
(forward and backward kernels vs plain): dxg, dw and db relative norm
error <= 1e-4 in f32, <= 2e-2 in bf16 (the forward's bf16 h differences
enter the recomputed gates).
CTC kernels vs plain: per-utterance loss rel <= 1e-5 and dL/dlogits
max-abs <= 2e-4, alphas rel <= 1e-5 on live cells, dL/demit max-abs <=
2e-4 (tests/test_pallas_ctc.py's tolerances; the kernels run the plain
version's operations in its order on the same card's expf and logf, so
they agree bit for bit). F.ctc_loss, a third opinion on feasible rows:
loss rel <= 1e-4 (its own log-space order).
One full-width bf16 train step, kernels vs plain versions on the same
weights and batch: loss rel <= 1e-2 and each parameter's gradient
relative norm error <= 5e-2, because bf16 activations (h rounded every
step, the kernel and the plain loop summing in different orders) move
by ulps of 2**-8 that five layers, a 251-step recurrence and the
backward carry on.
K4 (BiLSTM) vs plain: K1's tolerances for ys, cs and dhg and for the
whole autograd function, for K1's reasons: h is carried rounded to
bf16 every step (c in f32, emitted rounded) and the kernel sums the
same f32 products in another order, so an ulp that moves is carried on;
the backward rounds only its emitted dhg. K5 (gate-major BiGRU) vs
plain: K1's tolerances; against K1 on the relaid-out inputs: equal bit
for bit (one compiled body with other strides). The lstm and gru2 paths
hold their train step and service batch to the flagship's bounds.
K3 vs plain: parents and chars equal, scores within 1e-5 relative, best
texts equal; both run the same f32 operations in the same order with
the card's expf/log1pf (an absorbed sum has at most one term, since the
beam's prefixes are distinct), so only last bits may differ. K3 finds a
stay's matching extend through its parent's hash where the plain
version compares hashes: the two differ only on a 64-bit collision.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_queued(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls
    queued ahead of the card: the stream first sleeps
    (``torch.cuda._sleep``, counted at 2 GHz, above the card's clock) for
    twice the host's time for ``iters`` calls, so the events time the
    card and not the host's launch overhead. The start event must still
    be pending when the last call is queued, or the sleep is doubled and
    the timing taken again."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        torch.cuda._sleep(int((2 * host_s + 1e-3) * 2e9 * 2 ** attempt))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
    raise RuntimeError("time_queued: the card drained the queue before the host filled it")


# ------------------------------------------------------------------ kernel

def gru_case(t, b, h, nd, dtype, seed, device, n_gates=3, lengths=None):
    """Seeded inputs at model-like scales (``n_gates=4``: the LSTM's);
    ragged lengths with a 0 row unless ``lengths`` is given."""
    import torch

    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = rng.randint(1, t + 1, size=b)
        lengths[0], lengths[min(5, b - 1)] = t, 0
    lengths = np.asarray(lengths)
    g = n_gates
    xg = rng.standard_normal((t, nd, b, g * h)) * 0.5
    w_h = rng.standard_normal((nd, h, g * h)) / np.sqrt(h)
    b_h = rng.standard_normal((nd, g * h)) * 0.1
    m_f = np.arange(t)[:, None] < lengths[None, :]
    m_b = np.arange(t)[:, None] >= (t - lengths)[None, :]
    mask = np.stack([m_f, m_b][:nd], axis=1)

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return (dev(xg, dtype), dev(w_h, dtype), dev(b_h, torch.float32),
            dev(mask, torch.float32))


def rnn_bound(t, b, h, nd, itemsize, n_gates=3, backward=False):
    """The least time of a fused RNN time loop at these shapes: K1f/K5f
    (GRU, n_gates 3) and K4f (LSTM, 4) do h @ w_h every step; K1b/K5b
    and K4b recompute it and then take dhg @ w_h^T (twice the
    operations). Bytes: xg, the per-step state inputs of the backward
    (GRU h_prev, dy; LSTM h_prev, c_prev, cs, dy), the outputs (ys; the
    LSTM's ys and cs; the backward's 4H gate gradients), w_h, b_h, mask."""
    g = n_gates
    flops = (2 if backward else 1) * 2.0 * nd * t * b * h * g * h
    states = (4 if g == 4 else 2) if backward else 0
    outs = 4 * h if backward else (2 * h if g == 4 else h)
    nbytes = (t * nd * b * (g * h + states * h + outs) * itemsize
              + nd * h * g * h * itemsize + nd * g * h * 4 + t * nd * b * 4)
    by_ops, by_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def cudnn_rnn(xg, w_h, b_h, n_gates=3):
    """nn.GRU (n_gates 3), nn.LSTM (4) or nn.RNN with tanh (1),
    bidirectional, with the same recurrent weights (PyTorch's gate
    orders are the port's) and its input of an H-wide ``x``; it also runs
    its own input projection (x @ W_ih). A yardstick only: the port never
    calls it."""
    import torch

    t, nd, b, gh = xg.shape
    h = gh // n_gates
    cls = {1: torch.nn.RNN, 3: torch.nn.GRU, 4: torch.nn.LSTM}[n_gates]
    rnn = cls(h, h, bidirectional=nd == 2).to(device=xg.device, dtype=xg.dtype)
    with torch.no_grad():
        for d in range(nd):
            sfx = "_reverse" if d else ""
            getattr(rnn, "weight_hh_l0" + sfx).copy_(w_h[d].t())
            getattr(rnn, "bias_hh_l0" + sfx).copy_(b_h[d])
            getattr(rnn, "bias_ih_l0" + sfx).zero_()
    rnn.flatten_parameters()  # cuDNN's packed weights, as nn.GRU/nn.LSTM keep them
    return rnn, xg[:, 0, :, :h].contiguous()


def cudnn_rnn_ms(xg, w_h, b_h, iters, n_gates=3):
    """Forward time of ``cudnn_rnn`` at full lengths."""
    import torch

    rnn, x = cudnn_rnn(xg, w_h, b_h, n_gates)

    @torch.inference_mode()
    def run():
        rnn(x)

    return time_ms(run, iters)


def cudnn_rnn_bwd_ms(xg, w_h, b_h, iters, n_gates=3):
    """Backward time of ``cudnn_rnn`` at full lengths: forward+backward
    minus forward, both timed."""
    import torch

    rnn, x = cudnn_rnn(xg, w_h, b_h, n_gates)
    x = x.requires_grad_()
    t, nd, b, _ = xg.shape
    dy = torch.randn(t, b, nd * x.shape[-1], device=xg.device, dtype=xg.dtype)

    def fwd():
        with torch.no_grad():
            rnn(x)

    def fwd_bwd():
        y, _ = rnn(x)
        y.backward(dy)

    return time_ms(fwd_bwd, iters) - time_ms(fwd, iters)


def tanh_bound(t, b, h, nd, backward=False):
    """K6f's or K6b's least time in bf16: the benchmark's count
    (``benchmark/lib/bounds_rnn.py``: one H x H product a step and
    direction, no recompute credited)."""
    from benchmark.lib.bounds_rnn import tanh_rnn_bound

    return tanh_rnn_bound(t, b, h, nd, 2, backward=backward)


def bwd_timing(fn, plain, args, lib_args, t, b, h, nd, n_gates=3) -> dict:
    """A backward kernel's time at (T, B, H, D) bf16: the whole call, its
    two launches apart (CUDA events around the hg GEMM and the
    persistent loop, means of 10 calls), the loop's step split
    (``bwd_split`` over 3 calls, scaled to the untimed loop), the plain
    loop, cuDNN's backward (median and range over 5 separate timings of
    10 calls: it swings between calls) and the bound."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod

    ms = time_ms(lambda: fn(*args), iters=10, warmup=2)
    gru_mod.bwd_events = []
    try:
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        events = gru_mod.bwd_events
    finally:
        gru_mod.bwd_events = None
    split = {k: sum(e[k][0].elapsed_time(e[k][1]) for e in events) / len(events)
             if events else None for k in ("hg", "loop")}  # no events: a CPU rehearsal
    lib = sorted(cudnn_rnn_bwd_ms(*lib_args, iters=10, n_gates=n_gates) for _ in range(5))
    bound_ms, bound_by = (tanh_bound(t, b, h, nd, backward=True) if n_gates == 1 else
                          rnn_bound(t, b, h, nd, 2, n_gates=n_gates, backward=True))
    return {"shape": [t, nd, b, h], "dtype": "bfloat16", "ms": ms,
            "hg_gemm_ms": split["hg"], "loop_ms": split["loop"],
            "loop_split": (split_us(bwd_split(lambda: fn(*args), reps=3), split["loop"])
                           if split["loop"] else None),
            "plain_ms": time_ms(lambda: plain(*args), iters=2),
            "library_ms": lib[len(lib) // 2], "library_ms_range": [lib[0], lib[-1]],
            "bound_ms": bound_ms, "bound_by": bound_by}


def step_split(parts_attr: str, names_attr: str, run, reps: int = 1):
    """A fused RNN loop's step split: ``run()`` (``reps`` times) with its
    per-part step timer on (the list ``tpuasr_torch.ops.gru.<parts_attr>``,
    parts named by ``<names_attr>``), reduced over every block and call:
    each part's share of the loop's clock64 cycles, cycles a step, and the
    steps a run takes. None when nothing launched (a CPU rehearsal) or the
    checkout has no such timer."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod

    if not hasattr(gru_mod, names_attr):
        return None
    setattr(gru_mod, parts_attr, [])
    try:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        parts = getattr(gru_mod, parts_attr)
    finally:
        setattr(gru_mod, parts_attr, None)
    if not parts:
        return None
    names = getattr(gru_mod, names_attr)
    cycles = dict.fromkeys(names, 0.0)
    steps = 0
    for call in parts:
        per_block = call["timer"].double().mean(0).tolist()
        for k, v in zip(names, per_block):
            cycles[k] += v
        steps += call["T"]
    return {"share": {k: cycles[k] / cycles["loop"] for k in names[:-1]},
            "cycles_per_step": {k: v / steps for k, v in cycles.items()},
            "steps_per_run": steps / reps}


def fwd_split(run, reps: int = 1):
    """The forward kernels' step split (``step_split`` of ``fwd_parts``):
    barrier wait, the first window of h landing, the rest of the product
    with its exchange, the gate math. While the timer is on the first
    window of h is waited for before the product starts, so the shares
    describe a step with that wait made visible."""
    return step_split("fwd_parts", "FWD_PARTS", run, reps)


def bwd_split(run, reps: int = 1):
    """The backward loop's step split (``step_split`` of ``bwd_parts``):
    the wait for the step's hg, the gate math, the barrier wait, the wait
    for dhg's words from L2, the rest of the carry product with its
    reduction. While the timer is on
    every warp waits for a k-step's words before its product."""
    return step_split("bwd_parts", "BWD_PARTS", run, reps)


def split_us(split, kernel_ms: float):
    """``step_split``'s shares as microseconds a step of a kernel whose
    (untimed) calls of one run took ``kernel_ms`` in all."""
    if split is None:
        return None
    step_us = kernel_ms * 1e3 / split["steps_per_run"]
    return {**split, "step_us": step_us,
            "us_per_step": {k: v * step_us for k, v in split["share"].items()}}


# (kind, T', B, D) of the bwd_split phase: K1b and K4b at both buckets,
# K1b with one direction, K5b, then each at B=128 and past one plan's
# rows (row groups: B=448 for the GRUs, 320 for the LSTM, at T'=51); then
# K6b (the vanilla RNN, H=1280, where the others run H=800) at both
# buckets and with one direction
BWD_TIME_CASES = (
    ("gru", 251, 32, 2), ("gru", 826, 32, 2), ("lstm", 251, 32, 2), ("lstm", 826, 32, 2),
    ("gru", 251, 32, 1), ("gru", 826, 32, 1), ("gru2", 251, 32, 2),
    ("gru", 251, 128, 2), ("lstm", 251, 128, 2), ("gru2", 251, 128, 2),
    ("gru", 51, 448, 2), ("lstm", 51, 320, 2), ("gru2", 51, 448, 2),
    ("rnn", 251, 32, 2), ("rnn", 826, 32, 2), ("rnn", 251, 32, 1),
)
RNN_WIDTH = {"rnn": 1280}  # hidden size of a kind's timing cases; 800 otherwise
KIND_GATES = {"gru": 3, "gru2": 3, "lstm": 4, "rnn": 1}


def has_kind(kind: str) -> bool:
    """Whether the tpuasr_torch imported has the kernels of ``kind`` (a
    parent checkout may lack the vanilla RNN's)."""
    import importlib.util

    return kind != "rnn" or importlib.util.find_spec("tpuasr_torch.ops.birnn") is not None


def bwd_times(smi: str, label: str = "tree", cases=BWD_TIME_CASES,
              device: str = "cuda") -> list:
    """The ``bwd_split`` phase: for each of ``cases`` the backward call's
    time (CUDA events around 10 calls), its loop's (``bwd_events``) and
    the loop's step split scaled to that time (``bwd_split``, 3 calls).
    One JSON line a case, tagged ``label``, also appended to
    ``build/chip_smoke/bwd_times.jsonl``; the tpuasr_torch imported is the
    first on sys.path (the ``--time-bwd`` mode times another checkout this
    way; cases of a kind it lacks are left out)."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod
    import tpuasr_torch.ops.gru2 as gru2_mod
    import tpuasr_torch.ops.lstm as lstm_mod

    dev = torch.device(device)
    rows = []
    for kind, t, b, nd in cases:
        if not has_kind(kind):
            continue
        h = RNN_WIDTH.get(kind, 800)
        xg, w_h, b_h, mask = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=dev,
                                      n_gates=KIND_GATES[kind])
        gen = torch.Generator(device=dev).manual_seed(1)
        if kind == "rnn":
            import tpuasr_torch.ops.birnn as birnn_mod

            ys = birnn_mod.birnn_forward(xg, w_h, b_h, mask)
            dy = (0.1 * torch.randn(ys.shape, generator=gen, device=dev)).to(torch.bfloat16)
            args = (w_h, mask, ys, dy)
            fn = birnn_mod.birnn_backward
        elif kind == "lstm":
            ys, cs = lstm_mod.bilstm_forward(xg, w_h, b_h, mask)
            dy = (0.1 * torch.randn(ys.shape, generator=gen, device=dev)).to(torch.bfloat16)
            args = (xg, w_h, b_h, mask, gru_mod.shift_time(ys), gru_mod.shift_time(cs), cs, dy)
            fn = lstm_mod.bilstm_backward
        else:
            ys = gru_mod.bigru_forward(xg, w_h, b_h, mask)
            dy = (0.1 * torch.randn(ys.shape, generator=gen, device=dev)).to(torch.bfloat16)
            if kind == "gru2":
                args = (*gate_major(xg, w_h, b_h), mask, gru_mod.shift_time(ys), dy)
                fn = gru2_mod.bigru2_backward
            else:
                args = (xg, w_h, b_h, mask, gru_mod.shift_time(ys), dy)
                fn = gru_mod.bigru_backward
        ms = time_ms(lambda: fn(*args), iters=10, warmup=2)
        gru_mod.bwd_events = []
        try:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
            events = gru_mod.bwd_events
        finally:
            gru_mod.bwd_events = None
        calls = len(events) / 10  # row groups a call
        loop_ms = sum(e["loop"][0].elapsed_time(e["loop"][1]) for e in events) / 10
        hg_ms = sum(e["hg"][0].elapsed_time(e["hg"][1]) for e in events) / 10
        row = {"label": label, "kind": kind, "shape": [t, nd, b, h], "ms": ms,
               "loop_ms": loop_ms, "hg_gemm_ms": hg_ms, "row_groups": calls,
               "split": split_us(bwd_split(lambda: fn(*args), reps=3), loop_ms)}
        rows.append(record("bwd_split", "bwd_times.jsonl", row, smi))
    return rows


def record(phase: str, file_name: str, row: dict, smi: str) -> dict:
    """Emit ``row`` as a ``phase`` line and append it to
    ``build/chip_smoke/<file_name>``, both with the nvidia-smi line."""
    emit(phase, **row, nvidia_smi=smi)
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / file_name, "a") as f:
        f.write(json.dumps({**row, "nvidia_smi": smi}) + "\n")
    return row


# (kind, T', B, D) of the forward times: K1f, K4f and K6f at both buckets
FWD_TIME_CASES = (
    ("gru", 251, 32, 2), ("gru", 826, 32, 2), ("lstm", 251, 32, 2), ("lstm", 826, 32, 2),
    ("rnn", 251, 32, 2), ("rnn", 826, 32, 2),
)


def fwd_times(smi: str, label: str = "tree", cases=FWD_TIME_CASES,
              device: str = "cuda") -> list:
    """The forward kernels' time per call (CUDA events around 10 calls)
    for each of ``cases``, with the step split scaled to it
    (``fwd_split``, 3 calls). One JSON line a case, tagged ``label``, also
    appended to ``build/chip_smoke/fwd_times.jsonl``; the tpuasr_torch
    imported is the first on sys.path, as in ``bwd_times``."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod
    import tpuasr_torch.ops.lstm as lstm_mod

    dev = torch.device(device)
    rows = []
    for kind, t, b, nd in cases:
        if not has_kind(kind):
            continue
        h = RNN_WIDTH.get(kind, 800)
        args = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=dev,
                        n_gates=KIND_GATES[kind])
        if kind == "rnn":
            import tpuasr_torch.ops.birnn as birnn_mod

            fn = birnn_mod.birnn_forward
        else:
            fn = lstm_mod.bilstm_forward if kind == "lstm" else gru_mod.bigru_forward
        ms = time_ms(lambda: fn(*args), iters=10, warmup=2)
        row = {"label": label, "kind": kind, "shape": [t, nd, b, h], "ms": ms,
               "split": split_us(fwd_split(lambda: fn(*args), reps=3), ms)}
        rows.append(record("fwd_time", "fwd_times.jsonl", row, smi))
    return rows


# (kind, T') of the weight gradients' times, at B=32 and D=2: the training
# cells' widths at both buckets
DW_TIME_CASES = (("gru", 251), ("gru", 826), ("lstm", 251), ("lstm", 826),
                 ("rnn", 251), ("rnn", 826))
# dw_gemm_bf16's bound in dw_times: its dw and db against the f64 sums of
# the same bf16 products, relative Frobenius gap. The f32 sums' rounding
# grows with the rows summed: against the f32 einsum the gap reads 6.2e-6
# at T'=251 and 2.1e-5 at 826 (GRU, B=32); a fault moves it by far more (a
# k-step of 32 rows lost or counted twice among 8,032 or more, >= 6e-2; a
# wrong gate or column, ~1)
DW_REL_ERR_F64 = 1e-4
# kind: (gates the backward emits, gates w_h reads, shift)
DW_KINDS = {"gru": (4, (0, 1, 3), 0), "lstm": (4, (0, 1, 2, 3), 0), "rnn": (1, (0,), 1)}


def dw_inline(kind, h, dhg, w_h, b_h):
    """dw and db as the autograd functions formed them inline before
    ``rnn_weight_grads`` (the K6 function's ys shifted for the einsum
    alone; K1's three gates gathered by a ``cat``; f32 copies of both
    operands)."""
    import torch

    from tpuasr_torch.ops.gru import shift_time

    f32, hd = torch.float32, h.shape[-1]
    if kind == "gru":
        g = torch.cat([dhg[..., :2 * hd], dhg[..., 3 * hd:]], dim=-1).to(f32)
    else:
        g = dhg.to(f32)
    hf = (shift_time(h) if kind == "rnn" else h).to(f32)
    dw = torch.einsum("tdbh,tdbg->dhg", hf, g)
    return dw.to(w_h.dtype), g.sum(dim=(0, 2)).to(b_h.dtype)


def dw_times(smi: str, label: str = "tree", cases=DW_TIME_CASES, device: str = "cuda",
             b: int = 32, nd: int = 2) -> list:
    """The weight gradients of one backward call (dw and db) at the
    training cells' shapes, bf16 operands and w_h as the model hands them
    over: ``ms``, what the tpuasr_torch imported (the first on sys.path,
    as in ``bwd_times``) forms them with, ``rnn_weight_grads`` where it
    has it (dw_gemm_bf16), else the functions' own inline expression
    (``dw_inline``); ``plain_ms``, its plain version
    (``rnn_weight_grads_reference``: copies and the f32 einsum; the
    inline expression where that is missing); ``library_ms``, the f32
    einsum alone on f32 copies of the same operands (cuBLAS, TF32 off:
    the yardstick); ``bound_ms``, the products at 989 TFLOP/s. CUDA
    events around 20 calls. Where the helper is there, its f32 dw and db
    are also compared with the plain version's (``rel_err``, relative
    Frobenius gaps, and ``max_abs_err``) and held to the f64 sums of the
    same bf16 products (``rel_err_f64`` <= DW_REL_ERR_F64; the plain
    version's own gap to them, ``einsum_rel_err_f64``, beside it). One
    JSON line a case, tagged ``label``, also appended to
    ``build/chip_smoke/dw_times.jsonl``, before the check."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod

    dev = torch.device(device)
    rows = []
    helper = hasattr(gru_mod, "rnn_weight_grads")
    for kind, t in cases:
        emitted, gates, shift = DW_KINDS[kind]
        h = RNN_WIDTH.get(kind, 800)
        gen = torch.Generator(device=dev).manual_seed(t)
        hs = (0.5 * torch.randn((t, nd, b, h), generator=gen, device=dev)).to(torch.bfloat16)
        dhg = (0.1 * torch.randn((t, nd, b, emitted * h), generator=gen, device=dev)
               ).to(torch.bfloat16)
        w_h = torch.zeros((nd, h, len(gates) * h), dtype=torch.bfloat16, device=dev)
        b_h = torch.zeros((nd, len(gates) * h), device=dev)
        if helper:
            def run():
                gru_mod.rnn_weight_grads(hs, dhg, gates, w_h, b_h, shift=shift)

            def plain():
                gru_mod.rnn_weight_grads_reference(hs, dhg, gates, w_h, b_h, shift=shift)
        else:
            def run():
                dw_inline(kind, hs, dhg, w_h, b_h)
            plain = run
        hf = (gru_mod.shift_time(hs) if shift else hs).float()
        gf = torch.cat([dhg[..., q * h:(q + 1) * h] for q in gates], dim=-1).float()
        flops = 2.0 * t * b * nd * h * len(gates) * h
        ms = time_ms(run, iters=20, warmup=3)
        lib_ms = time_ms(lambda: torch.einsum("tdbh,tdbg->dhg", hf, gf), iters=20, warmup=3)
        row = {"label": label, "kind": kind, "shape": [t, nd, b, h], "G": len(gates) * h,
               "ms": ms, "tflops": flops / ms / 1e9,
               "plain_ms": time_ms(plain, iters=20, warmup=3), "library_ms": lib_ms,
               "bound_ms": 1e3 * flops / H100_BF16_FLOPS, "bound_by": "operations",
               "kernel": helper}
        if helper:  # f32 outputs, so that the gaps are the sums' and not a cast's
            w32 = torch.zeros(w_h.shape, device=dev)
            got = gru_mod.rnn_weight_grads(hs, dhg, gates, w32, b_h, shift=shift)
            want = gru_mod.rnn_weight_grads_reference(hs, dhg, gates, w32, b_h, shift=shift)
            exact = (torch.einsum("tdbh,tdbg->dhg", hf.double(), gf.double()),
                     gf.double().sum(dim=(0, 2)))
            names = ("dw", "db")
            row["rel_err"] = {k: rel_norm_err(g, w) for k, g, w in zip(names, got, want)}
            row["max_abs_err"] = max((g - w).abs().max().item() for g, w in zip(got, want))
            row["rel_err_f64"] = {k: rel_norm_err(g.double(), x)
                                  for k, g, x in zip(names, got, exact)}
            row["einsum_rel_err_f64"] = {k: rel_norm_err(w.double(), x)
                                         for k, w, x in zip(names, want, exact)}
        if hasattr(gru_mod, "rnn_dw_plan"):
            n_sms = (torch.cuda.get_device_properties(dev).multi_processor_count
                     if dev.type == "cuda" else 132)  # a CPU rehearsal plans for an H100
            plan = gru_mod.rnn_dw_plan(t * b, h, len(gates) * h, nd, n_sms)
            row["plan"] = dataclasses.asdict(plan)
        rows.append(record("dw_time", "dw_times.jsonl", row, smi))
        if helper:
            check(max(row["rel_err_f64"].values()) <= DW_REL_ERR_F64,
                  f"dw_gemm_bf16 {kind} T'={t} vs the f64 sums: {row['rel_err_f64']}")
    return rows


def fwd_timing(fn, plain, args, lib_args, t, b, h, nd, n_gates=3) -> dict:
    """A forward kernel's time at (T, B, H, D) bf16: the whole call (one
    persistent launch; mean of 10 calls), its step split into parts
    (``fwd_split`` over 3 calls, scaled to the untimed step), the plain
    loop, cuDNN's forward (median and range over 5 separate timings of 10
    calls: it swings between calls) and the bound."""
    ms = time_ms(lambda: fn(*args), iters=10, warmup=2)
    lib = sorted(cudnn_rnn_ms(*lib_args, iters=10, n_gates=n_gates) for _ in range(5))
    bound_ms, bound_by = (tanh_bound(t, b, h, nd) if n_gates == 1 else
                          rnn_bound(t, b, h, nd, 2, n_gates=n_gates))
    return {"shape": [t, nd, b, h], "dtype": "bfloat16", "ms": ms,
            "split": split_us(fwd_split(lambda: fn(*args), reps=3), ms),
            "plain_ms": time_ms(lambda: plain(*args), iters=2),
            "library_ms": lib[len(lib) // 2], "library_ms_range": [lib[0], lib[-1]],
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_fwd(name, got, want, dtype) -> dict:
    """The BiGRU forward tolerances (module docstring), for K1f, K4f and
    K5f; ``dtype`` by name."""
    diff = (got.float() - want.float()).abs()
    err, mean = diff.max().item(), diff.mean().item()
    if dtype == "float32":
        check(err <= 1e-4, f"{name} f32 max-abs {err}")
    else:
        check(err <= 3e-2 and mean <= 1e-3, f"{name} bf16 {err} {mean}")
    return {"max_abs_err": err, "mean_abs_err": mean}


def check_bwd(name, got, want, dtype) -> dict:
    """The BiGRU backward tolerances (module docstring), for K1b, K4b and
    K5b, relative to the largest |want|."""
    want = want.float()
    scale = want.abs().max().item()
    diff = (got.float() - want).abs()
    err, mean = diff.max().item(), diff.mean().item()
    if dtype == "float32":
        check(err <= 1e-4 * scale, f"{name} f32 {err} of {scale}")
    else:
        check(err <= 2e-2 * scale and mean <= 1e-3 * scale, f"{name} bf16 {err} {mean} of {scale}")
    return {"max_abs_err": err, "mean_abs_err": mean, "abs_max": scale}


def function_vs_plain(fn, xg, w_h, b_h, mask, dy, dtype) -> dict:
    """An autograd function's gradients through the kernels against
    those through the plain versions (relative norm errors)."""
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_() for a in (xg, w_h, b_h)]
        with plain_versions(plain):
            (fn(*leaves, mask).float() * dy.float()).sum().backward()
        grads.append([a.grad for a in leaves])
    errs = {k: rel_norm_err(a, b_) for k, a, b_ in zip(("dxg", "dw", "db"), *grads)}
    check(max(errs.values()) <= (1e-4 if dtype == "float32" else 2e-2),
          f"{fn} {dtype} vs plain: {errs}")
    return errs


def phase_kernel():
    """K1f against its plain loop at the serving shapes and at the edges of
    its launch plan (one launch a call, two calls bit-identical), then its
    times and step split beside cuDNN's nn.GRU and the bound."""
    import torch

    from tpuasr_torch.ops.gru import bigru_forward, bigru_reference

    cuda = torch.device("cuda")
    results = []
    cases = [  # (name, T, B, H, D, dtype, lengths)
        ("serving-5s-bf16", 251, 32, 800, 2, "bfloat16", None),
        ("serving-5s-f32", 251, 32, 800, 2, "float32", None),
        ("T7-D1-bf16", 7, 5, 800, 1, "bfloat16", None),
        ("ragged-tiles-f32", 9, 33, 100, 2, "float32", None),
        *BWD_EDGE_CASES, *FWD_EDGE_CASES,
    ]
    for i, (name, t, b, h, nd, dt, lengths) in enumerate(cases):
        args = gru_case(t, b, h, nd, getattr(torch, dt), seed=i, device=cuda, lengths=lengths)
        before = bigru_forward.launches
        ys = bigru_forward(*args)
        torch.cuda.synchronize()
        check(bigru_forward.launches == before + 1, f"bigru_fwd {name}: one launch a call")
        check(torch.equal(ys, bigru_forward(*args)), f"bigru_fwd {name}: two calls differ")
        results.append({"case": name, "shape": [t, nd, b, h], "dtype": dt, "deterministic": True,
                        **check_fwd(f"bigru {name}", ys, bigru_reference(*args), dt)})
        emit("kernel", kernel="bigru_fwd", **results[-1])

    timings = []
    for t, b, h in TIMING_SHAPES:  # the 5 s and 16.5 s serving buckets
        nd = 2
        args = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=cuda)
        timings.append(fwd_timing(bigru_forward, bigru_reference, args, args[:3], t, b, h, nd))
        emit("kernel_time", kernel="bigru_fwd", **timings[-1])
    return results[0], timings


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Every kernel wrapper that the autograd functions call replaced by
    its plain PyTorch version, the weight gradients' kernel by the f32
    einsum (no-op when ``on`` is False)."""
    import tpuasr_torch.ops.ctc as ctc_mod
    import tpuasr_torch.ops.gru as gru_mod
    import tpuasr_torch.ops.gru2 as gru2_mod
    import tpuasr_torch.ops.lstm as lstm_mod

    import tpuasr_torch.ops.birnn as birnn_mod

    if not on:
        yield
        return
    dw = gru_mod.rnn_weight_grads_reference
    with mock.patch.multiple(birnn_mod, birnn_forward=birnn_mod.birnn_reference,
                             birnn_backward=birnn_mod.birnn_backward_reference,
                             rnn_weight_grads=dw), \
            mock.patch.multiple(gru_mod, bigru_forward=gru_mod.bigru_reference,
                                bigru_backward=gru_mod.bigru_backward_reference,
                                rnn_weight_grads=dw), \
            mock.patch.multiple(gru2_mod, bigru2_forward=gru2_mod.bigru2_reference,
                                bigru2_backward=gru2_mod.bigru2_backward_reference,
                                rnn_weight_grads=dw), \
            mock.patch.multiple(lstm_mod, bilstm_forward=lstm_mod.bilstm_reference,
                                bilstm_backward=lstm_mod.bilstm_backward_reference,
                                rnn_weight_grads=dw), \
            mock.patch.multiple(ctc_mod, ctc_alpha=ctc_mod.ctc_alpha_reference,
                                ctc_beta=ctc_mod.ctc_beta_reference):
        yield


def rel_norm_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_kernel_bwd():
    """K1b against its plain loop, then the whole autograd function
    (K1f + K1b) against plain forward + plain backward."""
    import torch

    from tpuasr_torch.ops.gru import (
        BiGRUFunction,
        bigru_backward,
        bigru_backward_reference,
        bigru_reference,
        shift_time,
    )

    cuda = torch.device("cuda")
    results = []
    cases = [  # (name, T, B, H, D, dtype, lengths)
        ("train-5s-bf16", 251, 32, 800, 2, torch.bfloat16, None),
        ("small-f32", 33, 9, 64, 2, torch.float32, None),
        ("T7-D1-f32", 7, 5, 800, 1, torch.float32, None),
        *[(name, t, b, h, nd, getattr(torch, dt), lengths)
          for name, t, b, h, nd, dt, lengths in BWD_EDGE_CASES],
    ]
    for i, (name, t, b, h, nd, dtype, lengths) in enumerate(cases):
        xg, w_h, b_h, mask = gru_case(t, b, h, nd, dtype, seed=20 + i, device=cuda,
                                      lengths=lengths)
        h_prev = shift_time(bigru_reference(xg, w_h, b_h, mask))
        gen = torch.Generator(device=cuda).manual_seed(i)
        dy = torch.randn(h_prev.shape, generator=gen, device=cuda).to(dtype)
        packed = bigru_backward(xg, w_h, b_h, mask, h_prev, dy)
        torch.cuda.synchronize()
        check(torch.equal(packed, bigru_backward(xg, w_h, b_h, mask, h_prev, dy)),
              f"bigru_bwd {name}: two calls differ")
        dt = str(dtype).split(".")[1]
        row = {"case": name, "shape": [t, nd, b, h], "dtype": dt, "deterministic": True,
               **check_bwd(f"bigru_bwd {name}", packed,
                           bigru_backward_reference(xg, w_h, b_h, mask, h_prev, dy), dt),
               # the whole function: kernels vs plain versions
               "function_rel_norm_err": function_vs_plain(BiGRUFunction.apply, xg, w_h, b_h,
                                                          mask, dy, dt)}
        emit("kernel", kernel="bigru_bwd", **row)
        results.append(row)

    timings = []
    for t in (251, 826):
        b, h, nd = 32, 800, 2
        xg, w_h, b_h, mask = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=cuda)
        h_prev = shift_time(bigru_reference(xg, w_h, b_h, mask))
        dy = (0.1 * torch.randn(h_prev.shape, device=cuda)).to(torch.bfloat16)
        args = (xg, w_h, b_h, mask, h_prev, dy)
        timings.append(bwd_timing(bigru_backward, bigru_backward_reference, args,
                                  (xg, w_h, b_h), t, b, h, nd))
        emit("kernel_time", kernel="bigru_bwd", **timings[-1])
    return results[0], timings


# (name, T, B, H, D, dtype, lengths): the flagship at the 5 s and 16.5 s
# buckets, and the edges (T=1 and B=1, D=1, f32, ragged tiles; the
# flagship cases hold a length-0 row)
NEW_RNN_CASES = [
    ("flagship-5s-bf16", 251, 32, 800, 2, "bfloat16", None),
    ("flagship-16.5s-bf16", 826, 32, 800, 2, "bfloat16", None),
    ("T1-B1-f32", 1, 1, 800, 2, "float32", [1]),
    ("T7-D1-f32", 7, 5, 800, 1, "float32", None),
    ("ragged-tiles-f32", 33, 9, 100, 2, "float32", None),
]
# the launch plans at their edges (tpuasr_torch/ops/rnn_plan.py): w_h
# rows partly read from L2 (H=1760), three row tiles (B=96), one row,
# every frame masked; the forward and backward kernels run them all
BWD_EDGE_CASES = [
    ("H1760-T3-bf16", 3, 32, 1760, 2, "bfloat16", None),
    ("B96-f32", 5, 96, 100, 2, "float32", None),
    ("B96-bf16", 5, 96, 100, 2, "bfloat16", None),
    ("B1-bf16", 6, 1, 100, 2, "bfloat16", [6]),
    ("len0-bf16", 6, 9, 100, 2, "bfloat16", [0] * 9),
]
# and the forward's other edges: 14 row tiles a step (B=448; the LSTM
# phase runs B=320 there, past what one backward plan holds, so its
# backward runs in row groups, as the GRU's does at 448), the f32 cases
# of the edges above, and D=1 in bf16
FWD_EDGE_CASES = [
    ("B448-bf16", 3, 448, 800, 2, "bfloat16", None),
    ("B448-f32", 3, 448, 800, 2, "float32", None),
    ("H1760-T3-f32", 3, 32, 1760, 2, "float32", None),
    ("B1-f32", 6, 1, 100, 2, "float32", [6]),
    ("len0-f32", 6, 9, 100, 2, "float32", [0] * 9),
    ("D1-bf16", 7, 5, 800, 1, "bfloat16", None),
]


def phase_fwd_row_groups(device="cuda", t=6, b=20, h=100):
    """K1f, K5f and K4f past the rows one forward plan holds: with the
    limit set to 7 rows, B=20 runs in 3 row groups, one launch each, and
    must equal the single launch bit for bit and the plain loops within
    ``check_fwd``'s tolerances. (At H=800 on an H100 the limit is 2,864
    rows for the GRU and 1,304 for the LSTM: too large for this phase.)"""
    import torch

    import tpuasr_torch.ops.gru as gru_mod
    from tpuasr_torch.ops.gru2 import bigru2_forward, bigru2_reference
    from tpuasr_torch.ops.lstm import bilstm_forward, bilstm_reference

    cuda = torch.device(device)
    real = gru_mod.max_fwd_rows
    for i, dt in enumerate(("float32", "bfloat16")):
        dtype = getattr(torch, dt)
        k1 = gru_case(t, b, h, 2, dtype, seed=90 + i, device=cuda)
        k5 = (k1[0].reshape(t, 2, b, 3, h).permute(0, 1, 3, 2, 4).contiguous(),
              k1[1].reshape(2, h, 3, h).permute(0, 2, 1, 3).contiguous(),
              k1[2].reshape(2, 3, h).contiguous(), k1[3])
        k4 = gru_case(t, b, h, 2, dtype, seed=95 + i, device=cuda, n_gates=4)
        runs = (("bigru_fwd", gru_mod.bigru_forward, gru_mod.bigru_reference, k1),
                ("bigru2_fwd", bigru2_forward, bigru2_reference, k5),
                ("bilstm_fwd", bilstm_forward, bilstm_reference, k4))
        def outs(x):
            return x if isinstance(x, tuple) else (x,)

        whole = [outs(fn(*args)) for _, fn, _, args in runs]
        gru_mod.max_fwd_rows = lambda *a: 7
        try:
            before = [fn.launches for _, fn, _, _ in runs]
            grouped = [outs(fn(*args)) for _, fn, _, args in runs]
            torch.cuda.synchronize()
            added = [fn.launches - n for (_, fn, _, _), n in zip(runs, before)]
        finally:
            gru_mod.max_fwd_rows = real
        for (name, _, plain, args), one, got, n in zip(runs, whole, grouped, added):
            check(n == 3, f"{name} row groups: {n} launches for 3 groups")
            check(all(torch.equal(a, g) for a, g in zip(one, got)),
                  f"{name} row groups != one launch")
            for part, g, w in zip(("ys", "cs"), got, outs(plain(*args))):
                err = check_fwd(f"{name} row groups {part}", g, w, dt)
                emit("kernel", kernel=name, case=f"row-groups-B{b}-{dt}", part=part,
                     groups=3, **err)


def lstm_cases(cases):
    """The LSTM's edge cases: B=320 where the GRU's run B=448."""
    return [(name.replace("B448", "B320"), t, 320 if b == 448 else b, h, nd, dt, lengths)
            for name, t, b, h, nd, dt, lengths in cases]


# (T, B, H) of the kernels' times, D=2, bf16: the 5 s and 16.5 s buckets
TIMING_SHAPES = ((251, 32, 800), (826, 32, 800))


def phase_kernel_lstm(device="cuda", cases=lstm_cases(NEW_RNN_CASES + BWD_EDGE_CASES
                                                      + FWD_EDGE_CASES),
                      timing_shapes=TIMING_SHAPES):
    """K4f (ys and cs) and K4b (dhg) against their plain loops, the whole
    BiLSTMFunction against plain forward + backward, then times beside
    cuDNN's nn.LSTM and the bounds. ``device``, ``cases`` and
    ``timing_shapes`` other than the defaults only rehearse the phase on
    the CPU."""
    import torch

    from tpuasr_torch.ops.gru import shift_time
    from tpuasr_torch.ops.lstm import (
        BiLSTMFunction,
        bilstm_backward,
        bilstm_backward_reference,
        bilstm_forward,
        bilstm_reference,
    )

    cuda = torch.device(device)
    rows = []
    for i, (name, t, b, h, nd, dt, lengths) in enumerate(cases):
        dtype = getattr(torch, dt)
        args = gru_case(t, b, h, nd, dtype, seed=40 + i, device=cuda, n_gates=4,
                        lengths=lengths)
        ys, cs = bilstm_forward(*args)
        torch.cuda.synchronize()
        again = bilstm_forward(*args)
        check(torch.equal(ys, again[0]) and torch.equal(cs, again[1]),
              f"bilstm_fwd {name}: two calls differ")
        ys_p, cs_p = bilstm_reference(*args)
        fwd = check_fwd(f"bilstm_fwd {name} ys", ys, ys_p, dt)
        fwd_c = check_fwd(f"bilstm_fwd {name} cs", cs, cs_p, dt)
        gen = torch.Generator(device=cuda).manual_seed(i)
        dy = torch.randn(ys.shape, generator=gen, device=cuda).to(dtype)
        bwd_args = (*args, shift_time(ys_p), shift_time(cs_p), cs_p, dy)
        dhg = bilstm_backward(*bwd_args)
        torch.cuda.synchronize()
        bwd = check_bwd(f"bilstm_bwd {name}", dhg, bilstm_backward_reference(*bwd_args), dt)
        check(torch.equal(dhg, bilstm_backward(*bwd_args)), f"bilstm_bwd {name}: two calls differ")
        fn_err = function_vs_plain(BiLSTMFunction.apply, *args, dy, dt)
        rows.append({"case": name, "shape": [t, nd, b, h], "dtype": dt, "ys": fwd, "cs": fwd_c,
                     "dhg": bwd, "function_rel_norm_err": fn_err})
        emit("kernel", kernel="bilstm", **rows[-1])

    timings = {"bilstm_fwd": [], "bilstm_bwd": []}
    for t, b, h in timing_shapes:
        nd = 2
        args = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=cuda, n_gates=4)
        ys, cs = bilstm_reference(*args)
        dy = (0.1 * torch.randn(ys.shape, device=cuda)).to(torch.bfloat16)
        bwd_args = (*args, shift_time(ys), shift_time(cs), cs, dy)
        timings["bilstm_fwd"].append(fwd_timing(bilstm_forward, bilstm_reference, args,
                                                args[:3], t, b, h, nd, n_gates=4))
        emit("kernel_time", kernel="bilstm_fwd", **timings["bilstm_fwd"][-1])
        timings["bilstm_bwd"].append(bwd_timing(bilstm_backward, bilstm_backward_reference,
                                                bwd_args, args[:3], t, b, h, nd, n_gates=4))
        emit("kernel_time", kernel="bilstm_bwd", **timings["bilstm_bwd"][-1])
    first = rows[0]
    return ({"bilstm_fwd": max(first["ys"]["max_abs_err"], first["cs"]["max_abs_err"]),
             "bilstm_bwd": first["dhg"]["max_abs_err"]}, timings)


def gate_major(xg, w_h, b_h):
    """K1's (T, D, B, 3H) / (D, H, 3H) / (D, 3H) inputs relaid out as
    K5's gate-major (T, D, 3, B, H) / (D, 3, H, H) / (D, 3, H)."""
    t, nd, b, g3 = xg.shape
    h = g3 // 3
    return (xg.reshape(t, nd, b, 3, h).permute(0, 1, 3, 2, 4).contiguous(),
            w_h.reshape(nd, h, 3, h).permute(0, 2, 1, 3).contiguous(),
            b_h.reshape(nd, 3, h).contiguous())


def phase_kernel_gru2(device="cuda", cases=NEW_RNN_CASES + BWD_EDGE_CASES + FWD_EDGE_CASES,
                      timing_shapes=TIMING_SHAPES):
    """K5f and K5b against their plain loops, against K1f and K1b on the
    same relaid-out inputs (bit for bit: one compiled body), the whole
    BiGRU2Function against plain forward + backward, then times beside
    cuDNN's nn.GRU and the bounds. Arguments as for phase_kernel_lstm."""
    import torch

    from tpuasr_torch.ops.gru import bigru_backward, bigru_forward, shift_time
    from tpuasr_torch.ops.gru2 import (
        BiGRU2Function,
        bigru2_backward,
        bigru2_backward_reference,
        bigru2_forward,
        bigru2_reference,
    )

    cuda = torch.device(device)
    rows = []
    for i, (name, t, b, h, nd, dt, lengths) in enumerate(cases):
        dtype = getattr(torch, dt)
        k1 = gru_case(t, b, h, nd, dtype, seed=60 + i, device=cuda, lengths=lengths)
        k5 = (*gate_major(*k1[:3]), k1[3])
        ys = bigru2_forward(*k5)
        torch.cuda.synchronize()
        check(torch.equal(ys, bigru2_forward(*k5)), f"bigru2_fwd {name}: two calls differ")
        fwd = check_fwd(f"bigru2_fwd {name}", ys, bigru2_reference(*k5), dt)
        ys_k1 = bigru_forward(*k1)
        gen = torch.Generator(device=cuda).manual_seed(i)
        dy = torch.randn(ys.shape, generator=gen, device=cuda).to(dtype)
        dg = bigru2_backward(*k5, shift_time(ys), dy)
        torch.cuda.synchronize()
        bwd = check_bwd(f"bigru2_bwd {name}", dg,
                        bigru2_backward_reference(*k5, shift_time(ys), dy), dt)
        packed = bigru_backward(*k1, shift_time(ys), dy)
        check(torch.equal(dg, bigru2_backward(*k5, shift_time(ys), dy)),
              f"bigru2_bwd {name}: two calls differ")
        same_as_k1 = {
            "fwd": bool(torch.equal(ys, ys_k1)),
            "bwd": bool(torch.equal(dg, packed.reshape(t, nd, b, 4, h).permute(0, 1, 3, 2, 4)))}
        check(all(same_as_k1.values()), f"K5 vs K1 on relaid-out inputs {name}: {same_as_k1}")
        fn_err = function_vs_plain(BiGRU2Function.apply, *k5, dy, dt)
        rows.append({"case": name, "shape": [t, nd, b, h], "dtype": dt, "ys": fwd, "dg": bwd,
                     "bit_equal_to_k1": same_as_k1, "function_rel_norm_err": fn_err})
        emit("kernel", kernel="bigru2", **rows[-1])

    timings = {"bigru2_fwd": [], "bigru2_bwd": []}
    for t, b, h in timing_shapes:
        nd = 2
        k1 = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=cuda)
        args = (*gate_major(*k1[:3]), k1[3])
        ys = bigru2_reference(*args)
        dy = (0.1 * torch.randn(ys.shape, device=cuda)).to(torch.bfloat16)
        bwd_args = (*args, shift_time(ys), dy)
        timings["bigru2_fwd"].append(fwd_timing(bigru2_forward, bigru2_reference, args,
                                                k1[:3], t, b, h, nd))
        emit("kernel_time", kernel="bigru2_fwd", **timings["bigru2_fwd"][-1])
        timings["bigru2_bwd"].append(bwd_timing(bigru2_backward, bigru2_backward_reference,
                                                bwd_args, k1[:3], t, b, h, nd))
        emit("kernel_time", kernel="bigru2_bwd", **timings["bigru2_bwd"][-1])
    first = rows[0]
    return ({"bigru2_fwd": first["ys"]["max_abs_err"],
             "bigru2_bwd": first["dg"]["max_abs_err"]}, timings)


# K6's cases: the cell's width (B=32, H=1280, D=2, bf16) at both buckets,
# D=1 and an f32 edge at that width, then the plan's edges (the flagship
# cases hold a length-0 row)
RNN_CASES = [
    ("cell-5s-bf16", 251, 32, 1280, 2, "bfloat16", None),
    ("cell-16.5s-bf16", 826, 32, 1280, 2, "bfloat16", None),
    ("D1-bf16", 251, 32, 1280, 1, "bfloat16", None),
    ("T7-f32", 7, 32, 1280, 2, "float32", None),
    ("T1-B1-f32", 1, 1, 1280, 2, "float32", [1]),
    *BWD_EDGE_CASES, *FWD_EDGE_CASES,
]
# (T, B, H, D) of K6's times, bf16: the 5 s and 16.5 s buckets, and D=1
RNN_TIMING_SHAPES = ((251, 32, 1280, 2), (826, 32, 1280, 2), (251, 32, 1280, 1),
                     (826, 32, 1280, 1))


def phase_kernel_rnn(device="cuda", cases=RNN_CASES, timing_shapes=RNN_TIMING_SHAPES):
    """K6f and K6b (the vanilla tanh RNN) against their plain loops, each
    bit-identical over two calls and with one launch a call, the whole
    BiRNNFunction against plain forward + backward, then times and step
    splits beside cuDNN's nn.RNN (tanh) and the bounds. ``device``,
    ``cases`` and ``timing_shapes`` other than the defaults only rehearse
    the phase on the CPU."""
    import torch

    from tpuasr_torch.ops.birnn import (
        BiRNNFunction,
        birnn_backward,
        birnn_backward_reference,
        birnn_forward,
        birnn_reference,
    )

    cuda = torch.device(device)
    rows = []
    for i, (name, t, b, h, nd, dt, lengths) in enumerate(cases):
        dtype = getattr(torch, dt)
        args = gru_case(t, b, h, nd, dtype, seed=60 + i, device=cuda, n_gates=1,
                        lengths=lengths)
        before = (birnn_forward.launches, birnn_backward.launches)
        ys = birnn_forward(*args)
        torch.cuda.synchronize()
        check(torch.equal(ys, birnn_forward(*args)), f"birnn_fwd {name}: two calls differ")
        ys_p = birnn_reference(*args)
        fwd = check_fwd(f"birnn_fwd {name}", ys, ys_p, dt)
        gen = torch.Generator(device=cuda).manual_seed(i)
        dy = torch.randn(ys.shape, generator=gen, device=cuda).to(dtype)
        bwd_args = (args[1], args[3], ys_p, dy)
        dpre = birnn_backward(*bwd_args)
        torch.cuda.synchronize()
        bwd = check_bwd(f"birnn_bwd {name}", dpre, birnn_backward_reference(*bwd_args), dt)
        check(torch.equal(dpre, birnn_backward(*bwd_args)), f"birnn_bwd {name}: two calls differ")
        if cuda.type == "cuda":
            check((birnn_forward.launches - before[0], birnn_backward.launches - before[1])
                  == (2, 2), f"birnn {name}: one launch a call")
        fn_err = function_vs_plain(BiRNNFunction.apply, *args, dy, dt)
        rows.append({"case": name, "shape": [t, nd, b, h], "dtype": dt, "ys": fwd,
                     "dpre": bwd, "function_rel_norm_err": fn_err})
        emit("kernel", kernel="birnn", **rows[-1])

    timings = {"birnn_fwd": [], "birnn_bwd": []}
    for t, b, h, nd in timing_shapes:
        args = gru_case(t, b, h, nd, torch.bfloat16, seed=0, device=cuda, n_gates=1)
        ys = birnn_reference(*args)
        dy = (0.1 * torch.randn(ys.shape, device=cuda)).to(torch.bfloat16)
        bwd_args = (args[1], args[3], ys, dy)
        timings["birnn_fwd"].append(fwd_timing(birnn_forward, birnn_reference, args, args[:3],
                                               t, b, h, nd, n_gates=1))
        emit("kernel_time", kernel="birnn_fwd", **timings["birnn_fwd"][-1])
        timings["birnn_bwd"].append(bwd_timing(birnn_backward, birnn_backward_reference,
                                               bwd_args, args[:3], t, b, h, nd, n_gates=1))
        emit("kernel_time", kernel="birnn_bwd", **timings["birnn_bwd"][-1])
    first = rows[0]
    return ({"birnn_fwd": first["ys"]["max_abs_err"], "birnn_bwd": first["dpre"]["max_abs_err"]},
            timings)


CTC_SHAPES = ((251, 130), (826, 418))  # (T', label cap): the 5 s and 16.5 s buckets, S 261, 837


def ctc_case(device, b=32, t=251, c=44, l_cap=130, seed=3):
    """Logits (B, T, C) f32 and padded labels at a train bucket's shape
    (the 5 s bucket: S = 2 * 130 + 1 = 261): ragged frames and labels (up
    to 47% of the cap, 60 at the 5 s bucket), row 1 an empty label, row 2
    infeasible (50 labels in 20 frames), row 3 a padding row of 0
    frames."""
    import torch

    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((b, t, c)).astype(np.float32) * 2.0
    frames = rng.randint(t // 2, t + 1, size=b)
    top = int(round(0.47 * l_cap))
    n_lab = rng.randint(5, top + 1, size=b)
    frames[0], n_lab[0] = t, top
    n_lab[1] = 0
    frames[2], n_lab[2] = 20, 50
    frames[3] = 0
    labels = np.zeros((b, l_cap), np.int64)
    for j in range(b):
        labels[j, :n_lab[j]] = rng.randint(1, c, size=n_lab[j])
    return [torch.from_numpy(a).to(device) for a in (logits, frames, labels, n_lab)]


def ctc_inputs(logits, frames, labels, n_lab) -> dict:
    """The CTC kernels' inputs for a ``ctc_case``, built as ``ctc_loss``
    builds them (f32, contiguous): emit (T, B, S), allow_skip, valid_s,
    init_mask, end_mask (B, S), frame_valid (T, B)."""
    import torch

    from tpuasr_torch.ctc.loss import _emissions, _extended
    from tpuasr_torch.ops.ctc import LOG_EPS

    dev = logits.device
    t = logits.shape[1]
    z, s_idx, valid_s, allow_skip = _extended(labels, n_lab, 0)
    init = torch.full(z.shape, LOG_EPS, device=dev)
    init[:, 0] = 0.0
    init[:, 1] = torch.where(n_lab > 0, 0.0, LOG_EPS)
    end = 2 * n_lab
    end_mask = (s_idx == end[:, None]) | ((s_idx == (end - 1).clamp(min=0)[:, None])
                                         & (n_lab > 0)[:, None])
    fv = torch.arange(t, device=dev)[:, None] < frames[None, :]
    return {"emit": _emissions(logits, z).contiguous(),
            "allow_skip": allow_skip.float().contiguous(),
            "valid_s": valid_s.float().contiguous(), "init_mask": init,
            "end_mask": end_mask.float().contiguous(), "frame_valid": fv.float().contiguous()}


def ctc_kernel_args(ctc_mod, x: dict, alphas=None, dloss=None):
    """``ctc_alpha``'s and ``ctc_beta``'s arguments for inputs ``x``
    (``ctc_inputs``), for the wrappers of ``ctc_mod``: this tree's K2b
    takes the unshifted emissions, masks and the cotangent; a checkout
    before it took them shifted by a frame, with no cotangent (its caller
    scaled). logp comes from ``alphas`` (the plain recursion's when None)."""
    import inspect

    import torch

    LOG_EPS = ctc_mod.LOG_EPS
    emit_, fv = x["emit"], x["frame_valid"]
    alpha0 = torch.clamp(x["init_mask"] + emit_[0], min=LOG_EPS)
    a_args = (emit_, x["allow_skip"], x["valid_s"], fv, alpha0)
    if alphas is None:
        alphas = ctc_mod.ctc_alpha_reference(*a_args)
    final = torch.where(x["end_mask"] > 0.5, alphas[-1], LOG_EPS)
    logp = torch.clamp(torch.logsumexp(final, dim=1), min=LOG_EPS).contiguous()
    if "emit_next" in inspect.signature(ctc_mod.ctc_beta).parameters:
        skip = x["allow_skip"]
        b_args = (torch.cat([emit_[1:], torch.full_like(emit_[:1], LOG_EPS)]).contiguous(),
                  torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], dim=1).contiguous(),
                  torch.cat([fv[1:], torch.zeros_like(fv[:1])]).contiguous(),
                  torch.where(x["end_mask"] > 0.5, 0.0, LOG_EPS).contiguous(), alphas, logp)
    else:
        if dloss is None:
            dloss = torch.linspace(0.5, 2.0, fv.shape[1], device=fv.device)
        b_args = (emit_, x["allow_skip"], fv, x["end_mask"], alphas, logp, dloss)
    return a_args, b_args


def ctc_bounds(t, b, s):
    """K2a's and K2b's bounds: each input read once, each output written
    once, against ~16 f32 operations a cell (3 exp, 1 log, ~12 adds,
    maxima and compares). The chain of T steps is their real floor
    (PERF.md); it is no bound of the card's."""
    cells = t * b * s
    alpha_bytes = 4.0 * (2 * cells + 3 * b * s + t * b)  # emit, alphas; masks, alpha0; fv
    beta_bytes = 4.0 * (3 * cells + 2 * b * s + t * b + 2 * b)  # emit, alphas, out; ...
    ops = 16.0 * cells
    out = []
    for nbytes in (alpha_bytes, beta_bytes):
        by_ops, by_bytes = ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
        out.append((1e3 * max(by_ops, by_bytes), "operations" if by_ops > by_bytes else "bytes"))
    return out


def ctc_case_small(device, t, b, s, seed=7, holes=False):
    """``ctc_inputs``-shaped inputs at any (T, B, S): log-emissions of
    random distributions, ragged frames (row 0 full, row 1 of 0 frames),
    ragged labels (row 0 full width, row 2 empty), random skips; with
    ``holes`` the frame mask of rows 0 and 2 is not a prefix (every third
    frame off)."""
    import torch

    from tpuasr_torch.ops.ctc import LOG_EPS

    rng = np.random.RandomState(seed)
    emit_ = np.log(rng.dirichlet(np.ones(8), size=(t, b, s)).max(-1)).astype(np.float32)
    frames = rng.randint(1, t + 1, size=b)
    frames[0] = t
    n_lab = rng.randint(0, (s - 1) // 2 + 1, size=b)
    n_lab[0] = (s - 1) // 2
    if b > 1:
        frames[1] = 0
    if b > 2:
        n_lab[2] = 0
    s_idx = np.arange(s)[None, :]
    valid_s = (s_idx < 2 * n_lab[:, None] + 1).astype(np.float32)
    skip = ((s_idx % 2 == 1) & (s_idx >= 2) & (rng.rand(b, s) < 0.7)).astype(np.float32)
    fv = (np.arange(t)[:, None] < frames[None, :]).astype(np.float32)
    if holes:
        fv[1::3, 0] = 0.0
        if b > 2:
            fv[2::3, 2] = 0.0
    init = np.full((b, s), LOG_EPS, np.float32)
    init[:, 0] = 0.0
    init[:, 1] = np.where(n_lab > 0, 0.0, LOG_EPS)
    end = 2 * n_lab
    end_mask = ((s_idx == end[:, None])
                | ((s_idx == np.maximum(end - 1, 0)[:, None]) & (n_lab > 0)[:, None]))
    x = {"emit": emit_, "allow_skip": skip, "valid_s": valid_s, "init_mask": init,
         "end_mask": end_mask, "frame_valid": fv}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, torch.float32)
            for k, v in x.items()}


def ctc_kernels_vs_plain(x: dict, name: str) -> dict:
    """K2a and K2b on inputs ``x`` against their plain versions (alphas
    rel on live cells, their live set equal; dL/demit max-abs, K2b on the
    plain alphas), then again: two calls must agree bit for bit."""
    import torch

    import tpuasr_torch.ops.ctc as ctc_mod

    a_args, _ = ctc_kernel_args(ctc_mod, x)
    alphas = ctc_mod.ctc_alpha(*a_args)
    want = ctc_mod.ctc_alpha_reference(*a_args)
    _, b_args = ctc_kernel_args(ctc_mod, x, alphas=want)
    demit = ctc_mod.ctc_beta(*b_args)
    want_d = ctc_mod.ctc_beta_reference(*b_args)
    same = torch.equal(ctc_mod.ctc_alpha(*a_args), alphas) and torch.equal(
        ctc_mod.ctc_beta(*b_args), demit)
    torch.cuda.synchronize()
    live = want > ctc_mod.LOG_EPS / 2
    rel = ((alphas - want).abs() / want.abs().clamp(min=1.0))[live]
    row = {"case": name, "shape": list(alphas.shape),
           "alphas_rel_err": rel.max().item() if rel.numel() else 0.0,
           "alphas_max_abs_err": (alphas - want).abs()[live].max().item() if rel.numel() else 0.0,
           "live_equal": bool(torch.equal(alphas > ctc_mod.LOG_EPS / 2, live)),
           "demit_max_abs_err": (demit - want_d).abs().max().item(), "bit_identical": same,
           "plan": ctc_mod.ctc_plan("alpha", *alphas.shape[::2], alphas.device)}
    emit("kernel", kernel="ctc", **row)
    check(row["live_equal"] and row["alphas_rel_err"] <= 1e-5, f"ctc_alpha vs plain: {row}")
    check(row["demit_max_abs_err"] <= 2e-4, f"ctc_beta vs plain: {row}")
    check(same, f"ctc kernels not bit-identical over two calls: {name}")
    return row


def ctc_loss_vs_plain(t: int, l_cap: int, device: str = "cuda") -> dict:
    """The loss and dL/dlogits through ``ctc_loss`` (K2a, K2b) against the
    plain recursions, and F.ctc_loss on the feasible rows, at a train
    bucket's shape (``ctc_case``)."""
    import torch
    import torch.nn.functional as F

    from tpuasr_torch.ctc.loss import ctc_loss

    cuda = torch.device(device)
    logits, frames, labels, n_lab = ctc_case(cuda, t=t, l_cap=l_cap)
    b = logits.shape[0]
    feasible = (n_lab <= frames) & (frames > 0)
    out = {}
    for plain in (False, True):
        lg = logits.clone().requires_grad_()
        with plain_versions(plain):
            loss = ctc_loss(lg, frames, labels, n_lab)
            w = torch.where(feasible, 1.0 + torch.arange(b, device=cuda) / b, 0.0)
            (loss * w).sum().backward()
        out[plain] = (loss.detach(), lg.grad)
    (loss_k, g_k), (loss_p, g_p) = out[False], out[True]
    idx = feasible.nonzero()[:, 0]
    lib = F.ctc_loss(torch.log_softmax(logits[idx], -1).transpose(0, 1), labels[idx],
                     frames[idx], n_lab[idx], blank=0, reduction="none")
    row = {"case": f"loss-{t}", "shape": [t, b, 2 * l_cap + 1],
           "loss_rel_err": ((loss_k - loss_p).abs()
                            / loss_p.abs().clamp(min=1.0))[feasible].max().item(),
           "dlogits_max_abs_err": (g_k - g_p).abs().max().item(),
           "f_ctc_loss_rel_err": ((lib - loss_k[idx]).abs()
                                  / lib.abs().clamp(min=1.0)).max().item(),
           "rows": {"empty_label": 1, "infeasible": 2, "zero_frames": 3},
           "infeasible_losses": loss_k[~feasible].tolist()}
    emit("kernel", kernel="ctc", **row)
    check(row["loss_rel_err"] <= 1e-5 and row["dlogits_max_abs_err"] <= 2e-4,
          f"CTC kernels vs plain: {row}")
    check(row["f_ctc_loss_rel_err"] <= 1e-4, f"CTC vs F.ctc_loss on feasible rows: {row}")
    check(bool((loss_k[~feasible] > 1e29).all()), "infeasible rows must give ~1e30")
    return row


def ctc_split(run, reps: int = 1):
    """K2a's and K2b's step split: ``run()`` (``reps`` times) with their
    step timer on (``tpuasr_torch.ops.ctc.ctc_parts``), reduced over every
    block and call, for each kernel: each span's share of the loop's
    clock64 cycles (thread 0: the wait on the step's inputs, the lse3
    math, the stores, the exchange with the neighbours) and cycles a step
    (alpha T - 1 steps a call, beta T). None when nothing launched (a CPU
    rehearsal, or a checkout without the timer)."""
    import torch

    import tpuasr_torch.ops.ctc as ctc_mod

    if not hasattr(ctc_mod, "CTC_PARTS"):
        return None
    ctc_mod.ctc_parts = []
    try:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        parts = ctc_mod.ctc_parts
    finally:
        ctc_mod.ctc_parts = None
    names = ctc_mod.CTC_PARTS
    out = {}
    for kernel in ("alpha", "beta"):
        calls = [c for c in parts if c["kernel"] == kernel]
        if not calls:
            continue
        cycles = dict.fromkeys(names, 0.0)
        for c in calls:
            for k, v in zip(names, c["timer"].double().mean(0).tolist()):
                cycles[k] += v
        steps = sum(max(c["T"] - (kernel == "alpha"), 1) for c in calls)
        out[kernel] = {"share": {k: cycles[k] / max(cycles["loop"], 1.0) for k in names[:-1]},
                       "cycles_per_step": {k: v / steps for k, v in cycles.items()},
                       "steps_per_run": steps / reps}
    return out or None


CTC_VARIANTS = ({"_slots": 2}, {"_slots": 3})  # slots a thread, beside the default (1)


def ctc_times(smi: str, label: str = "tree", device: str = "cuda") -> list:
    """The ``ctc_split`` phase: K2a's and K2b's times at both train buckets
    (B=32, T'=251 with S=261, T'=826 with S=837), the launches queued
    ahead of the card (``time_queued``, medians of three means of 20
    calls), and each kernel's step split (``ctc_split``) scaled to the
    untimed step; where the wrappers take launch-plan overrides, the same
    for each of ``CTC_VARIANTS``. One JSON line a shape and variant, tagged
    ``label``; the tpuasr_torch imported is the first on sys.path (the
    ``--time-ctc`` mode times another checkout this way)."""
    import inspect

    import torch

    import tpuasr_torch.ops.ctc as ctc_mod

    knobs = "_slots" in inspect.signature(ctc_mod.ctc_alpha).parameters
    rows = []
    for t, l_cap in CTC_SHAPES:
        x = ctc_inputs(*ctc_case(torch.device(device), t=t, l_cap=l_cap))
        a_args, b_args = ctc_kernel_args(ctc_mod, x)
        for kw in ({}, *(CTC_VARIANTS if knobs else ())):
            fns = {"alpha": lambda: ctc_mod.ctc_alpha(*a_args, **kw),
                   "beta": lambda: ctc_mod.ctc_beta(*b_args, **kw)}
            ms = {k: sorted(time_queued(fn) for _ in range(3)) for k, fn in fns.items()}
            split = ctc_split(lambda: [fn() for fn in fns.values()])
            row = {"label": label, "shape": list(x["emit"].shape), "variant": kw,
                   **{f"{k}_ms": v[1] for k, v in ms.items()},
                   **{f"{k}_ms_range": [v[0], v[2]] for k, v in ms.items()}}
            if knobs:
                row["plan"] = ctc_mod.ctc_plan("alpha", t, x["emit"].shape[2], device,
                                               kw.get("_slots", 0))
            if not kw:  # events around a host loop of launches, not queued: the trap
                row.update({f"{k}_host_loop_ms": time_ms(fn, iters=20) for k, fn in fns.items()})
            for k, sp in (split or {}).items():
                step_us = row[f"{k}_ms"] * 1e3 / sp["steps_per_run"]
                row[f"{k}_split"] = {**sp, "step_us": step_us, "us_per_step": {
                    p: v * step_us for p, v in sp["share"].items()}}
            emit("ctc_split", **row, nvidia_smi=smi)
            rows.append(row)
    return rows


def phase_kernel_ctc(smi: str, device: str = "cuda"):
    """K2a and K2b against their plain versions: through the loss and its
    gradient at both train buckets (F.ctc_loss a third opinion), and
    their own outputs there, at S=5001 (past the old 4096 cap), at T=1
    and with a frame mask that is not a prefix, each twice for bit
    equality; then their times, the launches queued ahead of the card,
    beside the plain versions', F.ctc_loss's (which synchronises, so it
    is timed around a host loop) and the bounds."""
    import torch
    import torch.nn.functional as F

    import tpuasr_torch.ops.ctc as ctc_mod

    cuda = torch.device(device)
    loss_rows = [ctc_loss_vs_plain(t, l_cap, device) for t, l_cap in CTC_SHAPES]
    rows = [ctc_kernels_vs_plain(ctc_inputs(*ctc_case(cuda, t=t, l_cap=l_cap)), f"train-{t}")
            for t, l_cap in CTC_SHAPES]
    rows += [ctc_kernels_vs_plain(ctc_case_small(cuda, 5, 2, 5001), "S5001"),
             ctc_kernels_vs_plain(ctc_case_small(cuda, 1, 4, 261), "T1"),
             ctc_kernels_vs_plain(ctc_case_small(cuda, 40, 6, 61, holes=True), "holes")]

    timings = {"ctc_alpha": [], "ctc_beta": []}
    for t, l_cap in CTC_SHAPES:
        logits, frames, labels, n_lab = ctc_case(cuda, t=t, l_cap=l_cap)
        x = ctc_inputs(logits, frames, labels, n_lab)
        b, s = x["emit"].shape[1:]
        a_args, b_args = ctc_kernel_args(ctc_mod, x)
        (alpha_bound, alpha_by), (beta_bound, beta_by) = ctc_bounds(t, b, s)
        log_probs = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
        lp_grad = log_probs.clone().requires_grad_()
        lib_frames = frames.clamp(min=1)  # the library call is given >= 1 frame a row

        def lib_fwd():
            with torch.no_grad():
                F.ctc_loss(log_probs, labels, lib_frames, n_lab, reduction="none")

        def lib_fwd_bwd():
            F.ctc_loss(lp_grad, labels, lib_frames, n_lab, reduction="none").sum().backward()

        # F.ctc_loss copies the lengths from pageable host memory, which
        # waits for the stream: it cannot be queued ahead, so CUDA events
        # time it around a host loop of 20 calls
        lib_fwd_ms = time_ms(lib_fwd, iters=20)
        plain_iters = 3 if t < 500 else 1
        timing = {"shape": [t, b, s], "timing": "kernel: launches queued behind "
                  "torch.cuda._sleep, mean of 20; library: events around 20 calls",
                  "nvidia_smi": smi}
        timings["ctc_alpha"].append({
            **timing, "ms": time_queued(lambda: ctc_mod.ctc_alpha(*a_args)),
            "plain_ms": time_ms(lambda: ctc_mod.ctc_alpha_reference(*a_args), iters=plain_iters),
            "library_ms": lib_fwd_ms, "bound_ms": alpha_bound, "bound_by": alpha_by})
        timings["ctc_beta"].append({
            **timing, "ms": time_queued(lambda: ctc_mod.ctc_beta(*b_args)),
            "plain_ms": time_ms(lambda: ctc_mod.ctc_beta_reference(*b_args), iters=plain_iters),
            "library_ms": time_ms(lib_fwd_bwd, iters=20) - lib_fwd_ms, "bound_ms": beta_bound,
            "bound_by": beta_by})
        for k, v in timings.items():
            emit("kernel_time", kernel=k, **v[-1])
    first = {"loss_rel_err": max(r["loss_rel_err"] for r in loss_rows),
             "dlogits_max_abs_err": max(r["dlogits_max_abs_err"] for r in loss_rows),
             "alphas_max_abs_err": max(r["alphas_max_abs_err"] for r in rows),
             "demit_max_abs_err": max(r["demit_max_abs_err"] for r in rows)}
    return first, timings


# ------------------------------------------------------------------- train

def read_jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# The recurrent kernels of each model path: the ops module, its forward
# and backward wrappers (ds2 imports the forward one by name), its
# autograd function, the plain forward, and the span names of the time
# splits. "gru" is rnn_impl scan/pallas (K1), "gru2" is pallas2 (K5).
RNN_PATHS = {
    "gru": ("tpuasr_torch.ops.gru", "bigru_forward", "bigru_backward", "BiGRUFunction",
            "bigru_reference", ("k1f", "k1b")),
    "lstm": ("tpuasr_torch.ops.lstm", "bilstm_forward", "bilstm_backward", "BiLSTMFunction",
             "bilstm_reference", ("k4f", "k4b")),
    "gru2": ("tpuasr_torch.ops.gru2", "bigru2_forward", "bigru2_backward", "BiGRU2Function",
             "bigru2_reference", ("k5f", "k5b")),
    # unidirectional GRU with a Lookahead layer: K1 with one direction
    "uni": ("tpuasr_torch.ops.gru", "bigru_forward", "bigru_backward", "BiGRUFunction",
            "bigru_reference", ("k1f", "k1b")),
}
# the train CLI's flags of each path
RNN_FLAGS = {"gru": (), "lstm": ("--rnn-type", "lstm"), "gru2": ("--rnn-impl", "pallas2"),
             "uni": ("--no-bidirectional", "--lookahead-context", "20")}


def rnn_path(path: str):
    """(module, forward name, backward name, autograd function, plain
    forward, span names) of a path's recurrent kernels."""
    import importlib

    mod_name, fwd, bwd, fn, plain, spans = RNN_PATHS[path]
    mod = importlib.import_module(mod_name)
    return mod, fwd, bwd, getattr(mod, fn), getattr(mod, plain), spans


def phase_train(smi: str, name: str, device: str = "cuda", width=("800", "5"),
                n_train: int = 64, n_val: int = 32, batch: int = 32,
                path: str = "gru", epochs: int = 2, paths=None):
    """The training main path through tpuasr_torch.cli.train for one
    model path of RNN_PATHS (the flags of RNN_FLAGS); ``paths`` reuses
    a corpus already written. ``device`` and ``width`` other than the
    defaults only rehearse it on the CPU."""
    import shutil

    import torch

    from tpuasr_torch.cli import synth_corpus
    from tpuasr_torch.cli import train as train_cli
    from tpuasr_torch.serve import TranscriptionService

    work = ROOT / "build" / "chip_smoke"
    corpus, out = work / "corpus", work / ("train" if path == "gru" else f"train_{path}")
    shutil.rmtree(out, ignore_errors=True)
    if paths is None:
        shutil.rmtree(corpus, ignore_errors=True)
        paths = synth_corpus.generate(str(corpus), n_train + n_val, 5.0,
                                      n_val / (n_train + n_val), seed=0)
    argv = ["--train-manifest", paths["train"], "--val-manifest", paths["val"],
            "--hidden-size", width[0], "--hidden-layers", width[1], *RNN_FLAGS[path],
            "--batch-size", str(batch), "--epochs", str(epochs), "--checkpoint",
            "--save-folder", str(out), "--model-path", str(out / "best.ckpt"),
            "--log-dir", str(out / "log"), "--sync-every", "1", "--device", device]
    counters = list(kernel_counters().values())
    for fn in counters:  # ---- the main path starts here
        fn.launches = 0
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = train_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ---- and ends here
    sys.stdout.write(log.getvalue())
    check(rc == 0, f"cli.train returned {rc}")
    rows = read_jsonl(out / "log" / "metrics.jsonl")
    steps = [r for r in rows if "train/loss" in r]
    epoch_rows = [r for r in rows if "epoch/loss" in r]
    check(len(steps) == epochs * n_train // batch, f"{len(steps)} train steps logged")
    for r in steps:
        check(np.isfinite(r["train/loss"]) and np.isfinite(r["train/grad_norm"]),
              f"non-finite step {r}")
        check(r["train/n_ok"] == batch, f"n_ok {r['train/n_ok']} != {batch}")
    if device == "cuda":  # this path's kernels, dW's and CTC's launched, no other RNN kernel
        used = {*RNN_PATHS[path][1:3], "rnn_weight_grads", "ctc_alpha", "ctc_beta"}
        check(all((v > 0) == (k in used) for k, v in launches.items()),
              f"kernel launches on the {path} training path: {launches}")
    step_s = [r["train/step_time"] for r in steps]
    ckpt = out / "best.ckpt"
    check(ckpt.exists() and (out / f"tpuasr_{epochs}.ckpt").exists(), "checkpoints not written")
    svc = TranscriptionService(str(ckpt), device=device)
    try:
        wav = Path(paths["val"]).read_text().splitlines()[0].split(",")[0]
        text, offsets = svc.transcribe_wav_bytes(Path(wav).read_bytes())
    finally:
        svc.close()
    check(isinstance(text, str) and len(offsets) == len(text), "transcription of a WAV")
    result = {
        "path": path, "device": name, "nvidia_smi": smi, "wall_s": wall_s, "steps": len(steps),
        "batch": batch, "losses": [r["train/loss"] for r in steps],
        "grad_norms": [r["train/grad_norm"] for r in steps],
        "step_ms": [1e3 * x for x in step_s],
        # the first step of each epoch includes cuDNN/cuBLAS first use
        "step_ms_after_first": 1e3 * float(np.mean(step_s[1:])) if len(step_s) > 1 else None,
        "utt_per_s_after_first": batch / float(np.mean(step_s[1:])) if len(step_s) > 1 else None,
        "val_wer": [r["epoch/wer"] for r in epoch_rows],
        "log": str((out / "log" / "metrics.jsonl").relative_to(ROOT)),
        "launches": launches, "checkpoint": str(ckpt.relative_to(ROOT)),
        "transcribed": {"wav": Path(wav).name, "text": text},
    }
    emit("train", **result)
    return result, out, paths


def train_step_parity(out, paths, device: str = "cuda", path: str = "gru") -> dict:
    """One train step's loss and gradients through the kernels against
    the plain versions on the card, same weights (the epoch-1
    checkpoint) and the first training batch, before any update."""
    import torch

    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.train.checkpoint import load_checkpoint
    from tpuasr_torch.train.step import batch_loss

    pkg = load_checkpoint(str(out / "tpuasr_1.ckpt"))
    plan = make_buckets(order_and_prune(read_manifest(paths["train"])), 32, BucketSpec())
    batch = next(iter(AudioBatchLoader(plan, pkg.alphabet, transfer_dtype="int16").epoch(0)))
    res = {}
    for plain in (False, True):
        model = model_from_variables(pkg.variables, pkg.model_config, torch.device(device),
                                     trainable=True)
        with plain_versions(plain):
            loss, n_ok, _ = batch_loss(model, pkg.frontend_config, batch.waves,
                                       batch.wave_lengths, batch.labels,
                                       batch.label_lengths, batch.valid)
            loss.backward()
        res[plain] = (loss.item(), {k: p.grad for k, p in model.named_parameters()})
    (loss_k, g_k), (loss_p, g_p) = res[False], res[True]
    errs = {k: rel_norm_err(g_k[k], g_p[k]) for k in g_p}
    worst = max(errs, key=errs.get)
    row = {"path": path, "loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_norm_err_max": errs[worst], "worst_param": worst,
           "grad_rel_norm_err_median": float(np.median(list(errs.values())))}
    emit("train_parity", **row)
    check(row["loss_rel_err"] <= 1e-2 and errs[worst] <= 5e-2,
          f"train step, kernels vs plain: {row}")
    return row


def train_breakdown(out, paths, smi: str, path: str = "gru") -> dict:
    """Where one full-width train step's device time goes: CUDA events
    around the frontend, the conv blocks, the RNN layers' forward (the
    path's forward kernel inside: K1f, K4f or K5f), the CTC loss (K2a
    inside), the CTC backward (``CTCFromEmit.backward``, K2b inside), the
    backward's RNN kernel (K1b, K4b or K5b) calls, the rest of the RNN
    backward (dw and db, packing), the clip and the SGD step, and
    the whole step; ``ctc_ms`` is the CTC layer's forward and backward
    (not the log-softmax's backward); ``rest`` is what no span
    covers (the backward of the convs, projections, BatchNorms and head,
    and the global norms). Means over 3 steps after a warm one; then the
    forward kernel's step split over one more step."""
    import torch

    import tpuasr_torch.ops.ctc as ctc_mod
    import tpuasr_torch.train.step as step_mod
    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.train.checkpoint import load_checkpoint

    pkg = load_checkpoint(str(out / "tpuasr_1.ckpt"))
    plan = make_buckets(order_and_prune(read_manifest(paths["train"])), 32, BucketSpec())
    batch = next(iter(AudioBatchLoader(plan, pkg.alphabet, transfer_dtype="int16").epoch(0)))
    model = model_from_variables(pkg.variables, pkg.model_config, torch.device("cuda"),
                                 trainable=True)
    step = step_mod.make_train_step(model, pkg.frontend_config, step_mod.TrainConfig())
    spans = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed(name, fn):
        def wrapper(*a, **kw):
            s = event()
            r = fn(*a, **kw)
            spans.append((name, s, event()))
            return r
        # a patched wrapper stands in for the module's name, which is
        # where the kernel wrappers keep their launch counts
        wrapper.launches = 0
        return wrapper

    mod, fwd_name, bwd_name, fn_cls, _, (kf, kb) = rnn_path(path)
    patches = [
        mock.patch.object(step_mod, "log_spectrogram", timed("frontend", step_mod.log_spectrogram)),
        mock.patch.object(step_mod, "ctc_loss", timed("ctc_loss_forward", step_mod.ctc_loss)),
        mock.patch.object(mod, fwd_name, timed(kf, getattr(mod, fwd_name))),
        mock.patch.object(mod, bwd_name, timed(kb, getattr(mod, bwd_name))),
        mock.patch.object(ctc_mod, "ctc_alpha", timed("k2a", ctc_mod.ctc_alpha)),
        mock.patch.object(ctc_mod, "ctc_beta", timed("k2b", ctc_mod.ctc_beta)),
        mock.patch.object(fn_cls, "backward",
                          staticmethod(timed("rnn_backward_fn", fn_cls.backward))),
        mock.patch.object(ctc_mod.CTCFromEmit, "backward",
                          staticmethod(timed("ctc_backward_fn", ctc_mod.CTCFromEmit.backward))),
        mock.patch.object(step_mod, "clip_by_global_norm_",
                          timed("clip", step_mod.clip_by_global_norm_)),
        mock.patch.object(step.optimizer, "step", timed("sgd_step", step.optimizer.step)),
    ]
    args = (batch.waves, batch.wave_lengths, batch.labels, batch.label_lengths, batch.valid, 3e-4)
    step(*args)  # warm, before any span is recorded
    hooks, starts = [], {}
    for name, mods in (("conv", model.convs), ("rnn_forward", model.rnns)):
        for m in mods:
            hooks.append(m.register_forward_pre_hook(
                lambda m, a: starts.__setitem__(id(m), event())))
            hooks.append(m.register_forward_hook(
                lambda m, a, o, name=name: spans.append((name, starts[id(m)], event()))))
    for p in patches:
        p.start()
    try:
        reps = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = event()
        for _ in range(reps):
            step(*args)
        end = event()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        for p in patches:
            p.stop()
        for h in hooks:
            h.remove()
    ms: dict = {}
    for name, s, e in spans:
        ms[name] = ms.get(name, 0.0) + s.elapsed_time(e) / reps
    total = start.elapsed_time(end) / reps
    top = ("frontend", "conv", "rnn_forward", "ctc_loss_forward", "ctc_backward_fn",
           "rnn_backward_fn", "clip", "sgd_step")  # disjoint spans
    row = {"path": path, "batch": list(batch.waves.shape), "step_device_ms": total,
           "step_host_ms": host_ms, **{f"{k}_ms": v for k, v in sorted(ms.items())},
           "rest_ms": total - sum(ms[k] for k in top),  # other backward work, norms
           f"rnn_backward_outside_{kb}_ms": ms["rnn_backward_fn"] - ms[kb],
           "ctc_backward_outside_k2b_ms": ms["ctc_backward_fn"] - ms["k2b"],
           "ctc_ms": ms["ctc_loss_forward"] + ms["ctc_backward_fn"],
           f"rnn_forward_outside_{kf}_ms": ms["rnn_forward"] - ms[kf],
           # the forward kernel's step, split (one more step, timer on)
           f"{kf}_split": split_us(fwd_split(lambda: step(*args)), ms[kf]),
           "nvidia_smi": smi}
    emit("train_breakdown", **row)
    return row


# -------------------------------------------------------------------- beam

BEAM_W, BEAM_TOP_N = 10, 40


def corpus_texts(paths) -> list:
    from tpuasr_torch.data.manifest import read_manifest

    return [e.read_transcript().strip() for e in read_manifest(paths["all"])]


def large_vocab_lines(vocab_size: int, seed: int = 0) -> list:
    """A synthetic large-vocabulary corpus: every word of a seeded,
    sorted vocabulary of random 3-7 letter words once, in lines of 6
    (so a trigram model of it has ~vocab unique bi- and trigrams)."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    vocab = sorted({"".join(rng.choice(letters, size=rng.randint(3, 8)))
                    for _ in range(int(vocab_size * 1.2))})[:vocab_size]
    order = np.arange(len(vocab))
    rng.shuffle(order)
    return [" ".join(vocab[i] for i in order[s:s + 6]) for s in range(0, len(order), 6)]


def beam_decoders(alphabet, texts, vocab_size: int = 50000) -> dict:
    """The four LM modes of K3's checks, as DeviceBeamDecoders (W=10,
    cutoff_top_n 40, alpha 0.8, beta 1.0): no LM; a char trigram and a
    word trigram of the corpus texts; a word trigram of a large
    synthetic vocabulary (its table packing is timed)."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.lm import train_ngram

    kw = dict(beam_width=BEAM_W, cutoff_top_n=BEAM_TOP_N, alpha=0.8, beta=1.0)
    char_lines = [" ".join("<sp>" if ch == " " else ch for ch in t) for t in texts]
    t0 = time.perf_counter()
    big = train_ngram(large_vocab_lines(vocab_size), order=3)
    t1 = time.perf_counter()
    decs = {"none": DeviceBeamDecoder(alphabet, beam_width=BEAM_W, cutoff_top_n=BEAM_TOP_N),
            "char": DeviceBeamDecoder(alphabet, char_lm=train_ngram(char_lines, order=3), **kw),
            "word": DeviceBeamDecoder(alphabet, word_lm=train_ngram(texts, order=3), **kw)}
    t2 = time.perf_counter()
    decs["word-large"] = DeviceBeamDecoder(alphabet, word_lm=big, **kw)
    tables = decs["word-large"]._word_tables
    emit("beam_lm", vocab=vocab_size, entries=sum(len(t) for t in big.ngrams),
         caps=[len(k) for k in tables.keys1], salts=list(tables.salts),
         train_ngram_s=t1 - t0, pack_s=time.perf_counter() - t2)
    return decs


def wide_beam_decoders(alphabet, texts) -> dict:
    """K3 past its first limits (W <= 64, char orders <= 6): W=100 with
    no LM and with the corpus' char and word trigrams, and a char 7-gram
    (a 36-bit context) at W=10; alpha and beta as ``beam_decoders``."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.lm import train_ngram

    kw = dict(cutoff_top_n=BEAM_TOP_N, alpha=0.8, beta=1.0)
    char_lines = [" ".join("<sp>" if ch == " " else ch for ch in t) for t in texts]
    return {"none-W100": DeviceBeamDecoder(alphabet, beam_width=100, cutoff_top_n=BEAM_TOP_N),
            "char-W100": DeviceBeamDecoder(alphabet, beam_width=100,
                                           char_lm=train_ngram(char_lines, order=3), **kw),
            "word-W100": DeviceBeamDecoder(alphabet, beam_width=100,
                                           word_lm=train_ngram(texts, order=3), **kw),
            "char7": DeviceBeamDecoder(alphabet, beam_width=BEAM_W,
                                       char_lm=train_ngram(char_lines, order=7), **kw)}


def sentence_logits(alphabet, texts, b: int, t: int, seed: int):
    """(B, T, C) logits spelling known sentences, each char for 1-3 frames
    and a blank after it (+6 on the spelled class over N(0, 1) noise), and
    ragged lengths: row 0 the whole T, row 1 none, the others where their
    sentences end."""
    rng = np.random.RandomState(seed)
    c_num = alphabet.size
    logits = rng.standard_normal((b, t, c_num)).astype(np.float32)
    lengths = np.zeros(b, np.int32)
    for j in range(b):
        if j == 1:
            continue
        f, k = 0, j
        ids = alphabet.encode(texts[k % len(texts)])
        while f + 6 < t:
            if not ids:
                k += 1
                ids = [alphabet.space_id] + alphabet.encode(texts[k % len(texts)])
            r = rng.randint(1, 4)
            logits[j, f:f + r, ids.pop(0)] += 6.0
            logits[j, f + r:f + r + 2, alphabet.blank_id] += 6.0
            f += r + rng.randint(1, 3)
        lengths[j] = t if j == 0 else f
    return logits, lengths


def flagship_logits(out, paths, bucket_s: float, device: str = "cuda"):
    """The trained flagship's logits over the validation utterances (5 s
    bucket) or over three of them played back to back (16.5 s bucket)."""
    import torch

    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.train.checkpoint import load_checkpoint
    from tpuasr_torch.train.step import make_eval_step

    pkg = load_checkpoint(str(out / "best.ckpt"))
    model = model_from_variables(pkg.variables, pkg.model_config, torch.device(device))
    eval_step = make_eval_step(model, pkg.frontend_config)
    spec = BucketSpec()
    plan = make_buckets(order_and_prune(read_manifest(paths["val"])), 32, spec, shuffle=False)
    batch = next(iter(AudioBatchLoader(plan, pkg.alphabet, transfer_dtype="int16").epoch(0)))
    waves, lens = np.asarray(batch.waves), np.asarray(batch.wave_lengths)
    if bucket_s > 5.0:
        n = spec.bucket_samples(spec.bucket_of(bucket_s))
        long_w = np.zeros((waves.shape[0], n), waves.dtype)
        long_l = np.zeros_like(lens)
        for j in range(waves.shape[0]):
            parts = [waves[(j + i) % len(waves), :lens[(j + i) % len(waves)]] for i in range(3)]
            cat = np.concatenate(parts)[:n]
            long_w[j, :len(cat)], long_l[j] = cat, len(cat)
        waves, lens = long_w, long_l
    logits, out_len = eval_step(waves, lens)
    return logits.float().cpu().numpy(), out_len.cpu().numpy().astype(np.int32)


def beam_bound(lengths, c: int, w: int, dec) -> tuple:
    """K3's least time for one call: the operations its frames need (the
    frames up to each utterance's length) at the f32 peak, or the bytes
    (log-probs in, int8 backpointers and f32 scores out, the LM tables
    read once), whichever is larger. Operations per utterance and frame:
    the C*C rank compares (2 each), W*C extends of ~10 operations with 2
    more for each of the W stay hashes they are matched against, a
    log-add of ~6 over the W + W*C pool, W selection passes over it (2
    each); an LM adds its probes (8 slots of ~4 operations each): the
    word LM ~2 x order probes a beam, the char LM order probes an
    extend."""
    e, pool = w * c, w + w * c
    per_frame = 2 * c * c + e * (10 + 2 * w) + 6 * pool + 2 * w * pool
    table_bytes = 0
    if dec._word_tables is not None:
        per_frame += w * 2 * 8 * 4 * dec._word_tables.order
        table_bytes = 16 * sum(len(k) for k in dec._word_tables.keys1)
    elif dec._lm_tables is not None and dec.cfg.alpha != 0.0:
        per_frame += e * 8 * 4 * dec._lm_tables.order
        table_bytes = 16 * sum(len(k) for k in dec._lm_tables.keys1)
    frames = int(np.asarray(lengths).sum())
    b, t = len(lengths), int(np.asarray(lengths).max(initial=0))
    ops = float(per_frame) * frames
    nbytes = 4.0 * b * t * c + 4 * b + 2.0 * b * t * w + 4.0 * b * w + table_bytes
    by_ops, by_bytes = ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes", ops


def best_texts(dec, parents, chars, scores, n_class: int) -> list:
    from tpuasr_torch.decode.beam import _backtrack

    store, toff, blen, _ = _backtrack(*dec.to_host(parents, chars, scores, n_class))
    return [dec.readout(store[j, 0], toff[j, 0], blen[j, 0])[0] for j in range(store.shape[0])]


def phase_kernel_beam(out, paths, smi: str, device: str = "cuda", vocab_size: int = 50000):
    """K3 against its plain version on the card, in four LM modes, at
    B=32, W=10, C=44, T'=251 and T'=826, on peaked logits of the corpus
    sentences plus noise and on the trained flagship's logits: equal
    parents and chars, scores within 1e-5 relative, equal texts; the same
    at T'=251 for W=100 (no LM, char, word) and a char 7-gram
    (``wide_beam_decoders``); then 4 chunked stateful calls against one
    call; then times beside the bound. ``device`` and ``vocab_size``
    other than the defaults only rehearse it on the CPU."""
    import torch

    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.ops.beam import beam_scan, beam_scan_reference, make_beam_state

    cuda = torch.device(device)
    alphabet = Alphabet()
    texts = corpus_texts(paths)
    decs = beam_decoders(alphabet, texts, vocab_size)
    wide = wide_beam_decoders(alphabet, texts)
    inputs = {}
    for t, bucket_s in ((251, 5.0), (826, 16.5)):
        inputs[f"sentences-{t}"] = sentence_logits(alphabet, texts, 32, t, seed=t)
        inputs[f"flagship-{t}"] = flagship_logits(out, paths, bucket_s, device)
    worst, rows = 0.0, []
    for mode, dec in {**decs, **wide}.items():
        for name, (logits, lengths) in inputs.items():
            if mode in wide and name.endswith("826"):
                continue  # the wide cases at T'=251 only: their plain version is slow
            lp, lens = dec.logprobs(torch.from_numpy(logits).to(cuda), lengths)
            kw = dict(beam_width=dec.cfg.beam_width, blank_id=alphabet.blank_id,
                      cutoff_top_n=BEAM_TOP_N, **dec.kernel_lm_kwargs(lp.shape[2], cuda))
            got = beam_scan(lp, lens, **kw)
            torch.cuda.synchronize()
            want = beam_scan_reference(lp, lens, **kw)
            err = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1.0)).max().item()
            t_got = best_texts(dec, *got, lp.shape[2])
            t_want = best_texts(dec, *want, lp.shape[2])
            row = {"mode": mode, "input": name, "shape": list(lp.shape),
                   "beam_width": dec.cfg.beam_width, "parents_equal": bool(torch.equal(got[0], want[0])),
                   "chars_equal": bool(torch.equal(got[1], want[1])),
                   "score_rel_err": err, "texts_equal": t_got == t_want,
                   "score_abs_err": (got[2] - want[2]).abs().max().item(),
                   "text_0": t_got[0][:60]}
            emit("kernel", kernel="beam", **row)
            check(row["parents_equal"] and row["chars_equal"] and row["texts_equal"]
                  and err <= 1e-5, f"K3 vs plain: {row}")
            worst = max(worst, row["score_abs_err"])
            rows.append(row)

    # stateful mode: 4 chunked calls equal one call
    logits, lengths = inputs["flagship-251"]
    for mode, dec in {**decs, "char7": wide["char7"]}.items():
        lp, lens = dec.logprobs(torch.from_numpy(logits).to(cuda), lengths)
        kw = dict(beam_width=BEAM_W, blank_id=alphabet.blank_id, cutoff_top_n=BEAM_TOP_N,
                  **dec.kernel_lm_kwargs(lp.shape[2], cuda))
        full = beam_scan(lp, lens, return_state=True, **kw)
        lm_mode = mode.split("-")[0].rstrip("7")  # "char7": the char LM
        tabs = kw.get("word_tables", kw.get("char_tables"))
        ring = 0 if tabs is None else max(1, tabs.order - 1)
        state = make_beam_state(32, BEAM_W, lm_mode=lm_mode, ring_len=ring, device=cuda)
        step = -(-lp.shape[1] // 4)
        ps, cs = [], []
        for t0 in range(0, lp.shape[1], step):
            n = torch.clamp(lens - t0, 0, step).to(torch.int32)
            p, c, scores, state = beam_scan(lp[:, t0:t0 + step].contiguous(), n, state=state,
                                            return_state=True, **kw)
            ps.append(p)
            cs.append(c)
        torch.cuda.synchronize()
        same = (torch.equal(torch.cat(ps, 1), full[0]) and torch.equal(torch.cat(cs, 1), full[1])
                and torch.equal(scores, full[2])
                and all(torch.equal(a, b) for a, b in zip(state, full[3])))
        emit("kernel", kernel="beam", mode=mode, input="flagship-251", stateful_chunks=4,
             equal_to_one_call=same)
        check(same, f"K3 stateful chunks != one call ({mode})")

    timings = []
    for mode, dec in {**decs, **wide}.items():
        for name in ("flagship-251",) if mode in wide else ("flagship-251", "flagship-826"):
            logits, lengths = inputs[name]
            lp, lens = dec.logprobs(torch.from_numpy(logits).to(cuda), lengths)
            w = dec.cfg.beam_width
            kw = dict(beam_width=w, blank_id=alphabet.blank_id, cutoff_top_n=BEAM_TOP_N,
                      **dec.kernel_lm_kwargs(lp.shape[2], cuda))
            bound_ms, bound_by, ops = beam_bound(lengths, lp.shape[2], w, dec)
            row = {"mode": mode, "shape": list(lp.shape), "beam_width": w,
                   "frames": int(lengths.sum()),
                   "ms": time_ms(lambda: beam_scan(lp, lens, **kw), iters=10, warmup=2),
                   "plain_ms": (time_ms(lambda: beam_scan_reference(lp, lens, **kw), iters=1,
                                        warmup=0) if name.endswith("251") else None),
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                   "ops": ops, "nvidia_smi": smi}
            emit("kernel_time", kernel="beam", **row)
            timings.append(row)
    return worst, timings


def k3_split(run):
    """K3's frame split: ``run()`` once with its frame timer on
    (``tpuasr_torch.ops.beam.k3_parts``), reduced over every block: each
    phase's share of the loop's clock64 cycles (thread 0, phases ending
    at their barriers), cycles and barriers a frame. None when nothing
    launched (a CPU rehearsal)."""
    import torch

    import tpuasr_torch.ops.beam as beam_mod

    beam_mod.k3_parts = []
    try:
        run()
        torch.cuda.synchronize()
        parts = beam_mod.k3_parts
    finally:
        beam_mod.k3_parts = None
    if not parts:
        return None
    names = beam_mod.K3_PARTS
    sums = dict(zip(names, torch.stack([c["timer"].sum(0) for c in parts]).sum(0).tolist()))
    frames = max(sums["frames"], 1)
    return {"share": {k: sums[k] / max(sums["loop"], 1) for k in names[:names.index("loop")]},
            "cycles_per_frame": sums["loop"] / frames,
            "barriers_per_frame": sums["barriers"] / frames}


def beam_split(texts, smi: str, device: str = "cuda") -> list:
    """K3's frame split at B=32, T'=251 (peaked logits of the corpus
    sentences), W=10 and W=100, with no LM, the char trigram and the word
    trigram of the corpus texts (alpha 0.8, beta 1.0): each phase in µs a
    frame, the untimed kernel's time per frame of its longest row scaled by
    the phase's share of the timed loop, and the barriers a frame."""
    import torch

    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.lm import train_ngram
    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.ops.beam import beam_scan

    cuda = torch.device(device)
    alphabet = Alphabet()
    char_lines = [" ".join("<sp>" if ch == " " else ch for ch in t) for t in texts]
    lms = {"none": {}, "char": {"char_lm": train_ngram(char_lines, order=3)},
           "word": {"word_lm": train_ngram(texts, order=3)}}
    logits, lengths = sentence_logits(alphabet, texts, 32, 251, seed=251)
    rows = []
    for w in (BEAM_W, 100):
        for mode, lm in lms.items():
            dec = DeviceBeamDecoder(alphabet, beam_width=w, cutoff_top_n=BEAM_TOP_N,
                                    **({"alpha": 0.8, "beta": 1.0, **lm} if lm else {}))
            lp, lens = dec.logprobs(torch.from_numpy(logits).to(cuda), lengths)
            kw = dict(beam_width=w, blank_id=alphabet.blank_id, cutoff_top_n=BEAM_TOP_N,
                      **dec.kernel_lm_kwargs(lp.shape[2], cuda))
            ms = time_ms(lambda: beam_scan(lp, lens, **kw), iters=5, warmup=1)
            split = k3_split(lambda: beam_scan(lp, lens, **kw))
            row = {"mode": mode, "beam_width": w, "shape": list(lp.shape), "ms": ms,
                   "us_per_frame": ms * 1e3 / int(lengths.max()), "nvidia_smi": smi}
            if split is not None:
                row.update(split, us_per_frame_by_phase={
                    k: v * row["us_per_frame"] for k, v in split["share"].items()})
            emit("beam_split", **row)
            rows.append(row)
    return rows


def limit_alphabet(c: int):
    """An alphabet of c classes: blank, c - 2 letters (Latin Extended code
    points), space."""
    from tpuasr_torch.labels import Alphabet

    return Alphabet(labels="_" + "".join(chr(0x100 + i) for i in range(c - 2)) + " ")


def limit_lines(alphabet, kind: str, seed: int = 5) -> list:
    """Seeded LM training lines over the alphabet's letters: words of 1-3
    letters, 5 to a line; a char LM's letter by letter."""
    rng = np.random.RandomState(seed)
    letters = list(alphabet.labels[1:-1])
    words = ["".join(rng.choice(letters, size=rng.randint(1, 4))) for _ in range(60)]
    lines = [" ".join(rng.choice(words, size=5)) for _ in range(80)]
    if kind == "char":
        lines = [" ".join("<sp>" if ch == " " else ch for ch in ln) for ln in lines]
    return lines


def phase_beam_limits(smi: str, device: str = "cuda", b: int = 8, t: int = 48) -> list:
    """K3 past every limit it once had, against its plain version on the
    card: W=300 over 130 classes, W=254 over 126 classes (its pool in the
    global workspace: the placement is printed), a char 12-gram over 70
    classes (also in 3 stateful chunks against one call) and a word
    9-gram, at B=8, T'=48 on seeded logits with ragged lengths: parents
    and chars equal, scores within 1e-5 relative. ``device`` "cpu" and
    smaller ``b``/``t`` only rehearse it."""
    import torch

    from tpuasr_torch.decode.beam import pack_lm_tables, pack_word_lm_tables
    from tpuasr_torch.decode.lm import train_ngram
    from tpuasr_torch.ops.beam import (_k3_plan, _lm_mode, beam_scan, beam_scan_reference,
                                       flat_tables, make_beam_state)

    dev = torch.device(device)
    cases = {"W300-C130": (300, 130, None, 0), "W254-C126": (254, 126, None, 0),
             "char12-C70": (10, 70, "char", 12), "word9": (10, 42, "word", 9)}
    rows = []
    for name, (w, c, kind, order) in cases.items():
        alphabet = limit_alphabet(c)
        kw = dict(beam_width=w, blank_id=0, cutoff_top_n=BEAM_TOP_N)
        if kind is not None:
            lm = train_ngram(limit_lines(alphabet, kind), order=order)
            pack = pack_lm_tables if kind == "char" else pack_word_lm_tables
            kw.update({f"{kind}_tables": flat_tables(pack(lm, alphabet), dev), "alpha": 0.8,
                       "beta": 1.0, "space_id": alphabet.space_id})
        rng = np.random.RandomState(c + w)
        logits = (rng.randn(b, t, c) * 2.5).astype(np.float32)
        lens_np = rng.randint(1, t + 1, size=b).astype(np.int32)
        lens_np[0], lens_np[min(2, b - 1)] = t, 0
        lp = torch.log_softmax(torch.from_numpy(logits), -1).to(dev).contiguous()
        lens = torch.from_numpy(lens_np).to(dev)
        got = beam_scan(lp, lens, return_state=True, **kw)
        torch.cuda.synchronize()
        want = beam_scan_reference(lp, lens, return_state=True, **kw)
        lm_mode, ring = _lm_mode(kw.get("char_tables"), kw.get("word_tables"), kw.get("space_id"))
        err = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1.0)).max().item()
        row = {"case": name, "shape": [b, t, c], "beam_width": w, "lm": kind, "order": order,
               "dtype": str(got[0].dtype).replace("torch.", ""),
               "place": (_k3_plan(w, c, ring if lm_mode == "word" else 0,
                                  ring if lm_mode == "char" else 0, order, lm_mode, 0, dev)[0]
                         if dev.type == "cuda" else None),
               "parents_equal": bool(torch.equal(got[0], want[0])),
               "chars_equal": bool(torch.equal(got[1], want[1])),
               "state_equal": all(torch.equal(x, y) for x, y in zip(got[3], want[3])),
               "score_rel_err": err, "score_abs_err": (got[2] - want[2]).abs().max().item()}
        if kind == "char":  # 3 stateful chunks against one call
            state = make_beam_state(b, w, lm_mode="char", ring_len=ring, device=dev)
            step = -(-t // 3)
            ps = []
            for t0 in range(0, t, step):
                n = torch.clamp(lens - t0, 0, step).to(torch.int32)
                p, _, scores, state = beam_scan(lp[:, t0:t0 + step].contiguous(), n, state=state,
                                                return_state=True, **kw)
                ps.append(p)
            torch.cuda.synchronize()
            row["stateful_chunks_equal"] = (
                torch.equal(torch.cat(ps, 1), got[0]) and torch.equal(scores, got[2])
                and all(torch.equal(x, y) for x, y in zip(state, got[3])))
            check(row["stateful_chunks_equal"], f"K3 chunks != one call: {row}")
        row["ms"] = time_ms(lambda: beam_scan(lp, lens, **kw), iters=3, warmup=1)
        row["nvidia_smi"] = smi
        emit("beam_limits", **row)
        check(row["parents_equal"] and row["chars_equal"] and row["state_equal"] and err <= 1e-5,
              f"K3 past its old limits vs plain: {row}")
        rows.append(row)
    return rows


def parse_summary(lines: list) -> dict:
    import re

    out = {}
    for ln in lines:
        m = re.match(r"Test Summary \tAverage WER ([\d.]+)\tAverage CER ([\d.]+)$", ln)
        if m:
            out.update(wer=float(m.group(1)), cer=float(m.group(2)))
        m = re.match(r"Timing \t(\d+) utts in ([\d.]+)s = ([\d.]+) utt/s$", ln)
        if m:
            out.update(utts=int(m.group(1)), seconds=float(m.group(2)),
                       utt_per_s=float(m.group(3)))
    return out


def run_cli(main, argv) -> tuple:
    """(return code, stdout lines) of a CLI main."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv)
    return rc, log.getvalue().splitlines()


def phase_decode(out, paths, smi: str, device: str = "cuda"):
    """The slice's main path: tpuasr_torch.cli.test --decoder beam-device
    on the trained flagship checkpoint and the validation manifest (32
    utterances of 5 s, one batch of 32), with a word-LM ARPA and a
    char-LM ARPA built by tpuasr_torch.cli.train_lm from the training
    transcripts, and with no LM; then cli.transcribe --n-best 3 on a 5 s
    and a 20 s WAV (long-form: the host beam). ``device`` "cpu" only
    rehearses it."""
    import tpuasr_torch.ops.beam as beam_mod
    from tpuasr_torch.cli import test as test_cli
    from tpuasr_torch.cli import train_lm, transcribe

    work = ROOT / "build" / "chip_smoke"
    lm_word, lm_char = str(work / "lm_word.arpa"), str(work / "lm_char.arpa")
    for extra in ([], ["--char-level"]):
        rc, lines = run_cli(train_lm.main, ["--manifest", paths["train"], "--order", "3",
                                            "--out", lm_char if extra else lm_word, *extra])
        check(rc == 0, f"cli.train_lm {extra}: {lines}")
    ckpt = str(out / "best.ckpt")
    runs = {"word": ["--lm-path", lm_word], "char": ["--lm-path", lm_char,
                                                     "--device-lm-level", "char"], "none": []}
    results = {}
    for name, extra in runs.items():
        argv = ["--model-path", ckpt, "--test-manifest", paths["val"], "--decoder", "beam-device",
                "--beam-width", str(BEAM_W), "--batch-size", "32", "--timing",
                "--timing-repeats", "2", "--save-output", str(work / f"hyps_{name}.jsonl"),
                "--device", device, *extra]
        beam_mod.beam_scan.launches = 0  # ---- the main path starts here
        rc, lines = run_cli(test_cli.main, argv)
        launches = beam_mod.beam_scan.launches  # ---- and ends here
        res = {"lm": name, **parse_summary(lines), "launches": launches}
        emit("decode", **res, nvidia_smi=smi)
        check(rc == 0 and "wer" in res and "utt_per_s" in res, f"cli.test {name}: {lines}")
        n_val = len(Path(paths["val"]).read_text().splitlines())
        check(res["utts"] == n_val, f"cli.test {name} scored {res['utts']} of {n_val}")
        if device == "cuda":
            check(launches > 0, f"K3 never launched in cli.test ({name})")
        results[name] = res
        if name == "word":  # the same run with K3's plain version: the same output
            argv_plain = argv[:argv.index("--save-output") + 1] + [
                str(work / "hyps_word_plain.jsonl")] + argv[argv.index("--save-output") + 2:]
            with mock.patch.object(beam_mod, "beam_scan", beam_mod.beam_scan_reference):
                rc, plain_lines = run_cli(test_cli.main, argv_plain)
            same = (parse_summary(plain_lines).get("wer") == res["wer"]
                    and parse_summary(plain_lines).get("cer") == res["cer"]
                    and (work / "hyps_word.jsonl").read_text()
                    == (work / "hyps_word_plain.jsonl").read_text())
            emit("decode_parity", lm=name, plain_summary_and_hyps_equal=same)
            check(rc == 0 and same, "cli.test with K3 != with its plain version")

    wav5 = Path(paths["val"]).read_text().splitlines()[0].split(",")[0]
    wav20 = work / "long20.wav"
    wav20.write_bytes(wav_bytes(20.0, seed=7))
    for wav, seconds in ((wav5, 5.0), (str(wav20), 20.0)):
        beam_mod.beam_scan.launches = 0  # ---- the main path starts here
        t0 = time.perf_counter()
        rc, lines = run_cli(transcribe.main, [
            "--model-path", ckpt, "--audio-path", wav, "--decoder", "beam-device",
            "--lm-path", lm_word, "--beam-width", str(BEAM_W), "--n-best", "3",
            "--device", device])
        launches = beam_mod.beam_scan.launches  # ---- and ends here
        emit("transcribe", seconds=seconds, wall_s=time.perf_counter() - t0,
             launches=launches, lines=lines[:3])
        check(rc == 0 and lines, f"cli.transcribe {seconds}s: {lines}")
        if seconds <= 16.5:  # n-best rows "score<TAB>text"; K3 decoded them
            check(1 <= len(lines) <= 3 and all("\t" in ln for ln in lines), f"n-best {lines}")
            if device == "cuda":
                check(launches == 1, f"K3 launches on a 5 s transcription: {launches}")
        else:  # long-form: the best text from the host beam, as in tpuasr
            check(len(lines) == 1 and launches == 0, f"long-form {lines} {launches}")
        results[f"transcribe_{int(seconds)}s"] = launches

    # the service with the device beam: its warm-up launches K3 once per
    # warmed bucket, then one request is one more launch
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.lm import load_lm
    from tpuasr_torch.serve import ServeConfig, TranscriptionService
    from tpuasr_torch.train.checkpoint import load_checkpoint

    pkg = load_checkpoint(ckpt)
    dec = DeviceBeamDecoder(pkg.alphabet, beam_width=BEAM_W, word_lm=load_lm(lm_word),
                            alpha=0.8, beta=1.0, cutoff_top_n=BEAM_TOP_N)
    beam_mod.beam_scan.launches = 0  # ---- the main path starts here
    svc = TranscriptionService(ckpt, ServeConfig(warmup_seconds=(5.0, 16.5)), decoder=dec,
                               package=pkg, device=device)
    try:
        warm = beam_mod.beam_scan.launches
        text, offsets = svc.transcribe_wav_bytes(Path(wav5).read_bytes())
    finally:
        svc.close()
    launches = beam_mod.beam_scan.launches  # ---- and ends here
    emit("serve_beam", warmup_launches=warm, launches=launches, text=text[:60])
    check(isinstance(text, str) and len(offsets) == len(text), "service beam answer")
    if device == "cuda":
        check(warm == 2 and launches == 3, f"K3 launches in the service: {warm}, {launches}")
    results["serve"] = launches
    return results, lm_word


def decode_breakdown(out, paths, lm_path: str, smi: str, device: str = "cuda") -> dict:
    """Where one 32-row beam-decode batch's time goes: CUDA events around
    the eval step, the log-softmax and K3; host clock around the
    device-to-host copy of the backpointers (after a synchronize) and the
    host backtrack plus readout. Means over 3 batches after a warm one.
    The decoder is the main path's: W=10 with the word-LM ARPA."""
    import torch

    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.decode.beam import DeviceBeamDecoder, _backtrack
    from tpuasr_torch.decode.lm import load_lm
    from tpuasr_torch.train.checkpoint import load_checkpoint
    from tpuasr_torch.train.step import make_eval_step

    pkg = load_checkpoint(str(out / "best.ckpt"))
    model = model_from_variables(pkg.variables, pkg.model_config, torch.device(device))
    eval_step = make_eval_step(model, pkg.frontend_config)
    dec = DeviceBeamDecoder(pkg.alphabet, beam_width=BEAM_W, word_lm=load_lm(lm_path),
                            alpha=0.8, beta=1.0, cutoff_top_n=BEAM_TOP_N)
    plan = make_buckets(order_and_prune(read_manifest(paths["val"])), 32, BucketSpec(),
                        shuffle=False)
    batch = next(iter(AudioBatchLoader(plan, pkg.alphabet, transfer_dtype="int16").epoch(0)))

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    totals: dict = {}
    reps = 3
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        e0 = event()
        logits, out_len = eval_step(batch.waves, batch.wave_lengths)
        e1 = event()
        lp, lens = dec.logprobs(logits, out_len)
        e2 = event()
        found = dec.search(lp, lens)
        e3 = event()
        torch.cuda.synchronize()
        h1 = time.perf_counter()
        host = dec.to_host(*found, lp.shape[2])
        h2 = time.perf_counter()
        store, toff, blen, _ = _backtrack(*host)
        texts = [dec.readout(store[j, 0], toff[j, 0], blen[j, 0])[0] for j in range(len(blen))]
        h3 = time.perf_counter()
        if rep == 0:
            continue  # warm
        for k, v in (("eval_step_ms", e0.elapsed_time(e1)), ("log_softmax_ms", e1.elapsed_time(e2)),
                     ("k3_ms", e2.elapsed_time(e3)), ("device_ms", e0.elapsed_time(e3)),
                     ("host_to_sync_ms", 1e3 * (h1 - h0)), ("d2h_copy_ms", 1e3 * (h2 - h1)),
                     ("backtrack_readout_ms", 1e3 * (h3 - h2)), ("batch_ms", 1e3 * (h3 - h0))):
            totals[k] = totals.get(k, 0.0) + v / reps
    row = {"batch": list(lp.shape), "lm": "word", **totals, "texts": len(texts),
           "utt_per_s": 32 / (totals["batch_ms"] / 1e3), "nvidia_smi": smi}
    emit("decode_breakdown", **row)
    return row


def time_beam_path(work: Path, label: str, smi: str) -> None:
    """The device-beam path's times, for a same-call comparison of two
    checkouts: K3 on the trained flagship's logits (W=10 with no LM, the
    corpus' char and word trigrams, the 50k-word trigram and a char
    7-gram; W=100 with the first three; T'=251 and 826; CUDA-event means
    of 10 calls, 3 at W=100), three 32-row decode batches
    (``decode_breakdown``) and five ``cli.test --decoder beam-device``
    runs a LM mode, all from a work directory a full run left
    (``build/chip_smoke``: corpus, train/best.ckpt, lm_word.arpa,
    lm_char.arpa). One JSON line each, tagged ``label``. Run as
    ``python3 chip_smoke.py --time-beam WORK LABEL [ROOT]``, ROOT being
    the checkout whose tpuasr_torch is timed (this one by default), in
    turns: parent, change, change, parent."""
    import torch

    from tpuasr_torch.cli import test as test_cli
    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.ops.beam import beam_scan

    paths = {k: str(work / "corpus" / f"{k}.csv") for k in ("train", "val", "all")}
    out = work / "train"
    alphabet = Alphabet()
    texts = corpus_texts(paths)
    decs = {**beam_decoders(alphabet, texts), **wide_beam_decoders(alphabet, texts)}
    inputs = {t: flagship_logits(out, paths, s) for t, s in ((251, 5.0), (826, 16.5))}
    for mode, dec in decs.items():
        for t, (logits, lengths) in inputs.items():
            lp, lens = dec.logprobs(torch.from_numpy(logits).cuda(), lengths)
            w = dec.cfg.beam_width
            kw = dict(beam_width=w, blank_id=alphabet.blank_id, cutoff_top_n=BEAM_TOP_N,
                      **dec.kernel_lm_kwargs(lp.shape[2], "cuda"))
            ms = time_ms(lambda: beam_scan(lp, lens, **kw), iters=10 if w <= BEAM_W else 3,
                         warmup=2)
            emit("time_beam", label=label, mode=mode, T=t, W=w, ms=ms, nvidia_smi=smi)
    for rep in range(3):
        with contextlib.redirect_stdout(io.StringIO()):
            row = decode_breakdown(out, paths, str(work / "lm_word.arpa"), smi)
        emit("time_beam", label=label, rep=rep, decode_breakdown={
            k: row[k] for k in ("k3_ms", "batch_ms", "eval_step_ms", "d2h_copy_ms",
                                "backtrack_readout_ms", "device_ms")})
    runs = {"word": ["--lm-path", str(work / "lm_word.arpa")],
            "char": ["--lm-path", str(work / "lm_char.arpa"), "--device-lm-level", "char"],
            "none": []}
    for name, extra in runs.items():
        ups = []
        for _ in range(5):
            rc, lines = run_cli(test_cli.main, [
                "--model-path", str(out / "best.ckpt"), "--test-manifest", paths["val"],
                "--decoder", "beam-device", "--beam-width", str(BEAM_W), "--batch-size", "32",
                "--timing", "--timing-repeats", "2", "--device", "cuda", *extra])
            check(rc == 0, f"cli.test {name}: {lines}")
            ups.append(parse_summary(lines)["utt_per_s"])
        emit("time_beam", label=label, cli_test=name, utt_per_s=ups, nvidia_smi=smi)


# ------------------------------------------------------------------- serve

def wav_bytes(seconds: float, seed: int, sr: int = 16000) -> bytes:
    """Seeded speech-like audio: a few gliding harmonic tones over noise."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    w = sum(np.sin(k * phase) / k for k in range(1, 6))
    w = 0.2 * w * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t) ** 2)
    w = w + 0.01 * rng.standard_normal(len(t))
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(w, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def post(url: str, body: bytes, out: dict) -> None:
    t0 = time.perf_counter()
    try:
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            out.update(json.loads(r.read()), status=r.status)
    except Exception as exc:  # recorded and checked by the caller
        out.update(error=repr(exc))
    out["latency_s"] = time.perf_counter() - t0


def phase_serve(smi: str, name: str, device: str = "cuda", cfg=None, path: str = "gru",
                ckpt=None, durations=(1.0, 1.6, 2.2, 2.9, 3.4, 4.1, 4.6, 5.0),
                long_request: bool = True, warmup=(5.0, 16.5), full_batch: bool = False):
    """The serving main path of one model path of RNN_PATHS: ``ckpt``
    (a trained checkpoint), else a seeded full-width flagship checkpoint
    of ``cfg``, answering concurrent requests of ``durations`` seconds
    (and one 20 s long-form request). ``device``/``cfg`` other than the
    defaults only rehearse the phase on the CPU at a small width. With
    ``full_batch`` the kernel-vs-plain batch is 32 rows of 5 s, not the
    short requests padded to 32 rows."""
    import torch

    import tpuasr_torch.model.ds2 as ds2
    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.compat.weights import init_variables
    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.serve import ServeConfig, TranscriptionService, make_http_server
    from tpuasr_torch.train.checkpoint import CheckpointPackage, save_checkpoint

    mod, fwd_name, _, _, plain, _ = rnn_path(path)
    kernel = getattr(mod, fwd_name)
    if ckpt is None:
        cfg = cfg or ds2.ModelConfig(rnn_impl="pallas")  # the flagship, full width
        ckpt = ROOT / "build" / "chip_smoke" / "flagship.tpuasr"
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt), CheckpointPackage(
            model_config=cfg, frontend_config=FrontendConfig(),
            labels=Alphabet().labels, variables=init_variables(cfg, seed=0)))
        emit("checkpoint", path=str(ckpt.relative_to(ROOT)),
             mbytes=ckpt.stat().st_size / 1e6, write_s=time.perf_counter() - t0)

    durations = list(durations)
    bodies = [wav_bytes(d, seed=i) for i, d in enumerate(durations)]
    if long_request:
        durations.append(20.0)
        bodies.append(wav_bytes(20.0, seed=99))  # past the 16.5 s ladder
    n_short = len(bodies) - long_request

    kernel.launches = 0  # ---- the main path starts here
    t0 = time.perf_counter()
    # warm-up runs the 5 s and 16.5 s bucket shapes once before traffic
    # (first cuDNN/cuBLAS use), as a production server is started
    svc = TranscriptionService(
        str(ckpt), ServeConfig(max_batch=32, batch_window_ms=50.0,
                               warmup_seconds=tuple(warmup)),
        device=device)
    start_s = time.perf_counter() - t0
    server = make_http_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}/transcribe"
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    try:
        results = [{} for _ in bodies]
        clients = [threading.Thread(target=post, args=(url, body, res))
                   for body, res in zip(bodies, results)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        wall_s = time.perf_counter() - t0
        launches = kernel.launches  # ---- the main path ends here
        check(not any(c.is_alive() for c in clients), "requests timed out")
        for d, res in zip(durations, results):
            check("error" not in res and res.get("status") == 200,
                  f"request of {d}s failed: {res.get('error')}")
            check(isinstance(res["text"], str) and isinstance(res["offsets"], list),
                  f"malformed answer for {d}s: {res}")
        if device == "cuda":
            check(launches > 0, f"{fwd_name} never launched on the {path} serving path")
        lat = sorted(r["latency_s"] for r in results)
        emit("serve", path=path, device=name, nvidia_smi=smi,
             start_s=start_s, requests=len(results), wall_s=wall_s,
             audio_s=sum(durations), x_realtime=sum(durations) / wall_s,
             latency_s=[r["latency_s"] for r in results],
             latency_p50_s=lat[len(lat) // 2], latency_max_s=lat[-1],
             text_chars=[len(r["text"]) for r in results],
             rnn_kernel=fwd_name, rnn_launches=launches)

        # one service-shaped batch (the short requests, padded to the
        # 5 s bucket and 32 rows), kernel vs plain loop on the card
        arr, lens = service_batch(svc, [wav_bytes(5.0, seed=100 + j) for j in range(32)]
                                  if full_batch else bodies[:n_short])
        logits_k, out_len = svc.eval_step(arr, lens)
        with mock.patch.object(ds2, fwd_name, plain):
            logits_p, _ = svc.eval_step(arr, lens)
        check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
        n_classes = svc.model.config.n_classes
        check(tuple(logits_k.shape) == (32, int(out_len.max()), n_classes),
              f"logits shape {tuple(logits_k.shape)}")
        valid = (torch.arange(logits_k.shape[1], device=out_len.device)[None, :]
                 < out_len[:, None])
        diff = (logits_k - logits_p).abs()[valid]
        agree = (logits_k.argmax(-1) == logits_p.argmax(-1))[valid].float().mean().item()
        stats = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
                 "argmax_agreement": agree,
                 "logits_abs_max": logits_p.abs().max().item()}
        emit("serve_parity", path=path, **stats)
        check(stats["mean_abs_err"] <= 1e-2 and stats["max_abs_err"] <= 0.25
              and agree >= 0.98, f"service logits vs plain {path} loop: {stats}")

        lone = {}
        post(url, bodies[3], lone)  # one request with nothing else queued
        check("error" not in lone, f"lone request failed: {lone.get('error')}")
        emit("serve_lone_request", path=path, seconds=durations[3],
             latency_s=lone["latency_s"], nvidia_smi=smi)
        if device == "cuda":
            emit("batch_breakdown", path=path, nvidia_smi=smi,
                 **batch_breakdown(svc, arr, lens, fwd_name))
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        serve_thread.join(timeout=10)
    return launches


def service_batch(svc, bodies) -> tuple:
    """WAV bodies as one service batch: int16 rows padded to the 5 s
    bucket and 32 rows, and their lengths."""
    from scipy.io import wavfile

    arr = np.zeros((32, svc.spec.bucket_samples(svc.spec.bucket_of(5.0))), np.int16)
    lens = np.zeros((32,), np.int32)
    for j, body in enumerate(bodies):
        w = wavfile.read(io.BytesIO(body))[1]
        arr[j, :len(w)], lens[j] = w, len(w)
    return arr, lens


def batch_breakdown(svc, arr, lens, fwd_name: str = "bigru_forward") -> dict:
    """Where one service batch's time goes: CUDA events around the
    model's conv blocks, RNN layers (the calls of their kernel, ds2's
    ``fwd_name``, inside them separately), the head, and the whole eval
    step; host clock around the eval step (ending in a synchronize) and
    the greedy decode; then the forward kernel's step split over one more
    batch."""
    import torch

    import tpuasr_torch.model.ds2 as ds2

    kernel = getattr(ds2, fwd_name)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    spans = []  # (name, start event, end event)
    model = svc.model
    blocks = ([("conv", m) for m in model.convs] + [("rnn", m) for m in model.rnns]
              + [("head_bn", model.head_bn)])
    starts = {}
    hooks = []
    for name, mod in blocks:
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a: starts.__setitem__(id(m), event())))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, name=name: spans.append((name, starts[id(m)], event()))))

    def timed_kernel(*args):
        s = event()
        ys = kernel(*args)
        spans.append(("rnn_kernel", s, event()))
        return ys

    try:
        with mock.patch.object(ds2, fwd_name, timed_kernel):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = event()
            logits, out_len = svc.eval_step(arr, lens)
            end = event()
            torch.cuda.synchronize()
            eval_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
    t0 = time.perf_counter()
    svc.decoder.decode(logits, out_len, return_offsets=True)
    decode_host_ms = (time.perf_counter() - t0) * 1e3
    split = fwd_split(lambda: svc.eval_step(arr, lens))
    ms: dict = {}
    for name, s, e in spans:
        ms[name] = ms.get(name, 0.0) + s.elapsed_time(e)
    first_conv = min((s for n, s, _ in spans if n == "conv"),
                     key=lambda s: start.elapsed_time(s))
    return {
        "batch": list(arr.shape), "eval_host_ms": eval_host_ms,
        "eval_device_ms": start.elapsed_time(end),
        "frontend_ms": start.elapsed_time(first_conv),
        "conv_ms": ms["conv"], "rnn_ms": ms["rnn"],
        "rnn_kernel": fwd_name, "rnn_kernel_ms": ms["rnn_kernel"],
        "rnn_outside_kernel_ms": ms["rnn"] - ms["rnn_kernel"],
        "head_bn_ms": ms["head_bn"], "decode_host_ms": decode_host_ms,
        "rnn_kernel_split": split_us(split, ms["rnn_kernel"]),
    }


# ------------------------------------------------------- augment_resident

AUGMENT_ATOL = 1e-5  # an apply on the card vs the CPU: the same f32 operations


def augment_apply_checks(waves_np, lengths_np, noise_dir: str, device: str = "cuda") -> dict:
    """Each augmentation apply on the card against the same function on
    the CPU with the same parameters, drawn on the card from one CUDA
    generator: max-abs error of the output (atol AUGMENT_ATOL) and equal
    lengths. On the CPU (rehearsal) both sides are the CPU."""
    import torch

    from tpuasr_torch.audio import augment as aug
    from tpuasr_torch.audio.frontend import FrontendConfig, log_spectrogram

    dev, cpu = torch.device(device), torch.device("cpu")
    cfg = aug.AugmentConfig(noise_prob=0.5, spec_augment=True, n_freq_masks=2, n_time_masks=2)
    waves = torch.from_numpy(waves_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev).long()
    bank = torch.from_numpy(aug.load_noise_bank(noise_dir, 16000)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    b = waves.shape[0]
    rates, gains = aug.draw_tempo_gain(gen, b, cfg)
    offsets, levels, on = aug.draw_noise(gen, b, bank.shape[0], cfg)
    with torch.no_grad():
        feats, feat_lengths = log_spectrogram(waves, lengths, FrontendConfig())
    freq, tmask = aug.draw_spec_augment(gen, feat_lengths, feats.shape[1], feats.shape[2], cfg)

    def on_dev(d, *ts):
        return [t.to(d) for t in ts]

    resample = aug.AugmentConfig(tempo_mode="resample")
    cases = {
        "speed_and_gain": lambda d: aug.speed_and_gain(*on_dev(d, rates, gains, waves, lengths)),
        "wsola_tempo": lambda d: aug.wsola_tempo(*on_dev(d, rates, waves, lengths)),
        "tempo_and_gain_wsola": lambda d: aug.tempo_and_gain(
            *on_dev(d, rates, gains, waves, lengths), cfg),
        "tempo_and_gain_resample": lambda d: aug.tempo_and_gain(
            *on_dev(d, rates, gains, waves, lengths), resample),
        "inject_noise": lambda d: (aug.inject_noise(
            *on_dev(d, offsets, levels, on, waves, lengths, bank)),),
        "spec_augment": lambda d: (aug.spec_augment(
            [on_dev(d, *m) for m in freq], [on_dev(d, *m) for m in tmask],
            feats.to(d)),),
    }
    errs = {}
    for name, fn in cases.items():
        got, want = fn(dev), fn(cpu)
        errs[name] = (got[0].cpu() - want[0]).abs().max().item()
        check(errs[name] <= AUGMENT_ATOL, f"{name} on the card vs the CPU: {errs[name]}")
        if len(got) > 1:
            check(torch.equal(got[1].cpu(), want[1]), f"{name}: lengths differ")
    return {"batch": list(waves.shape), "max_abs_err": errs, "noise_rows_on": int(on.sum()),
            "rates": [float(rates.min()), float(rates.max())]}


# device events of a trace by what they run (the first group whose name
# fragment the event's name holds; the last takes the rest)
TRACE_GROUPS = (("rnn_backward_loop", ("rnn_bwd_loop",)), ("rnn_forward_loop", ("rnn_fwd_loop",)),
                ("hg_gemm", ("hg_gemm",)), ("ctc", ("ctc_alpha", "ctc_beta")),
                ("cudnn_conv", ("cudnn", "implicit_gemm")),
                ("cublas_gemm", ("nvjet", "gemm", "cutlass")),
                ("copy_set", ("Memcpy", "Memset")), ("elementwise_reduce_other", ()))


def trace_summary(path) -> dict:
    """The device's idle share and kernel time by name over a
    torch.profiler Chrome trace. ``idle_share`` is 1 - (the union of the
    device's kernel, copy and set intervals) / (first device event start
    to last device event end): the span in which the card ran the traced
    steps. The host queues steps ahead of the card, so the trace's own
    window (first event to last) opens while the card still runs work
    queued before the trace, which it does not record:
    ``idle_share_of_window`` counts that as idle and is an upper bound.
    ``gaps`` are the longest idle stretches with the device events on
    either side."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    if not dev:
        return {"window_ms": (t1 - t0) / 1e3, "device_events": 0, "kernels": []}
    busy, end, gaps = 0.0, dev[0][0], []
    prev = dev[0][2]
    for s, e, n in dev:
        if s > end:
            gaps.append(((s - end) / 1e3, prev[:60], n[:60]))
        busy += max(0.0, e - max(s, end))
        if e > end:
            end, prev = e, n
    span = end - dev[0][0]
    by_name: dict = {}
    by_group = {g: 0.0 for g, _ in TRACE_GROUPS}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e3
        group = next(g for g, keys in TRACE_GROUPS if not keys or any(k in n for k in keys))
        by_group[group] += (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"window_ms": (t1 - t0) / 1e3, "device_span_ms": span / 1e3,
            "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / max(span, 1e-9),
            "idle_share_of_window": 1.0 - busy / max(t1 - t0, 1e-9),
            "device_events": len(dev), "device_events_under_5us": sum(
                e - s < 5.0 for s, e, _ in dev),
            "cpu_ops": sum(e.get("cat") == "cpu_op" for e in events),
            "share_of_device_span": {g: ms * 1e3 / max(span, 1e-9) for g, ms in by_group.items()},
            "gaps_over_50us": sum(g[0] > 0.05 for g in gaps),
            "gaps_ms_total": sum(g[0] for g in gaps), "gaps": sorted(gaps, reverse=True)[:6],
            "kernels": sorted(by_name), "top_ms": [[n[:80], ms] for n, ms in top]}


def one_step_resident_vs_batch(out, paths, device: str = "cuda") -> dict:
    """One train step on phase 4's first batch through
    make_resident_epoch_runner and through the per-batch step, both
    without augmentation, from the same weights (the epoch-1
    checkpoint): train_step_parity's tolerances on the loss and each
    parameter's update."""
    import torch

    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.data.resident import ResidentBatchLoader
    from tpuasr_torch.train.checkpoint import load_checkpoint
    from tpuasr_torch.train.loop import read_back
    from tpuasr_torch.train.step import TrainConfig, make_resident_epoch_runner, make_train_step

    pkg = load_checkpoint(str(out / "tpuasr_1.ckpt"))
    entries = order_and_prune(read_manifest(paths["train"]))
    models, losses = [], []
    for resident in (False, True):
        plan = make_buckets(entries, 32, BucketSpec())
        plan.homogeneous = True
        model = model_from_variables(pkg.variables, pkg.model_config, torch.device(device),
                                     trainable=True)
        step = make_train_step(model, pkg.frontend_config, TrainConfig())
        if resident:
            loader = ResidentBatchLoader(plan, pkg.alphabet, device=device)
            _, bank, idx, _, valid = next(iter(loader.bucket_chunks(0)))
            m = read_back(make_resident_epoch_runner(step)(bank, idx[:1], valid[:1], 3e-4, 0))
            losses.append(float(m["loss"][0]))
        else:
            batch = next(iter(AudioBatchLoader(plan, pkg.alphabet,
                                               transfer_dtype="int16").epoch(0)))
            m = read_back(step(batch.waves, batch.wave_lengths, batch.labels,
                               batch.label_lengths, batch.valid, 3e-4))
            losses.append(float(m["loss"]))
        models.append(dict(model.named_parameters()))
    start = model_from_variables(pkg.variables, pkg.model_config, torch.device(device))
    errs = {k: rel_norm_err(models[1][k].detach() - p0, models[0][k].detach() - p0)
            for k, p0 in start.named_parameters()}
    worst = max(errs, key=errs.get)
    row = {"loss_batch": losses[0], "loss_resident": losses[1],
           "loss_rel_err": abs(losses[1] - losses[0]) / abs(losses[0]),
           "update_rel_norm_err_max": errs[worst], "worst_param": worst}
    emit("resident_step_parity", **row)
    check(row["loss_rel_err"] <= 1e-2 and errs[worst] <= 5e-2,
          f"one step, resident vs per-batch: {row}")
    return row


def augment_step_ms(out, waves_np, lengths_np, noise_dir: str, smi: str) -> dict:
    """The augmentation's device time in a train step (B=32 x 5 s):
    CUDA events around ``AugmentFn.waves`` plus ``.feats`` on one batch,
    and around the whole train step with and without it (means of 5
    after a warm one, in turns)."""
    import torch

    from tpuasr_torch.audio.augment import AugmentConfig, make_augment_fn
    from tpuasr_torch.audio.frontend import log_spectrogram
    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.train.checkpoint import load_checkpoint
    from tpuasr_torch.train.step import TrainConfig, make_train_step, step_generator

    pkg = load_checkpoint(str(out / "tpuasr_1.ckpt"))
    fn = make_augment_fn(AugmentConfig(noise_dir=noise_dir, spec_augment=True))
    dev = torch.device("cuda")
    waves = torch.from_numpy(waves_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev).long()
    gen = step_generator(dev, 0, 0)

    def augment_only():
        w, lens = fn.waves(gen, waves, lengths)
        feats, fl = log_spectrogram(w, lens, pkg.frontend_config)
        return fn.feats(gen, feats, fl)

    def frontend_only():
        return log_spectrogram(waves, lengths, pkg.frontend_config)

    model = model_from_variables(pkg.variables, pkg.model_config, dev, trainable=True)
    steps = {k: make_train_step(model, pkg.frontend_config, TrainConfig(), a)
             for k, a in (("plain", None), ("augment", fn))}
    n = waves.shape[0]
    args = (waves, lengths, torch.zeros((n, 10), dtype=torch.int32, device=dev) + 5,
            torch.full((n,), 10, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), 3e-4)
    row = {"augment_and_frontend_ms": time_ms(augment_only, iters=10),
           "frontend_ms": time_ms(frontend_only, iters=10)}
    row["augment_ms"] = row["augment_and_frontend_ms"] - row["frontend_ms"]
    step_ms = {"plain": [], "augment": []}
    for k in ("plain", "augment", "augment", "plain"):
        step_ms[k].append(time_ms(lambda: steps[k](*args, gen), iters=5))
    row.update(step_ms_plain=float(np.mean(step_ms["plain"])),
               step_ms_augment=float(np.mean(step_ms["augment"])), batch=list(waves.shape),
               nvidia_smi=smi)
    row["augment_share_of_step"] = row["augment_ms"] / row["step_ms_augment"]
    emit("augment_step_ms", **row)
    return row


def warm_chunk_without_sync(loader, ckpt, noise_dir: str, smi: str,
                            device: str = "cuda") -> dict:
    """One warm resident chunk (augmentation on, the schedule's longest)
    run again under torch.cuda.set_sync_debug_mode("error"): any call
    that waits for the card inside the chunk raises; the read-back comes
    after. Then the same chunk timed on the host clock (to its
    read-back) without and with a StepProfiler trace over all its steps,
    in turns: the tracer's cost a step, and the device's idle share over
    a warm chunk (trace_summary)."""
    import torch

    from tpuasr_torch.audio.augment import AugmentConfig, make_augment_fn
    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.train.checkpoint import load_checkpoint
    from tpuasr_torch.train.loop import read_back
    from tpuasr_torch.train.step import TrainConfig, make_resident_epoch_runner, make_train_step

    pkg = load_checkpoint(str(ckpt))
    model = model_from_variables(pkg.variables, pkg.model_config, torch.device(device),
                                 trainable=True)
    fn = make_augment_fn(AugmentConfig(noise_dir=noise_dir, spec_augment=True))
    runner = make_resident_epoch_runner(make_train_step(model, pkg.frontend_config,
                                                        TrainConfig(), fn))
    b, bank, idx, _, valid = max(loader.bucket_chunks(1), key=lambda c: len(c[2]))
    read_back(runner(bank, idx, valid, 3e-4, 0))  # warm
    checked = device == "cuda"
    if checked:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = runner(bank, idx, valid, 3e-4, len(idx))
    except RuntimeError as exc:
        emit("sync_check", ok=False, error=str(exc)[:2000])
        raise
    finally:
        if checked:
            torch.cuda.set_sync_debug_mode(0)
    vals = read_back(metrics)
    row = {"bucket": b, "steps": len(idx), "sync_debug_mode": "error" if checked else None,
           "losses_finite": bool(np.isfinite(vals["loss"]).all())}
    emit("sync_check", ok=True, **row)
    check(row["losses_finite"], f"a warm chunk's losses: {vals['loss']}")

    from tpuasr_torch.profiling import StepProfiler

    trace_dir = ROOT / "build" / "chip_smoke" / "trace_chunk"
    k = len(idx)
    ms: dict = {"plain": [], "traced": []}
    for rep, mode in enumerate(("plain", "traced", "traced", "plain")):
        k0 = (rep + 2) * k
        # the window's end lies past the chunk: the trace is written after the clock stops
        prof = StepProfiler(str(trace_dir), start=k0, stop=k0 + k + 1) if mode == "traced" else None
        if checked:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        read_back(runner(bank, idx, valid, 3e-4, k0, prof))
        ms[mode].append((time.perf_counter() - t0) * 1e3 / k)
        if prof is not None:
            prof.close()
            last = trace_dir / f"steps_{k0}-{k0 + k + 1}.pt.trace.json"
    chunk = {"bucket": b, "steps": k, "step_ms_plain": ms["plain"],
             "step_ms_traced": ms["traced"],
             "tracer_ms_a_step": float(np.mean(ms["traced"]) - np.mean(ms["plain"])),
             **trace_summary(last), "nvidia_smi": smi}
    emit("profile_chunk", **chunk)
    return {**row, "chunk": chunk}


def phase_augment_resident(smi: str, name: str, out, paths, device: str = "cuda",
                           width=("800", "5"), n_corpus: int = 1024, span=(2.0, 10.0),
                           batch: int = 32, epochs: int = 2):
    """Slice 9's paths at the flagship's width: the augmentation applies
    on the card vs the CPU (32 x 5 s from phase 4's corpus), one step
    resident vs per-batch, then tpuasr_torch.cli.train with
    --device-resident-audio --augment --noise-dir --spec-augment
    --profile-dir on a corpus of ``n_corpus`` utterances of ``span``
    seconds (several buckets), a warm chunk under sync-debug "error",
    the same training through AudioBatchLoader (sustained utt/s of the
    warm epoch, resident vs loader), cli.test --device-resident-audio
    (greedy and beam-device with a word LM) against the per-batch run on
    ``batch`` utterances of each of two buckets, and cli.noise_inject.
    ``device``, ``width`` and the sizes other than the defaults only
    rehearse it on the CPU."""
    import shutil

    import tpuasr_torch.ops.beam as beam_mod
    from tpuasr_torch.cli import noise_inject, synth_corpus, train_lm
    from tpuasr_torch.cli import test as test_cli
    from tpuasr_torch.cli import train as train_cli
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.labels import Alphabet

    work = ROOT / "build" / "chip_smoke"
    noise = synth_corpus.generate(str(work / "noise_src"), 1, 1.0, 0.0, seed=1,
                                  make_noise=True)["noise"]
    plan = make_buckets(order_and_prune(read_manifest(paths["train"])), batch, BucketSpec())
    first = next(iter(AudioBatchLoader(plan, Alphabet(), transfer_dtype="float32").epoch(0)))
    waves_np, lengths_np = first.waves, first.wave_lengths
    emit("augment_apply", **augment_apply_checks(waves_np, lengths_np, noise, device),
         nvidia_smi=smi)
    one_step_resident_vs_batch(out, paths, device)
    if device == "cuda":
        augment_step_ms(out, waves_np, lengths_np, noise, smi)

    corpus = work / "corpus_aug"
    shutil.rmtree(corpus, ignore_errors=True)
    t0 = time.perf_counter()
    cp = synth_corpus.generate(str(corpus), n_corpus, None, 0.0, seed=11, make_noise=True,
                               span=span)
    corpus_s = time.perf_counter() - t0
    counters = [*kernel_counters().values(), beam_mod.beam_scan]
    runs, launches, loaders = {}, {}, []
    resident_loader = train_cli.ResidentBatchLoader

    def capture(*a, **kw):  # keeps the CLI's loader for the sync check
        loaders.append(resident_loader(*a, **kw))
        return loaders[-1]

    for mode in ("resident", "loader"):
        r_out = work / f"train_{mode}"
        shutil.rmtree(r_out, ignore_errors=True)
        argv = ["--train-manifest", cp["train"], "--hidden-size", width[0],
                "--hidden-layers", width[1], "--batch-size", str(batch), "--epochs", str(epochs),
                "--model-path", str(r_out / "best.ckpt"), "--log-dir", str(r_out / "log"),
                "--sync-every", "10", "--device", device, "--augment", "--noise-dir", cp["noise"],
                "--spec-augment"]
        if mode == "resident":
            argv += ["--device-resident-audio", "--profile-dir", str(r_out / "trace")]
        for fn in counters:  # ---- the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(train_cli, "ResidentBatchLoader", capture):
            rc, lines = run_cli(train_cli.main, argv)
        wall_s = time.perf_counter() - t0
        launches[mode] = {fn.__name__: fn.launches for fn in counters}  # ---- and ends here
        check(rc == 0, f"cli.train ({mode}): {lines[-5:]}")
        rows = read_jsonl(r_out / "log" / "metrics.jsonl")
        steps = [r for r in rows if "train/loss" in r]
        ep = [r for r in rows if "epoch/epoch_time" in r]
        check(steps and all(np.isfinite(r["train/loss"]) and r["train/n_ok"] > 0 for r in steps),
              f"cli.train ({mode}): a non-finite or empty step")
        warm = [r for r in steps if r["train/epoch"] == epochs - 1]
        runs[mode] = {"wall_s": wall_s, "steps": len(steps), "epoch_s": [r["epoch/epoch_time"]
                                                                          for r in ep],
                      "warm_epoch_utt_per_s": sum(r["train/n_ok"] for r in warm)
                      / ep[-1]["epoch/epoch_time"],
                      "losses_first_last": [steps[0]["train/loss"], steps[-1]["train/loss"]],
                      "launches": launches[mode], "console": lines[-2:]}
        emit("train_augment", mode=mode, corpus_s=corpus_s, n_corpus=n_corpus,
             span_s=list(span), **runs[mode], nvidia_smi=smi)
    if device == "cuda":  # the GRU path's kernels, dW's and CTC's, no other RNN kernel or K3
        used = {"bigru_forward", "bigru_backward", "rnn_weight_grads", "ctc_alpha", "ctc_beta"}
        res = launches["resident"]
        check(all((v > 0) == (k in used) for k, v in res.items()),
              f"resident training launches: {res}")
    trace = work / "train_resident" / "trace" / "steps_10-15.pt.trace.json"
    check(trace.is_file(), "--profile-dir wrote no trace")
    summary = trace_summary(trace)
    if device == "cuda":
        names = " ".join(summary["kernels"])
        for k in ("rnn_fwd_loop", "rnn_bwd_loop", "ctc_alpha_kernel", "ctc_beta_kernel"):
            check(k in names, f"the trace names no {k}: {summary['kernels'][:20]}")
    emit("profile", trace=str(trace.relative_to(ROOT)), **summary, nvidia_smi=smi)
    chunk = warm_chunk_without_sync(loaders[0], work / "train_resident" / "best.ckpt",
                                    cp["noise"], smi, device)["chunk"]

    # evaluation: resident vs per-batch, greedy and the device beam (word
    # LM), on two buckets of ``batch`` utterances each: both runs then
    # decode the same batches (the per-batch plan chunks the sorted
    # manifest across buckets; batches of other shapes round bf16
    # products otherwise, which can flip a near tie in the beam)
    spec = BucketSpec()
    by_bucket: dict = {}
    for e in order_and_prune(read_manifest(cp["all"])):
        by_bucket.setdefault(spec.bucket_of(e.duration), []).append(e)
    picked = [es[:batch] for _, es in sorted(by_bucket.items()) if len(es) >= batch][-2:]
    eval_manifest = work / "eval_aug.csv"
    eval_manifest.write_text("".join(f"{e.wav_path},{e.transcript_path}\n"
                                     for es in picked for e in es))
    all_rows = Path(cp["all"]).read_text().splitlines()
    lm = str(work / "lm_aug.arpa")
    rc, lines = run_cli(train_lm.main, ["--manifest", cp["train"], "--order", "3", "--out", lm])
    check(rc == 0, f"cli.train_lm: {lines}")
    evals = {}
    for dec in ("greedy", "beam-device"):
        outs = {}
        for mode in ("batch", "resident"):
            hyps = work / f"eval_{dec}_{mode}.jsonl"
            argv = ["--model-path", str(work / "train_resident" / "best.ckpt"), "--test-manifest",
                    str(eval_manifest), "--decoder", dec, "--batch-size", str(batch),
                    "--save-output", str(hyps), "--timing", "--timing-repeats", "2",
                    "--device", device]
            if dec == "beam-device":
                argv += ["--lm-path", lm, "--beam-width", str(BEAM_W)]
            if mode == "resident":
                argv.append("--device-resident-audio")
            for fn in counters:  # ---- the main path starts here
                fn.launches = 0
            rc, lines = run_cli(test_cli.main, argv)
            n = {fn.__name__: fn.launches for fn in counters}  # ---- and ends here
            check(rc == 0, f"cli.test {dec} {mode}: {lines}")
            outs[mode] = (parse_summary(lines), hyps.read_text(), n)
        same = (outs["batch"][0]["wer"], outs["batch"][0]["cer"], outs["batch"][1]) == (
            outs["resident"][0]["wer"], outs["resident"][0]["cer"], outs["resident"][1])
        evals[dec] = {"summary": outs["resident"][0], "batch_summary": outs["batch"][0],
                      "same_summary_and_hyps": same, "launches": outs["resident"][2]}
        emit("eval_resident", decoder=dec, **evals[dec], nvidia_smi=smi)
        check(same, f"cli.test {dec}: resident != per-batch")
        if device == "cuda":
            check(outs["resident"][2]["bigru_forward"] > 0, f"{dec}: K1f not launched")
            if dec == "beam-device":
                check(outs["resident"][2]["beam_scan"] > 0, "K3 not launched (resident)")

    wav = all_rows[0].split(",")[0]
    noisy = work / "noisy.wav"
    rc, lines = run_cli(noise_inject.main, ["--input-path", wav, "--noise-path", cp["noise"],
                                            "--output-path", str(noisy), "--device", device])
    from scipy.io import wavfile

    check(rc == 0 and noisy.is_file() and len(wavfile.read(str(noisy))[1])
          == len(wavfile.read(wav)[1]), f"cli.noise_inject: {lines}")
    emit("noise_inject", wav=Path(wav).name, out=str(noisy.relative_to(ROOT)))
    return {"train": launches["resident"], "greedy": evals["greedy"]["launches"],
            "beam": evals["beam-device"]["launches"], "runs": runs, "profile": summary,
            "profile_chunk": chunk}


# ------------------------------------------------------------------ stream

def phase_kernel_d1(smi: str, device: str = "cuda", shapes=TIMING_SHAPES) -> dict:
    """K1f, K1b, K4f and K4b with one direction (a unidirectional model's
    layers), B=32, H=800, bf16, at T'=251 and 826: each against its plain
    loop with the D=2 tolerances (one launch a forward call, the whole
    autograd function too at T'=251), then times beside cuDNN's
    unidirectional nn.GRU / nn.LSTM and the bounds (half the D=2 work),
    and the launch plans at D=1 (blocks, rows one plan holds)."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod
    import tpuasr_torch.ops.lstm as lstm_mod
    from tpuasr_torch.ops.rnn_plan import max_bwd_rows, max_fwd_rows, rnn_fwd_plan

    cuda = torch.device(device)
    kinds = {
        "gru": (3, gru_mod.bigru_forward, gru_mod.bigru_reference, gru_mod.bigru_backward,
                gru_mod.bigru_backward_reference, gru_mod.BiGRUFunction, "bigru_fwd"),
        "lstm": (4, lstm_mod.bilstm_forward, lstm_mod.bilstm_reference,
                 lstm_mod.bilstm_backward, lstm_mod.bilstm_backward_reference,
                 lstm_mod.BiLSTMFunction, "bilstm_fwd"),
    }
    errs, timings, plans = {}, {}, {}
    for kind, (g, fwd, plain, bwd, bwd_plain, fn, lib_name) in kinds.items():
        n_sms, smem = gru_mod._card(lib_name, cuda)
        plans[kind] = {"n_sms": n_sms, "blocks_fwd": rnn_fwd_plan(1, 32, 800, g, 2, n_sms,
                                                                   smem).n_blocks,
                       "max_fwd_rows": max_fwd_rows(1, 800, g, 2, n_sms, smem),
                       "max_bwd_rows": max_bwd_rows(1, 800, g, 2, n_sms, smem)}
        check(plans[kind]["max_bwd_rows"] >= 32, f"{kind} D=1 backward plan: {plans[kind]}")
        names = (fwd.__name__, bwd.__name__)
        timings.update({n: [] for n in names})
        for i, (t, b, h) in enumerate(shapes):
            args = gru_case(t, b, h, 1, torch.bfloat16, seed=70 + i, device=cuda, n_gates=g)
            before = fwd.launches
            out = fwd(*args)
            torch.cuda.synchronize()
            check(fwd.launches == before + 1, f"{names[0]} D=1 T={t}: one launch a call")
            ys, cs = out if g == 4 else (out, None)
            ys_p, cs_p = plain(*args) if g == 4 else (plain(*args), None)
            row = {"ys": check_fwd(f"{names[0]} D=1 T={t}", ys, ys_p, "bfloat16")}
            if g == 4:
                row["cs"] = check_fwd(f"{names[0]} D=1 T={t} cs", cs, cs_p, "bfloat16")
            gen = torch.Generator(device=cuda).manual_seed(i)
            dy = (0.1 * torch.randn(ys.shape, generator=gen, device=cuda)).to(torch.bfloat16)
            h_prev = gru_mod.shift_time(ys_p)
            bwd_args = ((*args, h_prev, gru_mod.shift_time(cs_p), cs_p, dy) if g == 4
                        else (*args, h_prev, dy))
            row["dhg"] = check_bwd(f"{names[1]} D=1 T={t}", bwd(*bwd_args),
                                   bwd_plain(*bwd_args), "bfloat16")
            if i == 0:
                row["function_rel_norm_err"] = function_vs_plain(fn.apply, *args, dy, "bfloat16")
            errs.setdefault(names[0], row["ys"]["max_abs_err"])
            errs.setdefault(names[1], row["dhg"]["max_abs_err"])
            timings[names[0]].append(fwd_timing(fwd, plain, args, args[:3], t, b, h, 1,
                                                n_gates=g))
            timings[names[1]].append(bwd_timing(bwd, bwd_plain, bwd_args, args[:3], t, b, h, 1,
                                                n_gates=g))
            emit("kernel_d1", kind=kind, shape=[t, 1, b, h], dtype="bfloat16", **row,
                 fwd_time=timings[names[0]][-1], bwd_time=timings[names[1]][-1],
                 plan=plans[kind], nvidia_smi=smi)
    return {"max_abs_err": errs, "timings": timings, "plans": plans}


STREAM_CHUNK_FRAMES = 32
STREAM_SECONDS = 20.0


def wave_of(body: bytes) -> np.ndarray:
    from scipy.io import wavfile

    return wavfile.read(io.BytesIO(body))[1].astype(np.float32) / 32768.0


def stream_vs_offline(model, fe, alphabet, smi: str, device: str = "cuda") -> dict:
    """One 20 s stream through StreamingTranscriber on the card against
    the card's offline model on the same wave (normalize off, the
    configuration where streaming is exact), with serve_parity's bf16
    tolerances; the offline forward's K1f launches are counted."""
    import torch

    import tpuasr_torch.ops.gru as gru_mod
    from tpuasr_torch.audio.frontend import log_spectrogram
    from tpuasr_torch.stream import StreamingTranscriber

    wave = wave_of(wav_bytes(STREAM_SECONDS, seed=7))
    gru_mod.bigru_forward.launches = 0  # ---- the offline path starts here
    with torch.inference_mode():
        feats, flen = log_spectrogram(torch.from_numpy(wave[None]).to(device),
                                      torch.tensor([len(wave)]).to(device), fe)
        ref, out_len = model(feats, flen)
    t1 = int(out_len[0])
    offline_launches = gru_mod.bigru_forward.launches  # ---- and ends here
    st = StreamingTranscriber(model, model.config, fe, alphabet,
                              chunk_frames=STREAM_CHUNK_FRAMES, collect_logits=True,
                              device=device)
    block = STREAM_CHUNK_FRAMES * fe.hop
    t0 = time.perf_counter()
    for i in range(0, len(wave), block):
        st.feed(wave[i:i + block])
    st.flush()
    wall_s = time.perf_counter() - t0
    got = torch.from_numpy(st.logits()).to(device)
    ref = ref[0, :t1].float()
    check(tuple(got.shape) == tuple(ref.shape), f"streamed logits {tuple(got.shape)} "
          f"vs offline {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite streamed logits")
    diff = (got - ref).abs()
    stats = {"frames": t1, "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
             "argmax_agreement": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
             "logits_abs_max": ref.abs().max().item(), "offline_k1f_launches": offline_launches,
             "stream_wall_s": wall_s, "stream_ticks": st._k,
             "x_realtime_one_stream": STREAM_SECONDS / wall_s, "text_chars": len(st.text)}
    emit("stream_parity", nvidia_smi=smi, **stats)
    check(stats["mean_abs_err"] <= 1e-2 and stats["max_abs_err"] <= 0.25
          and stats["argmax_agreement"] >= 0.98, f"streamed vs offline logits: {stats}")
    check(offline_launches > 0 or device != "cuda", "K1f never launched on the offline path")
    return stats


# the beam check's head gain: sharpens the near-uniform posteriors of
# the one-epoch model, whose near-ties the host's f64 scores and K3's f32
# scores may break apart (both engines then decode the same sharp logits)
BEAM_HEAD_GAIN = 16.0


def device_vs_host_beam(model, fe, alphabet, lm, smi: str, device: str = "cuda") -> dict:
    """The device beam engine (K3 in its stateful mode) against the host
    engine with a word LM, on one 20 s stream: the same text and offsets
    from the same logits, and K3 launched (its count zeroed first).
    ``model``'s head is sharpened by BEAM_HEAD_GAIN first (a copy)."""
    import copy

    import torch

    import tpuasr_torch.ops.beam as beam_ops
    from tpuasr_torch.stream import StreamingTranscriber

    model = copy.deepcopy(model)
    with torch.no_grad():
        model.head_kernel.mul_(BEAM_HEAD_GAIN)

    wave = wave_of(wav_bytes(STREAM_SECONDS, seed=8))
    out = {}
    for impl in ("host", "device"):
        beam_ops.beam_scan.launches = 0  # ---- the stateful K3 path starts here
        st = StreamingTranscriber(model, model.config, fe, alphabet,
                                  chunk_frames=STREAM_CHUNK_FRAMES, decoder="beam", lm=lm,
                                  beam_impl=impl, device=device)
        t0 = time.perf_counter()
        for i in range(0, len(wave), 5000):
            st.feed(wave[i:i + 5000])
        st.flush()
        out[impl] = {"text": st.text, "offsets": st.offsets.tolist(),
                     "wall_s": time.perf_counter() - t0,
                     "k3_launches": beam_ops.beam_scan.launches}  # ---- and ends here
    row = {"head_gain": BEAM_HEAD_GAIN, "text": out["device"]["text"],
           "same_text": out["device"]["text"] == out["host"]["text"],
           "same_offsets": out["device"]["offsets"] == out["host"]["offsets"],
           "k3_launches": out["device"]["k3_launches"],
           "host_wall_s": out["host"]["wall_s"], "device_wall_s": out["device"]["wall_s"]}
    emit("stream_beam", nvidia_smi=smi, **row, host_text=out["host"]["text"])
    check(row["same_text"] and row["same_offsets"], f"device vs host beam: {out}")
    check((row["k3_launches"] > 0 or device != "cuda") and out["host"]["k3_launches"] == 0,
          f"K3 launches (device, host): {row['k3_launches']}, {out['host']['k3_launches']}")
    return row


# where a tick reads back: the logits (greedy) or K3's packed outputs
READ_BACK = {"greedy": "tick", "beam": "to_host"}


def tick_times(model, fe, alphabet, lm, smi: str, ticks: int = 30,
               device: str = "cuda") -> dict:
    """ms per warm tick of MultiStreamTranscriber at 8 live streams, greedy
    and with the device beam (word LM); the share of a tick spent in the
    plain chunk recurrence (CUDA events around each ``_rnn_chunk``, and
    the host's time in them); and where a warm tick first waits for the
    card (under torch.cuda.set_sync_debug_mode "error" the tick stops at
    its first synchronising call, which must be the one read-back; the
    stopped tick changed nothing, and runs again)."""
    import traceback

    import torch

    import tpuasr_torch.stream as stream_mod

    real_chunk = stream_mod._rnn_chunk
    rows = {}
    for decoder in ("greedy", "beam"):
        mst = stream_mod.MultiStreamTranscriber(
            model, model.config, fe, alphabet, max_streams=8,
            chunk_frames=STREAM_CHUNK_FRAMES, decoder=decoder, lm=lm,
            beam_impl="device", device=device)
        sids = [mst.open() for _ in range(8)]
        hop = fe.hop
        need = (ticks + 6) * STREAM_CHUNK_FRAMES * hop  # 3 warm, the timed, 2 more
        for j, sid in enumerate(sids):
            mst.feed(sid, wave_of(wav_bytes(need / 16000 + 0.1, seed=30 + j)))
        for _ in range(3):
            mst.tick()
        cuda = device == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        spans, host = [], [0.0]

        def event():
            ev = torch.cuda.Event(enable_timing=True) if cuda else None
            if cuda:
                ev.record()
            return ev

        def timed_chunk(*a, **kw):
            h0 = time.perf_counter()
            s = event()
            out = real_chunk(*a, **kw)
            spans.append((s, event()))
            host[0] += time.perf_counter() - h0
            return out

        with mock.patch.object(stream_mod, "_rnn_chunk", timed_chunk):
            t0 = time.perf_counter()
            start = event()
            for _ in range(ticks):
                check(mst.tick(), "a tick with 8 ready streams did nothing")
            end = event()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
        rnn_ms = sum(s.elapsed_time(e) for s, e in spans) / ticks if cuda else None
        device_ms = start.elapsed_time(end) / ticks if cuda else None
        first_sync = None
        if cuda:  # the first host sync of a warm tick must be its read-back
            torch.cuda.set_sync_debug_mode("error")
            try:
                mst.tick()
            except RuntimeError as exc:
                first_sync = [f.name for f in traceback.extract_tb(exc.__traceback__)
                              if "tpuasr_torch" in f.filename][-1]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            # the aborted tick changed nothing: it runs again in full
            check(mst.tick(), "the tick after the sync check did nothing")
        rows[decoder] = {"ms_per_tick": wall_ms, "device_span_ms_per_tick": device_ms,
                         "rnn_chunk_ms_per_tick": rnn_ms,
                         "rnn_chunk_share": rnn_ms / device_ms if cuda else None,
                         "rnn_chunk_host_ms_per_tick": host[0] * 1e3 / ticks,
                         "first_sync_of_a_tick": first_sync,
                         "audio_s_per_tick": 8 * STREAM_CHUNK_FRAMES * hop / 16000}
        check(not cuda or first_sync == READ_BACK[decoder],
              f"{decoder} tick: its first host sync is in {first_sync}, not the read-back")
    emit("stream_ticks", streams=8, chunk_frames=STREAM_CHUNK_FRAMES, nvidia_smi=smi, **rows)
    return rows


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def load_tests(ckpt, lm_path: str, smi: str, streams: int = 8,
               seconds: float = STREAM_SECONDS, device: str = "cuda") -> dict:
    """``cli.serve --streaming --max-streams 8`` started as a process,
    greedy and ``--decoder beam --stream-beam-impl device`` (both started
    together), each driven by ``scripts/stream_load_test.py --streams 8
    --seconds 20`` in a process of its own (HTTP only); every stream must
    finish. Both servers are stopped whatever happens."""
    import signal

    work = ROOT / "build" / "chip_smoke"
    modes = {"greedy": [], "beam_device": ["--decoder", "beam", "--stream-beam-impl", "device",
                                            "--lm-path", lm_path]}
    procs, ports, logs = {}, {}, {}
    try:
        for mode, extra in modes.items():
            ports[mode] = free_port()
            logs[mode] = open(work / f"serve_stream_{mode}.log", "w")
            procs[mode] = subprocess.Popen(
                [sys.executable, "-m", "tpuasr_torch.cli.serve", "--model-path", str(ckpt),
                 "--host", "127.0.0.1", "--port", str(ports[mode]), "--streaming",
                 "--max-streams", str(streams), "--device", device, *extra],
                cwd=ROOT, stdout=logs[mode], stderr=subprocess.STDOUT)
        for mode in modes:  # both up before either is driven
            deadline = time.perf_counter() + 300
            while True:
                check(procs[mode].poll() is None, f"{mode} server exited")
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{ports[mode]}/healthz", timeout=5):
                        break
                except OSError:
                    check(time.perf_counter() < deadline, f"{mode} server never came up")
                    time.sleep(0.5)
        rows = {}
        for mode in modes:
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, str(ROOT / "scripts" / "stream_load_test.py"), "--port",
                 str(ports[mode]), "--streams", str(streams), "--seconds", str(seconds)],
                capture_output=True, text=True, timeout=600)
            check(res.returncode == 0 and procs[mode].poll() is None,
                  f"{mode} load test rc {res.returncode}: {res.stderr[-2000:]}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            check(line["audio_s_total"] == streams * seconds,
                  f"{mode}: not every stream finished: {line}")
            rows[mode] = {**line, "command_s": time.perf_counter() - t0}
        emit("stream_load", nvidia_smi=smi, **rows)
        return rows
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()


def stream_inputs(n_train: int = 64, n_val: int = 32):
    """Phase 4's synthetic corpus and phase 6's word trigram, made anew:
    the inputs of ``phase_stream`` when it runs alone (--stream-only)."""
    import shutil

    from tpuasr_torch.cli import synth_corpus, train_lm

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work / "corpus", ignore_errors=True)
    paths = synth_corpus.generate(str(work / "corpus"), n_train + n_val, 5.0,
                                  n_val / (n_train + n_val), seed=0)
    lm_word = str(work / "lm_word.arpa")
    rc, lines = run_cli(train_lm.main, ["--manifest", paths["train"], "--order", "3",
                                        "--out", lm_word])
    check(rc == 0, f"cli.train_lm: {lines}")
    return paths, lm_word


def phase_stream(smi: str, name: str, paths, lm_path: str) -> dict:
    """Slice 10's paths at the flagship's width with one direction (5
    GRU-800 layers, bf16, lookahead 20): training, offline serving, live
    streaming against the offline model, the device beam against the
    host beam, ticks at 8 streams, and the HTTP load test."""
    import dataclasses

    import torch

    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.decode.lm import load_lm
    from tpuasr_torch.train.checkpoint import load_checkpoint

    res, out, _ = phase_train(smi, name, path="uni", epochs=1, paths=paths)
    train_step_parity(out, paths, path="uni")
    ckpt = out / "best.ckpt"
    serve_launches = phase_serve(smi, name, path="uni", ckpt=ckpt, long_request=False,
                                 warmup=(5.0,), full_batch=True)
    pkg = load_checkpoint(str(ckpt))
    cfg = pkg.model_config
    check(not cfg.bidirectional and cfg.lookahead_context == 20 and cfg.hidden_size == 800,
          f"the stream phase's model: {cfg}")
    model = model_from_variables(pkg.variables, cfg, torch.device("cuda"))
    fe = dataclasses.replace(pkg.frontend_config, normalize=False)
    lm = load_lm(lm_path)
    parity = stream_vs_offline(model, fe, pkg.alphabet, smi)
    beam = device_vs_host_beam(model, pkg.frontend_config, pkg.alphabet, lm, smi)
    ticks = tick_times(model, pkg.frontend_config, pkg.alphabet, lm, smi)
    load = load_tests(ckpt, lm_path, smi)
    return {"train": res["launches"], "serve": serve_launches,
            "offline": parity["offline_k1f_launches"], "beam": beam["k3_launches"],
            "ticks": ticks, "load": load, "ckpt": ckpt}


# ------------------------------------------------------- compat and native

# utterances of the validation set that the Python host beam decodes
# against the C++ one (its search takes ~12 ms a frame on the host)
NATIVE_UTTS = 8


def export_pth(ckpts: dict) -> dict:
    """``python -m tpuasr_torch.compat.torch_export`` for each
    checkpoint, the processes started together; ``<ckpt>.pth`` each."""
    procs = {k: subprocess.Popen([sys.executable, "-m", "tpuasr_torch.compat.torch_export",
                                  str(c), str(c.with_suffix(".pth"))], cwd=ROOT,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, c in ckpts.items()}
    pths = {}
    for k, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        pths[k] = ckpts[k].with_suffix(".pth")
        check(proc.returncode == 0 and out.strip() == f"wrote {pths[k]}",
              f"torch_export {ckpts[k]}: rc {proc.returncode}: {out[-2000:]}")
    return pths


def pth_serving(path: str, ckpt, pth, smi: str, device: str = "cuda") -> dict:
    """The ``.tpuasr`` checkpoint and its exported ``.pth`` package (read
    by load_torch_package) each served by TranscriptionService: warm-up,
    phase_serve's 32 x 5 s batch and one request. The logits must be bit
    for bit the same (the weights are the same f32 values), and so the
    texts; the path's forward kernel is counted from the ``.pth``
    service's start."""
    import torch

    from tpuasr_torch.compat.torch_import import load_torch_package
    from tpuasr_torch.serve import ServeConfig, TranscriptionService
    from tpuasr_torch.train.checkpoint import load_checkpoint

    mod, fwd_name = rnn_path(path)[:2]
    kernel = getattr(mod, fwd_name)
    bodies = [wav_bytes(5.0, seed=100 + j) for j in range(32)]
    res = {}
    for label, model_path, pkg in (("tpuasr", ckpt, load_checkpoint(str(ckpt))),
                                   ("pth", pth, load_torch_package(str(pth)))):
        kernel.launches = 0  # ---- the main path starts here
        svc = TranscriptionService(str(model_path), ServeConfig(max_batch=32,
                                                                warmup_seconds=(5.0,)),
                                   package=pkg, device=device)
        try:
            arr, lens = service_batch(svc, bodies)
            logits, out_len = svc.eval_step(arr, lens)
            texts = svc.decoder.decode(logits, out_len)
            answer = svc.transcribe_wav_bytes(bodies[0])
            launches = kernel.launches  # ---- and ends here
            batch_ms = time_ms(lambda: svc.eval_step(arr, lens), iters=5) \
                if device == "cuda" else None
        finally:
            svc.close()
        res[label] = {"logits": logits, "texts": texts, "answer": answer,
                      "launches": launches, "batch_ms": batch_ms,
                      "config": pkg.model_config.to_dict()}
    a, b = res["tpuasr"], res["pth"]
    row = {"path": path, "pth_mbytes": pth.stat().st_size / 1e6,
           "config_equal": a["config"] == b["config"],
           "logits_max_abs_diff": (a["logits"] - b["logits"]).abs().max().item(),
           "texts_equal": a["texts"] == b["texts"] and a["answer"] == b["answer"],
           "launches": b["launches"], "batch_ms_tpuasr": a["batch_ms"],
           "batch_ms_pth": b["batch_ms"], "logits_finite": bool(torch.isfinite(b["logits"]).all())}
    emit("serve_pth", nvidia_smi=smi, kernel=fwd_name, **row)
    check(row["config_equal"] and row["logits_max_abs_diff"] == 0.0 and row["texts_equal"]
          and row["logits_finite"], f"the .pth package served vs the .tpuasr one: {row}")
    check(row["launches"] > 0 or device != "cuda", f"{fwd_name} never launched serving {pth}")
    return row


def chars_matched(a: list, b: list) -> tuple:
    """(characters matched, characters) of two lists of texts: the longer
    text's length less the edit distance, summed."""
    from tpuasr_torch.decode.metrics import levenshtein

    total = sum(max(len(x), len(y)) for x, y in zip(a, b))
    return total - sum(levenshtein(x, y) for x, y in zip(a, b)), total


def sharpened(pkg, gain: float = BEAM_HEAD_GAIN):
    """A checkpoint package with its head scaled by ``gain`` and run in
    f32 compute: the engine checks' model. bf16 logits hold many exactly
    equal values, so paths of exactly equal probability are common; the
    C++ search (f32 scores) sees such paths tie and breaks the tie by
    prefix, where the Python search's f64 rounding orders them at random."""
    import dataclasses

    params = pkg.variables["params"]
    head = {**params["head"], "kernel": params["head"]["kernel"] * np.float32(gain)}
    return dataclasses.replace(
        pkg, model_config=dataclasses.replace(pkg.model_config, compute_dtype="float32"),
        variables={**pkg.variables, "params": {**params, "head": head}})


def native_batch_decode(ckpt, paths, lm_path: str, smi: str, device_utt_s,
                        device: str = "cuda") -> dict:
    """``cli.test --decoder beam-native`` (the C++ host beam, 8 threads)
    against ``--decoder beam`` (the Python host beam) with the word
    trigram, on NATIVE_UTTS validation utterances of the checkpoint
    ``sharpened``: the same summary and hypotheses (utt/s of the warm
    second pass); then both decoders on the same logits of the trained
    (bf16) model, whose agreement (characters matched) is printed, not
    checked."""
    import tpuasr_torch.ops.gru as gru_mod
    from tpuasr_torch.cli import test as test_cli
    from tpuasr_torch.decode.beam_host import BeamCTCDecoder
    from tpuasr_torch.decode.native import NativeBeamDecoder
    from tpuasr_torch.serve import ServeConfig, TranscriptionService
    from tpuasr_torch.train.checkpoint import load_checkpoint, save_checkpoint

    work = ROOT / "build" / "chip_smoke"
    lines = Path(paths["val"]).read_text().splitlines()[:NATIVE_UTTS]
    manifest = work / "val_native.csv"
    manifest.write_text("".join(ln + "\n" for ln in lines))
    pkg = load_checkpoint(str(ckpt))
    sharp_pkg = sharpened(pkg)
    sharp = work / "sharp.ckpt"
    save_checkpoint(str(sharp), sharp_pkg)
    runs = {}
    for dec in ("beam-native", "beam"):
        hyps = work / f"hyps_{dec}.jsonl"
        argv = ["--model-path", str(sharp), "--test-manifest", str(manifest), "--decoder", dec,
                "--lm-path", lm_path, "--beam-width", str(BEAM_W), "--lm-workers", "8",
                "--batch-size", "32", "--timing", "--timing-repeats", "2",
                "--save-output", str(hyps), "--device", device]
        gru_mod.bigru_forward.launches = 0  # ---- the main path starts here
        rc, out = run_cli(test_cli.main, argv)
        runs[dec] = {**parse_summary(out), "launches": gru_mod.bigru_forward.launches,
                     "hyps": hyps.read_text()}  # ---- and ends here
        check(rc == 0 and "wer" in runs[dec] and runs[dec]["utts"] == len(lines),
              f"cli.test --decoder {dec}: {out}")
    nat, host = runs["beam-native"], runs["beam"]
    same = (nat["wer"], nat["cer"], nat["hyps"]) == (host["wer"], host["cer"], host["hyps"])

    def batch_logits(package, n):
        svc = TranscriptionService(str(ckpt), ServeConfig(max_batch=32), package=package,
                                   device=device)
        try:
            arr, lens = service_batch(svc, [Path(ln.split(",")[0]).read_bytes()
                                            for ln in lines[:n]])
            return svc.eval_step(arr[:n], lens[:n])
        finally:
            svc.close()

    if not same:  # the logits both decoders read, for a replay on the host
        logits, out_len = batch_logits(sharp_pkg, len(lines))
        dump = ROOT / "build" / "chip_smoke" / "native_decode_mismatch"
        dump.mkdir(parents=True, exist_ok=True)
        np.savez(dump / "logits.npz", logits=logits.float().cpu().numpy(),
                 lengths=out_len.cpu().numpy())
        (dump / "hyps.json").write_text(json.dumps({"native": nat["hyps"],
                                                    "host": host["hyps"],
                                                    "labels": pkg.alphabet.labels}))
        (dump / "lm.arpa").write_bytes(Path(lm_path).read_bytes())
    logits, out_len = batch_logits(pkg, NATIVE_UTTS // 2)
    kw = dict(lm_path=lm_path, beam_width=BEAM_W)
    matched, chars = chars_matched(
        NativeBeamDecoder(pkg.alphabet, num_processes=8, **kw).decode(logits, out_len),
        BeamCTCDecoder(pkg.alphabet, **kw).decode(logits, out_len))
    row = {"utts": len(lines), "head_gain": BEAM_HEAD_GAIN, "compute_dtype": "float32",
           "wer": nat["wer"], "cer": nat["cer"], "summaries_and_hyps_equal": same,
           "native_utt_per_s": nat["utt_per_s"], "host_utt_per_s": host["utt_per_s"],
           "beam_device_utt_per_s": device_utt_s, "k1f_launches": nat["launches"],
           "trained_bf16_utts": NATIVE_UTTS // 2, "trained_bf16_chars_matched": matched,
           "trained_bf16_chars": chars}
    emit("decode_native", nvidia_smi=smi, **row)
    check(same, f"beam-native vs beam: {nat} vs {host}")
    check(nat["launches"] > 0 or device != "cuda", "K1f never launched in cli.test beam-native")
    return row


def native_streaming(ckpt, lm_path: str, smi: str, device: str = "cuda") -> dict:
    """StreamingTranscriber(beam_impl="native") against beam_impl="host"
    on phase 10's 20 s wave, with the unidirectional checkpoint
    ``sharpened``: the same text and offsets; then ``cli.transcribe
    --streaming --decoder beam --beam-impl native`` on the checkpoint."""
    from tpuasr_torch.cli import transcribe
    from tpuasr_torch.compat.weights import model_from_variables
    from tpuasr_torch.decode.lm import load_lm
    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.stream import StreamingTranscriber
    from tpuasr_torch.train.checkpoint import load_checkpoint

    pkg = sharpened(load_checkpoint(str(ckpt)))
    model = model_from_variables(pkg.variables, pkg.model_config, resolve_device(device))
    lm = load_lm(lm_path)
    wave = wave_of(wav_bytes(STREAM_SECONDS, seed=8))
    out = {}
    for impl in ("native", "host"):
        st = StreamingTranscriber(model, model.config, pkg.frontend_config, pkg.alphabet,
                                  chunk_frames=STREAM_CHUNK_FRAMES, decoder="beam", lm=lm,
                                  beam_impl=impl, collect_logits=True, device=device)
        t0 = time.perf_counter()
        for i in range(0, len(wave), 5000):
            st.feed(wave[i:i + 5000])
        st.flush()
        out[impl] = {"text": st.text, "offsets": st.offsets.tolist(),
                     "wall_s": time.perf_counter() - t0, "rows": st.logits()}
    nat, host = out["native"], out["host"]
    row = {"head_gain": BEAM_HEAD_GAIN, "compute_dtype": "float32",
           "same_text": nat["text"] == host["text"],
           "same_offsets": nat["offsets"] == host["offsets"], "chars": len(nat["text"]),
           "native_wall_s": nat["wall_s"], "host_wall_s": host["wall_s"]}
    if not (row["same_text"] and row["same_offsets"]):
        # the rows both engines decoded, for a replay on the host
        dump = ROOT / "build" / "chip_smoke" / "native_stream_mismatch"
        dump.mkdir(parents=True, exist_ok=True)
        np.savez(dump / "rows.npz", rows=nat["rows"], host_rows=host["rows"])
        (dump / "texts.json").write_text(json.dumps({
            k: {"text": v["text"], "offsets": v["offsets"]} for k, v in out.items()}))
        (dump / "lm.arpa").write_bytes(Path(lm_path).read_bytes())
    wav20 = ROOT / "build" / "chip_smoke" / "long20.wav"
    t0 = time.perf_counter()
    rc, lines = run_cli(transcribe.main, [
        "--model-path", str(ckpt), "--audio-path", str(wav20), "--streaming",
        "--decoder", "beam", "--lm-path", lm_path, "--beam-impl", "native",
        "--device", device])
    row.update(cli_rc=rc, cli_wall_s=time.perf_counter() - t0, cli_chars=len("".join(lines)))
    emit("stream_native", nvidia_smi=smi, **row)
    check(row["same_text"] and row["same_offsets"], f"native vs host stream beam: {row}")
    check(rc == 0, f"cli.transcribe --streaming --beam-impl native: {rc} {lines}")
    return row


def phase_compat_native(smi: str, ckpts: dict, paths, lm_path: str, device_utt_s,
                        uni_ckpt, device: str = "cuda") -> dict:
    """Slice 11: the BiGRU and BiLSTM checkpoints exported to ``.pth``
    and served from it, the C++ host beam in cli.test against the Python
    one, and native streaming sessions against the host engine."""
    t0 = time.perf_counter()
    pths = export_pth(ckpts)
    served = {path: pth_serving(path, ckpts[path], pths[path], smi, device) for path in ckpts}
    decode = native_batch_decode(ckpts["gru"], paths, lm_path, smi, device_utt_s, device)
    native_streaming(uni_ckpt, lm_path, smi, device)
    emit("compat_native_wall", seconds=time.perf_counter() - t0)
    return {"serve_pth_gru": served["gru"]["launches"],
            "serve_pth_lstm": served["lstm"]["launches"],
            "test_beam_native": decode["k1f_launches"]}


# ------------------------------------------------------------- distributed

# The distributed paths of phase 13: (name, ModelConfig fields beside the
# flagship's, tp, direction_tp), each on two ranks.
DIST_CASES = (
    ("train_dp", {}, 1, False),
    ("train_tp_gru", {}, 2, True),
    ("train_tp_lstm", {"rnn_type": "lstm"}, 2, True),
    ("train_tp_gru2", {"rnn_impl": "pallas2"}, 2, True),
    ("train_tp_gate", {"bidirectional": False, "lookahead_context": 20}, 2, False),
)
# the recurrent kernels a path launches (K2a and K2b besides)
DIST_KERNELS = {"train_dp": ("bigru_forward", "bigru_backward"),
                "train_dp_nccl1": ("bigru_forward", "bigru_backward"),
                "train_tp_gru": ("bigru_forward", "bigru_backward"),
                "train_tp_lstm": ("bilstm_forward", "bilstm_backward"),
                "train_tp_gru2": ("bigru2_forward", "bigru2_backward"),
                "train_tp_gate": ("bigru_forward", "bigru_backward")}
DIST_LR = 3e-4
DIST_TIMED_STEPS = 3


def kernel_counters() -> dict:
    """{wrapper name: wrapper} of every kernel a training path launches:
    the recurrent wrappers, the weight gradients' helper
    (``rnn_weight_grads``, dw_gemm_bf16) and CTC's."""
    import tpuasr_torch.ops.ctc as ctc_mod
    import tpuasr_torch.ops.gru as gru_mod

    fns = [getattr(rnn_path(k)[0], n) for k in RNN_PATHS for n in RNN_PATHS[k][1:3]]
    fns += [gru_mod.rnn_weight_grads, ctc_mod.ctc_alpha, ctc_mod.ctc_beta]
    return {fn.__name__: fn for fn in fns}


def dist_config(flags: dict, width):
    """The flagship's ModelConfig (bf16, f32 parameters) at ``width``
    (hidden size, layers) with ``flags``."""
    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.model.ds2 import ModelConfig

    return ModelConfig(n_classes=Alphabet().size, hidden_size=int(width[0]),
                       hidden_layers=int(width[1]), **flags)


def load_batch(path) -> list:
    z = np.load(path)
    return [z[k] for k in ("waves", "wave_lengths", "labels", "label_lengths", "valid")]


def dist_case(path: str, cfg, variables, fields, mesh, direction_tp: bool, device: str,
              reference: bool) -> dict:
    """One distributed train step of ``path`` on this rank of ``mesh``: the
    rank's model and step from ``train.loop.rank_train_step``, this
    rank's rows of ``fields`` (the global batch), the kernels' launch
    counts of that step alone (zeroed just before, read just after),
    then DIST_TIMED_STEPS more steps timed by the host clock. With
    ``reference`` the single-process step on all the rows runs first, on
    a model of its own, and the distributed step's loss and grad_norm,
    each parameter's update and each running statistic's move are held
    to it (train_step_parity's bounds: loss rel <= 1e-2, relative norm
    errors <= 5e-2; grad_norm rel <= 1e-2, where sound runs read up to
    4.2e-4: under clipping a gradient scaled evenly leaves the update
    as it was, and only grad_norm shows it). Every rank returns the
    sha256 of its whole state (sharded leaves gathered), which the
    caller compares across ranks."""
    import hashlib

    import torch

    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.compat.weights import from_jax_variables
    from tpuasr_torch.train.loop import rank_train_step
    from tpuasr_torch.train.mesh import Mesh, whole_state
    from tpuasr_torch.train.step import TrainConfig

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    dev = torch.device(device)
    fe, tc = FrontendConfig(), TrainConfig()
    ref = None
    if reference:
        model, step = rank_train_step(variables, cfg, fe, tc, dev, Mesh())
        m = step(*fields, DIST_LR)
        ref = ({k: float(v) for k, v in m.items()},
               {k: v.detach().clone() for k, v in model.state_dict().items()})
        del model, step
    model, step = rank_train_step(variables, cfg, fe, tc, dev, mesh, direction_tp)
    b = len(fields[0]) // mesh.data_size
    own = [f[mesh.data_index * b:(mesh.data_index + 1) * b] for f in fields]
    counters = kernel_counters()
    for fn in counters.values():  # ---- the path starts here
        fn.launches = 0
    m = step(*own, DIST_LR)
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}  # ---- and ends here
    state = whole_state(model, mesh)
    digest = hashlib.sha256()
    for k in sorted(state):
        digest.update(state[k].detach().float().cpu().numpy().tobytes())
    row = {"path": path, "rank": mesh.rank, "tp": mesh.tp, "direction_tp": direction_tp,
           "rows": b, "metrics": {k: float(v) for k, v in m.items()}, "launches": launches,
           "sharded_leaves": len(model.sharded), "sha256": digest.hexdigest()}
    if dev.type == "cuda":
        used = {*DIST_KERNELS[path], "rnn_weight_grads", "ctc_alpha", "ctc_beta"}
        check(all((v > 0) == (k in used) for k, v in launches.items()),
              f"kernel launches on {path}, rank {mesh.rank}: {launches}")
    if ref is not None:
        m_ref, s_ref = ref
        before = {k: v.to(dev) for k, v in from_jax_variables(variables, cfg).items()}
        errs = {k: rel_norm_err(state[k] - before[k], s_ref[k] - before[k]) for k in s_ref}
        worst = max(errs, key=errs.get)
        got = row["metrics"]
        row.update(loss_single=m_ref["loss"],
                   loss_rel_err=abs(got["loss"] - m_ref["loss"]) / abs(m_ref["loss"]),
                   grad_norm_single=m_ref["grad_norm"],
                   grad_norm_rel_err=abs(got["grad_norm"] - m_ref["grad_norm"])
                   / m_ref["grad_norm"],
                   update_rel_norm_err_max=errs[worst], worst=worst,
                   update_rel_norm_err_median=float(np.median(list(errs.values()))))
        check(row["loss_rel_err"] <= 1e-2 and row["grad_norm_rel_err"] <= 1e-2
              and errs[worst] <= 5e-2,
              f"{path}: the distributed step against the single-process one: {row}")
    mesh.any(False)  # every rank here before the timed steps
    sync()
    t0 = time.perf_counter()
    for _ in range(DIST_TIMED_STEPS):
        step(*own, DIST_LR)
    sync()
    row["step_ms"] = (time.perf_counter() - t0) * 1e3 / DIST_TIMED_STEPS
    del model, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def dist_worker(argv: list) -> None:
    """One rank of phase_distributed (``--dist-worker SPEC`` and what
    ``cli.multiproc`` appends: ``--rank R --world-size N --dist-url
    URL``): joins the group of the spec's backend, runs ``dist_case``
    for every DIST_CASES path on a make_mesh(N, tp), rank 0 against the
    single-process step, and writes its rows to <out>/rank<R>.json."""
    import argparse

    import torch
    import torch.distributed as dist

    from tpuasr_torch.compat.weights import init_train_variables
    from tpuasr_torch.train.mesh import distributed_init, make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("spec")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--dist-url", required=True)
    args = p.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    rank, world, device = args.rank, args.world_size, spec["device"]
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    else:  # a CPU rehearsal: the cores shared out between the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    distributed_init(args.dist_url, world, rank, spec["backend"])
    try:
        fields = load_batch(spec["batch"])
        rows, inits = [], {}
        for path, flags, tp, direction_tp in DIST_CASES:
            cfg = dist_config(flags, spec["width"])
            # the weights do not depend on rnn_impl: one draw serves them all
            key = json.dumps({**cfg.to_dict(), "rnn_impl": None}, sort_keys=True)
            if key not in inits:
                inits[key] = init_train_variables(cfg, seed=0)
            rows.append(dist_case(path, cfg, inits[key], fields, make_mesh(world, tp),
                                  direction_tp, device, reference=rank == 0))
        Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()


def multiproc(world: int, dist_url: str, command: list, log: Path, timeout: float) -> float:
    """``tpuasr_torch.cli.multiproc --world-size world --dist-url
    dist_url -- *command`` in a session of its own, the ranks' output
    and errors to ``log``. It stops every rank when one fails; past
    ``timeout`` seconds the whole session is killed. Fails the phase
    with the end of the log unless it exits 0; returns its wall
    seconds."""
    import signal

    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuasr_torch.cli.multiproc", "--world-size", str(world),
             "--dist-url", dist_url, "--", *command], stdout=out, stderr=subprocess.STDOUT,
            cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
    check(rc == 0, f"{' '.join(map(str, command[:4]))} on {world} ranks exited {rc}:\n"
          + log.read_text()[-4000:])
    return time.perf_counter() - t0


def k5_d1(smi: str, device: str = "cuda", t: int = 251, b: int = 32, h: int = 800) -> dict:
    """K5f and K5b with one direction (direction TP's gate-major GRU) at
    the flagship's shape in bf16 against bigru2_reference and its
    backward (the D=2 tolerances), the whole BiGRU2Function too, then
    times beside cuDNN's unidirectional nn.GRU and the bounds."""
    import torch

    from tpuasr_torch.ops.gru import shift_time
    from tpuasr_torch.ops.gru2 import (
        BiGRU2Function,
        bigru2_backward,
        bigru2_backward_reference,
        bigru2_forward,
        bigru2_reference,
    )

    cuda = torch.device(device)
    k1 = gru_case(t, b, h, 1, torch.bfloat16, seed=80, device=cuda)
    args = (*gate_major(*k1[:3]), k1[3])
    ys = bigru2_forward(*args)
    row = {"ys": check_fwd("bigru2_fwd D=1", ys, bigru2_reference(*args), "bfloat16")}
    gen = torch.Generator(device=cuda).manual_seed(80)
    dy = (0.1 * torch.randn(ys.shape, generator=gen, device=cuda)).to(torch.bfloat16)
    bwd_args = (*args, shift_time(ys), dy)
    row["dg"] = check_bwd("bigru2_bwd D=1", bigru2_backward(*bwd_args),
                          bigru2_backward_reference(*bwd_args), "bfloat16")
    row["function_rel_norm_err"] = function_vs_plain(BiGRU2Function.apply, *args, dy, "bfloat16")
    timings = {"bigru2_forward": [fwd_timing(bigru2_forward, bigru2_reference, args, k1[:3],
                                             t, b, h, 1)],
               "bigru2_backward": [bwd_timing(bigru2_backward, bigru2_backward_reference,
                                              bwd_args, k1[:3], t, b, h, 1)]}
    emit("kernel_d1", kind="gru2", shape=[t, 1, b, h], dtype="bfloat16", **row,
         fwd_time=timings["bigru2_forward"][0], bwd_time=timings["bigru2_backward"][0],
         nvidia_smi=smi)
    return {"max_abs_err": {"bigru2_forward": row["ys"]["max_abs_err"],
                            "bigru2_backward": row["dg"]["max_abs_err"]}, "timings": timings}


def dist_cli(paths, work: Path, backend: str, device: str, width, batch: int) -> dict:
    """tpuasr_torch.cli.multiproc -> cli.train --world-size 2 for one
    epoch on phase 4's corpus (``batch`` rows a rank), then
    tpuasr_torch.cli.test --decoder greedy on rank 0's checkpoint."""
    from tpuasr_torch.cli import test as test_cli

    out = work / "cli"
    cmd = [sys.executable, "-m", "tpuasr_torch.cli.train", "--train-manifest", paths["train"],
           "--val-manifest", paths["val"], "--hidden-size", width[0], "--hidden-layers",
           width[1], "--batch-size", str(batch), "--epochs", "1", "--checkpoint",
           "--save-folder", str(out), "--model-path", str(out / "best.ckpt"),
           "--log-dir", str(out / "log"), "--sync-every", "1", "--dist-backend", backend,
           "--device", device, "--world-size", "2"]
    wall_s = multiproc(2, f"file://{work}/rendezvous_cli", cmd, work / "cli.log", timeout=600)
    steps = [r for r in read_jsonl(out / "log" / "metrics.jsonl") if "train/loss" in r]
    n_train = len(Path(paths["train"]).read_text().splitlines())
    check(len(steps) == n_train // (2 * batch), f"{len(steps)} global steps logged by rank 0")
    for r in steps:
        check(np.isfinite(r["train/loss"]) and r["train/n_ok"] == 2 * batch, f"step {r}")
    rc, lines = run_cli(test_cli.main, ["--model-path", str(out / "best.ckpt"),
                                        "--test-manifest", paths["val"], "--decoder", "greedy",
                                        "--batch-size", str(2 * batch), "--device", device])
    summary = parse_summary(lines)
    check(rc == 0 and "wer" in summary, f"cli.test greedy on rank 0's checkpoint: {lines}")
    return {"wall_s": wall_s, "steps": len(steps), "losses": [r["train/loss"] for r in steps],
            "grad_norms": [r["train/grad_norm"] for r in steps],
            "step_ms": [1e3 * r["train/step_time"] for r in steps], "test_greedy": summary}


def phase_distributed(smi: str, name: str, paths, device: str = "cuda", width=("800", "5"),
                      batch: int = 32) -> dict:
    """Phase 13: distributed training. K5 at D=1 against its plain loop
    first; then one NCCL rank (world 1) in this process runs the DP step
    through NCCL's collectives; then two ranks (gloo on one card, NCCL
    across two cards) run every DIST_CASES path on phase 4's first batch
    (``batch`` rows of 5 s: data parallelism on half each, tensor
    parallelism on all of it), each against the single-process step on
    the same rows; then cli.multiproc -> cli.train --world-size 2 one
    epoch, and cli.test greedy on rank 0's checkpoint. ``device`` "cpu"
    and a small ``width`` only rehearse it (gloo, no kernels)."""
    import shutil

    import torch
    import torch.distributed as dist

    from tpuasr_torch.compat.weights import init_train_variables
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.loader import AudioBatchLoader
    from tpuasr_torch.data.manifest import order_and_prune, read_manifest
    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.train.mesh import distributed_init, make_mesh

    t0 = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    on_card = device == "cuda"
    k5 = k5_d1(smi) if on_card else None
    plan = make_buckets(order_and_prune(read_manifest(paths["train"])), batch, BucketSpec())
    first = next(iter(AudioBatchLoader(plan, Alphabet(), transfer_dtype="int16").epoch(0)))
    np.savez(work / "batch.npz", waves=first.waves, wave_lengths=first.wave_lengths,
             labels=first.labels, label_lengths=first.label_lengths, valid=first.valid)
    fields = load_batch(work / "batch.npz")
    rows = {}
    if on_card:  # one NCCL rank: the DP step's collectives through NCCL
        distributed_init(f"127.0.0.1:{free_port()}", 1, 0, "nccl")
        try:
            cfg = dist_config({}, width)
            rows["train_dp_nccl1"] = [dist_case("train_dp_nccl1", cfg,
                                                init_train_variables(cfg, seed=0), fields,
                                                make_mesh(1, 1), False, device, True)]
        finally:
            dist.destroy_process_group()
    n_cards = torch.cuda.device_count() if on_card else 0
    backend = "nccl" if n_cards >= 2 else "gloo"
    spec = {"backend": backend, "device": device, "width": list(width),
            "batch": str(work / "batch.npz"), "out": str(work)}
    (work / "spec.json").write_text(json.dumps(spec))
    ranks_s = multiproc(2, f"file://{work}/rendezvous",
                        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker",
                         str(work / "spec.json")], work / "ranks.log", timeout=900)
    by_rank = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    for r0, r1 in zip(*by_rank):
        check(r0["sha256"] == r1["sha256"],
              f"{r0['path']}: the ranks' whole states differ after the step")
        rows[r0["path"]] = [r0, r1]
    cli = dist_cli(paths, work, backend, device, width, batch // 2)
    cards = min(n_cards, 2) if backend == "nccl" else min(n_cards, 1)
    result = {"backend": backend, "ranks": 2, "cards": cards, "nvidia_smi": smi,
              "timing_note": ("step_ms: each of two ranks sharing one card (gloo, collectives "
                              "through host memory); not a speed-up" if cards < 2 else
                              "step_ms: each of two ranks, one card each (NCCL)"),
              "paths": rows, "ranks_wall_s": ranks_s, "cli": cli,
              "wall_s": time.perf_counter() - t0}
    emit("distributed", **result)
    return {"launches": {p: [r["launches"] for r in rs] for p, rs in rows.items()},
            "k5_d1": k5, "result": result}


def build_all(names) -> None:
    """One nvcc per kernel source and the host compiler for the C++ beam
    search, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from tpuasr_torch.decode.native import SOURCE
    from tpuasr_torch.ops import _build

    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(_build.build_host, SOURCE)
        list(pool.map(_build.build, names))  # raises with nvcc's output
        host.result()  # raises with the compiler's output
    for n in names:
        info = _build.build_info[n]
        emit("build", kernel=n, seconds=info["seconds"],
             ptxas=[ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "smem" in ln or "spill" in ln])
    emit("build", host_library=SOURCE.name, seconds=_build.build_info[SOURCE.name]["seconds"])


def emit_registers(label: str) -> None:
    """One build line a library this process built or loaded: ptxas'
    registers and spills, tagged ``label``."""
    from tpuasr_torch.ops import _build

    for n, info in sorted(_build.build_info.items()):
        emit("build", label=label, kernel=n,
             ptxas=[ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln])


def kernel_entry(name, replaces, err, timing, launches: dict, **extra):
    """One kernel's entry of the kernels line; ``launches`` by path."""
    source = "ctc" if name.startswith("ctc") else name
    return {"name": name, "route": "cuda", "source": f"tpuasr_torch/ops/csrc/{source}.cu",
            "replaces": replaces, "launches": sum(launches.values()), "max_abs_err": err,
            "ms": timing["ms"], "kernel_ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"], "shape": timing["shape"],
            "launches_by_path": launches, **extra}


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--dist-worker"]:  # SPEC --rank R ...: one rank of phase 13
        sys.path.insert(0, str(ROOT))
        dist_worker(sys.argv[2:])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time-ctc"]:  # LABEL [ROOT]
        sys.path.insert(0, sys.argv[3] if len(sys.argv) > 3 else str(ROOT))
        ctc_times(nvidia_smi_line(), label=sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--time-bwd"]:  # LABEL [ROOT]
        sys.path.insert(0, sys.argv[3] if len(sys.argv) > 3 else str(ROOT))
        bwd_times(nvidia_smi_line(), label=sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--time-rnn"]:  # LABEL [ROOT]: the forward times, then bwd_times
        sys.path.insert(0, sys.argv[3] if len(sys.argv) > 3 else str(ROOT))
        smi = nvidia_smi_line()
        fwd_times(smi, label=sys.argv[2])
        bwd_times(smi, label=sys.argv[2])
        emit_registers(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--time-dw"]:  # LABEL [ROOT]: the weight gradients' times
        sys.path.insert(0, sys.argv[3] if len(sys.argv) > 3 else str(ROOT))
        dw_times(nvidia_smi_line(), label=sys.argv[2])
        emit_registers(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--time-beam"]:  # WORK LABEL [ROOT]
        sys.path.insert(0, sys.argv[4] if len(sys.argv) > 4 else str(ROOT))
        time_beam_path(Path(sys.argv[2]), sys.argv[3], nvidia_smi_line())
        return 0
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--stream-only"]:  # phase 10 alone, on its own inputs
        smi = nvidia_smi_line()
        emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
        build_all(["bigru_fwd", "bigru_bwd", "ctc", "beam", "bilstm_fwd", "bilstm_bwd",
                   "rnn_dw"])
        t0 = time.perf_counter()
        phase_kernel_d1(smi)
        phase_stream(smi, torch.cuda.get_device_name(0), *stream_inputs())
        emit("wall", seconds=time.perf_counter() - t0)
        return 0
    if sys.argv[1:2] == ["--dist-only"]:  # phase 13 alone, on its own corpus
        smi = nvidia_smi_line()
        emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
        build_all(["bigru_fwd", "bigru_bwd", "ctc", "bilstm_fwd", "bilstm_bwd",
                   "bigru2_fwd", "bigru2_bwd", "rnn_dw"])
        t0 = time.perf_counter()
        phase_distributed(smi, torch.cuda.get_device_name(0), stream_inputs()[0])
        emit("wall", seconds=time.perf_counter() - t0)
        return 0

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit("device", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()
    build_all(["bigru_fwd", "bigru_bwd", "ctc", "beam", "bilstm_fwd", "bilstm_bwd",
               "bigru2_fwd", "bigru2_bwd", "birnn_fwd", "birnn_bwd", "rnn_dw"])

    k1f_row, k1f_timings = phase_kernel()
    k1b_row, k1b_timings = phase_kernel_bwd()
    ctc_row, ctc_timing = phase_kernel_ctc(smi)
    ctc_times(smi)  # ctc_split: K2a's and K2b's step split at both buckets
    k4_err, k4_timings = phase_kernel_lstm()
    k5_err, k5_timings = phase_kernel_gru2()
    k6_err, k6_timings = phase_kernel_rnn()
    bwd_times(smi)  # bwd_split: the backward loops' times and step split
    dw_rows = dw_times(smi)  # dw_gemm_bf16 against the f32 einsum at the cells' shapes
    phase_fwd_row_groups()
    train_res, out, paths = phase_train(smi, name)
    train_step_parity(out, paths)
    train_breakdown(out, paths, smi)
    beam_err, beam_timings = phase_kernel_beam(out, paths, smi)
    beam_split(corpus_texts(paths), smi)
    limit_rows = phase_beam_limits(smi)
    decode_res, lm_word = phase_decode(out, paths, smi)
    decode_breakdown(out, paths, lm_word, smi)
    serve_launches = phase_serve(smi, name)
    # the BiLSTM and the gate-major BiGRU: one epoch (2 steps and a
    # validation) on the same corpus, then their checkpoints served
    launches, ckpts = {}, {"gru": out / "best.ckpt"}
    for path in ("lstm", "gru2"):
        res, p_out, _ = phase_train(smi, name, path=path, epochs=1, paths=paths)
        train_step_parity(p_out, paths, path=path)
        train_breakdown(p_out, paths, smi, path=path)
        launches[path] = (res["launches"], phase_serve(
            smi, name, path=path, ckpt=p_out / "best.ckpt", durations=(1.0, 2.2, 3.4, 5.0),
            long_request=False, warmup=(5.0,)))
        ckpts[path] = p_out / "best.ckpt"
    aug = phase_augment_resident(smi, name, out, paths)
    # slice 10: K1 and K4 with one direction, then the unidirectional
    # flagship trained, served offline and streamed
    d1 = phase_kernel_d1(smi)
    stream = phase_stream(smi, name, paths, lm_word)
    # slice 11: .pth export and serving, the C++ host beam batch and streaming
    compat = phase_compat_native(smi, {k: ckpts[k] for k in ("gru", "lstm")}, paths, lm_word,
                                 decode_res["word"]["utt_per_s"], stream["ckpt"])
    # slice 12: data and tensor parallelism on two ranks, then cli.multiproc
    dist_res = phase_distributed(smi, name, paths)
    emit("wall", seconds=time.perf_counter() - t_start)

    train_launches = train_res["launches"]
    (lstm_train, lstm_serve), (gru2_train, gru2_serve) = launches["lstm"], launches["gru2"]
    beam_launches = {**{f"test_{k}": v["launches"] for k, v in decode_res.items()
                        if isinstance(v, dict)},
                     **{k: v for k, v in decode_res.items() if not isinstance(v, dict)}}

    def by_path(wrapper, **serve):
        """A wrapper's launch counts on the four training paths (and
        the serving and evaluation paths given)."""
        return {"train": train_launches[wrapper], "train_lstm": lstm_train[wrapper],
                "train_gru2": gru2_train[wrapper], "train_resident": aug["train"][wrapper],
                "train_uni": stream["train"][wrapper],
                **{p: sum(r[wrapper] for r in ranks)
                   for p, ranks in dist_res["launches"].items()}, **serve}

    def by_rank(wrapper):
        """A wrapper's launch counts on the distributed paths, rank by rank."""
        return {p: [r[wrapper] for r in ranks] for p, ranks in dist_res["launches"].items()}

    def d1_of(wrapper):
        """A recurrent kernel's D=1 checks: max-abs error vs plain and
        times at T'=251 and 826 (not main-path launches)."""
        return {"max_abs_err_d1": d1["max_abs_err"][wrapper], "timings_d1": d1["timings"][wrapper]}

    print(json.dumps({"kernels": [
        kernel_entry("bigru_fwd", "tpuasr/ops/gru.py:71 _fwd_kernel", k1f_row["max_abs_err"],
                     k1f_timings[0], by_path("bigru_forward", serve=serve_launches,
                                             test_resident_greedy=aug["greedy"]["bigru_forward"],
                                             test_resident_beam=aug["beam"]["bigru_forward"],
                                             serve_uni=stream["serve"],
                                             stream_offline_uni=stream["offline"],
                                             serve_pth_gru=compat["serve_pth_gru"],
                                             test_beam_native=compat["test_beam_native"]),
                     timings=k1f_timings, **d1_of("bigru_forward"),
                     launches_by_rank=by_rank("bigru_forward"), card=smi),
        kernel_entry("bigru_bwd", "tpuasr/ops/gru.py:100 _bwd_kernel", k1b_row["max_abs_err"],
                     k1b_timings[0], by_path("bigru_backward"), timings=k1b_timings,
                     **d1_of("bigru_backward"),
                     launches_by_rank=by_rank("bigru_backward"), card=smi),
        kernel_entry("ctc_alpha", "tpuasr/ops/ctc.py:57 _alpha_kernel",
                     ctc_row["alphas_max_abs_err"], ctc_timing["ctc_alpha"][0],
                     by_path("ctc_alpha"), loss_rel_err=ctc_row["loss_rel_err"],
                     timings=ctc_timing["ctc_alpha"],
                     launches_by_rank=by_rank("ctc_alpha"), card=smi),
        kernel_entry("ctc_beta", "tpuasr/ops/ctc.py:83 _beta_kernel",
                     ctc_row["demit_max_abs_err"], ctc_timing["ctc_beta"][0], by_path("ctc_beta"),
                     dlogits_max_abs_err=ctc_row["dlogits_max_abs_err"],
                     timings=ctc_timing["ctc_beta"],
                     launches_by_rank=by_rank("ctc_beta"), card=smi),
        kernel_entry("beam", "tpuasr/ops/beam.py:89 _beam_kernel", beam_err,
                     next(r for r in beam_timings if r["mode"] == "word"),
                     {**beam_launches, "test_resident_beam": aug["beam"]["beam_scan"],
                      "stream_device_beam": stream["beam"]},
                     timings=beam_timings, limits=limit_rows, card=smi),
        kernel_entry("bilstm_fwd", "tpuasr/ops/lstm.py:62 _fwd_kernel", k4_err["bilstm_fwd"],
                     k4_timings["bilstm_fwd"][0],
                     by_path("bilstm_forward", serve_lstm=lstm_serve,
                             serve_pth_lstm=compat["serve_pth_lstm"]),
                     timings=k4_timings["bilstm_fwd"], **d1_of("bilstm_forward"),
                     launches_by_rank=by_rank("bilstm_forward"), card=smi),
        kernel_entry("bilstm_bwd", "tpuasr/ops/lstm.py:94 _bwd_kernel", k4_err["bilstm_bwd"],
                     k4_timings["bilstm_bwd"][0], by_path("bilstm_backward"),
                     timings=k4_timings["bilstm_bwd"], **d1_of("bilstm_backward"),
                     launches_by_rank=by_rank("bilstm_backward"), card=smi),
        kernel_entry("bigru2_fwd", "tpuasr/ops/gru2.py:36 _fwd_kernel", k5_err["bigru2_fwd"],
                     k5_timings["bigru2_fwd"][0],
                     by_path("bigru2_forward", serve_gru2=gru2_serve),
                     timings=k5_timings["bigru2_fwd"], launches_by_rank=by_rank("bigru2_forward"),
                     max_abs_err_d1=dist_res["k5_d1"]["max_abs_err"]["bigru2_forward"],
                     timings_d1=dist_res["k5_d1"]["timings"]["bigru2_forward"], card=smi),
        kernel_entry("bigru2_bwd", "tpuasr/ops/gru2.py:77 _bwd_kernel", k5_err["bigru2_bwd"],
                     k5_timings["bigru2_bwd"][0], by_path("bigru2_backward"),
                     timings=k5_timings["bigru2_bwd"], launches_by_rank=by_rank("bigru2_backward"),
                     max_abs_err_d1=dist_res["k5_d1"]["max_abs_err"]["bigru2_backward"],
                     timings_d1=dist_res["k5_d1"]["timings"]["bigru2_backward"], card=smi),
        # K6 replaces no TPU kernel, and no path of this run launches it
        # (the benchmark's ds2_birnn1280.train_rnn cell does)
        *(kernel_entry(k, "none: tpuasr runs the vanilla RNN as a lax.scan", k6_err[k],
                       k6_timings[k][0], {}, timings=k6_timings[k], card=smi)
          for k in ("birnn_fwd", "birnn_bwd")),
        # the weight gradients of every bf16 backward; plain_ms is the
        # copies and the f32 einsum, library_ms the einsum alone
        kernel_entry("dw_gemm_bf16", "none: tpuasr leaves dW and db to XLA's einsum",
                     max(r["max_abs_err"] for r in dw_rows), dw_rows[0],
                     by_path("rnn_weight_grads"),
                     source="tpuasr_torch/ops/csrc/rnn_dw.cu (rnn_bwd.cuh)",
                     max_rel_err={k: max(r["rel_err"][k] for r in dw_rows) for k in ("dw", "db")},
                     max_rel_err_f64={k: max(r["rel_err_f64"][k] for r in dw_rows)
                                      for k in ("dw", "db")},
                     einsum_max_rel_err_f64={k: max(r["einsum_rel_err_f64"][k] for r in dw_rows)
                                             for k in ("dw", "db")},
                     timings=dw_rows, launches_by_rank=by_rank("rnn_weight_grads"), card=smi),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
