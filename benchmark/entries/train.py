"""Training entry: ``train.step.make_resident_epoch_runner`` over
``make_train_step`` on a device-resident corpus (what ``cli.train
--device-resident-audio`` runs), one chunk of steps a bucket, the
chunk's metrics read back after it as the CLI reads them.

Set-up builds the model from the seed, runs the three check steps
through the runner (three whole batches of distinct rows, K=1 chunks, so
that the first momentum buffers can be read after step 1), warms every
bucket's shape with one step, and hands the same model and optimizer to
the window. The window runs whole epochs' chunks (epochs 1, 2, ...,
shuffled within buckets) until ``--seconds`` have passed, then drains
the card. ``--trace 1`` traces exactly one epoch instead.

``correct``: the reference (``lib/reference.py``) follows the three check
steps from the same weights on the same rows; compared are the first
clipped gradient by its median and its worst leaf, and the parameters'
change after the three steps by its median leaf (``CHECKS``).
"""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace

import numpy as np

from benchmark.lib import bounds
from benchmark.lib.harness import Context, Result, leaf_gaps, still_leaves, traced_window
from benchmark.lib.traffic import SAMPLE_RATE, make_corpus, memory_entries, rng_of
from benchmark.lib.weights import make_weights

CHECK_STEPS = 3
# the numbers compared; PERF.md gives their readings, and why the loss
# and the change's worst leaf are read but not compared
CHECKS = ("grad1_median_leaf_gap", "grad1_leaf_gap", "change3_median_leaf_gap")


def build(ctx: Context, corpus):
    """The program's model, train step, runner and resident loader."""
    from tpuasr_torch.audio.frontend import FrontendConfig
    from tpuasr_torch.data.buckets import BucketSpec, make_buckets
    from tpuasr_torch.data.resident import ResidentBatchLoader
    from tpuasr_torch.labels import Alphabet
    from tpuasr_torch.model.ds2 import DeepSpeech2, ModelConfig
    from tpuasr_torch.train.step import TrainConfig, make_resident_epoch_runner, make_train_step

    mix = ctx.mix
    plan = make_buckets(memory_entries(corpus), mix["batch_size"], BucketSpec(),
                        seed=ctx.seed % (2 ** 31))
    loader = ResidentBatchLoader(plan, Alphabet(labels=ctx.cfg["labels"]), device=ctx.device)
    model = DeepSpeech2(ModelConfig(**ctx.cfg["model"])).to(ctx.device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = make_weights(shapes, ctx.seed, ctx.device, mix.get("head_gain", 1.0))
    model.load_state_dict(weights)
    model.train()
    step = make_train_step(model, FrontendConfig(), TrainConfig(
        lr=mix["lr"], momentum=mix["momentum"], max_norm=mix["max_norm"]))
    return weights, model, step, make_resident_epoch_runner(step, seed=ctx.seed), loader


def schedule(loader, epoch: int) -> list:
    """(bucket, bank, idx (K, B), valid (K, B), entry index (K, B)) a
    chunk, with -1 for a padding row's entry."""
    out = []
    for b, bank, idx, n_valid, valid in loader.bucket_chunks(epoch):
        row_to_entry = {v: k for k, v in bank.rows.items()}
        ent = np.vectorize(row_to_entry.get)(idx)
        out.append((b, bank, idx, valid, np.where(valid, ent, -1)))
    return out


def check_batches(chunks: list, seed: int, n: int = CHECK_STEPS) -> list:
    """``n`` whole batches in a seeded order: distinct rows."""
    whole = [(c, k) for c, ch in enumerate(chunks) for k in range(ch[2].shape[0])
             if ch[3][k].all()]
    pick = rng_of(seed, 11).permutation(len(whole))[:n]
    return [whole[i] for i in pick]


def step_shapes(loader, bucket: int, n_real_frames) -> dict:
    """A step's shapes for the per-layer readers: the bucket's padded
    output frames T', the batch, and the real output frames of its rows."""
    n = loader.plan.spec.bucket_samples(bucket)
    t_pad = int(bounds.conv_out_frames(bounds.frames_of_samples(n)))
    return {"t_pad": t_pad, "b": loader.plan.batch_size, "frames": int(n_real_frames)}


def prepare(ctx: Context) -> SimpleNamespace:
    """The set-up: the corpus, the initial weights, the program's model,
    step, runner and loader, epoch 1's chunks, then the three check
    steps and their readings (losses, first momentum buffers, change)."""
    import torch

    from tpuasr_torch.train.loop import read_back

    st = SimpleNamespace()
    st.corpus = make_corpus(ctx.mix["utterances"], ctx.mix, ctx.seed, ctx.device)
    st.weights, st.model, st.step, st.runner, st.loader = build(ctx, st.corpus)
    st.chunks = schedule(st.loader, 1)
    picked = check_batches(st.chunks, ctx.seed)
    st.losses, st.first_grad, st.k0 = [], None, 0
    for c, k in picked:
        _, bank, idx, valid, _ = st.chunks[c]
        vals = read_back(st.runner(bank, idx[k:k + 1], valid[k:k + 1], ctx.mix["lr"], st.k0))
        st.losses.append(float(vals["loss"][0]))
        st.k0 += 1
        if st.first_grad is None:
            # the first momentum buffer is the clipped gradient (none: zeros)
            state = st.step.optimizer.state
            st.first_grad = {n: state[p].get("momentum_buffer", torch.zeros_like(p)).detach().clone()
                             for n, p in st.model.named_parameters()}
    st.change = {n: p.detach() - st.weights[n] for n, p in st.model.named_parameters()}
    st.check_rows = [st.chunks[c][4][k] for c, k in picked]
    return st


def run(ctx: Context) -> Result:
    import torch

    from tpuasr_torch.train.loop import read_back

    mix, cfg = ctx.mix, ctx.cfg
    res = Result()
    st = prepare(ctx)
    lr, loader, runner, k0 = mix["lr"], st.loader, st.runner, st.k0
    out_frames = bounds.conv_out_frames(bounds.frames_of_samples(st.corpus.samples))
    for b, bank, idx, valid, _ in st.chunks:  # one warm step a bucket
        read_back(runner(bank, idx[:1], valid[:1], lr, k0))
        k0 += 1

    steps, audio_samples = [], 0
    with traced_window(ctx.trace, ctx.name) as summary:
        t_w = time.perf_counter()
        res.e2e["setup_s"] = t_w - ctx.t0
        epoch = 1
        while True:
            for b, bank, idx, valid, ent in schedule(loader, epoch):
                vals = read_back(runner(bank, idx, valid, lr, k0))
                k0 += idx.shape[0]
                res.failed += int((~np.isfinite(vals["loss"])).sum())
                for row in ent:
                    real = row[row >= 0]
                    audio_samples += int(st.corpus.samples[real].sum())
                    steps.append(step_shapes(loader, b, out_frames[real].sum()))
            epoch += 1
            if ctx.trace or time.perf_counter() - t_w >= ctx.seconds:
                break
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        window = time.perf_counter() - t_w
    res.attempted = len(steps)
    res.e2e["train_audio_s_per_s"] = audio_samples / SAMPLE_RATE / window
    res.work = {"entry": "train", "cfg": cfg["model"], "trace": summary, "steps": steps}
    if ctx.device.type == "cuda":
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))
    st.model = st.step = st.runner = st.loader = st.chunks = runner = loader = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(ctx, st.weights, st.corpus, st.check_rows)
    readings = readings_of(ref, st.losses, st.first_grad, st.change, st.weights)
    res.checks = [(k, readings[k], ctx.limits[k]) for k in CHECKS]
    return res


def reference_steps(ctx: Context, weights: dict, corpus, check_rows, quant=None, half=False):
    """The reference's three steps on the check rows (``half``: the
    fault that leaves out half of each batch)."""
    from benchmark.lib.reference import TrainReference, no_tf32

    no_tf32()
    mix = ctx.mix
    ref = TrainReference(ctx.cfg["model"], weights, mix["lr"], mix["momentum"], mix["max_norm"],
                         quant=quant)
    index = {ch: i for i, ch in enumerate(ctx.cfg["labels"])}
    for rows in check_rows:
        pcm = [corpus.pcm[e] for e in rows]
        labels = [[index[ch] for ch in corpus.texts[e]] for e in rows]
        ref.step(pcm, labels, rows=list(range(len(rows) // 2)) if half else None)
    return ref


def readings_of(ref, losses: list, first_grad: dict, change: dict, weights: dict) -> dict:
    """A run's readings (``losses``, ``first_grad``, ``change``) against
    the reference ``ref``: the numbers compared (``CHECKS``: the first
    clipped gradient's median and worst leaf, the three steps' change's
    median leaf) and those read beside them: each step's loss gap and
    the change's worst leaves."""
    skip = still_leaves(ref.first_grad)
    ref_change = {n: ref.params[n].detach() - weights[n] for n in ref.params}
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref.losses)]
    grad = leaf_gaps(first_grad, ref.first_grad, skip)
    moved = leaf_gaps(change, ref_change, skip)
    return {
        "loss1_rel_gap": loss_gaps[0],
        "grad1_median_leaf_gap": statistics.median(g for g, _ in grad),
        "change3_median_leaf_gap": statistics.median(g for g, _ in moved),
        "loss_rel_gap": max(loss_gaps), "loss_gaps": loss_gaps,
        "grad1_leaf_gap": grad[0][0], "grad1_worst": grad[:3],
        "change3_leaf_gap": moved[0][0], "change3_worst": moved[:3],
        "skipped_leaves": sorted(skip),
    }


def control_readings(ctx: Context, keep: dict, with_control: bool) -> dict:
    """The readings that the limits are set from, for one seed: the
    program's three check steps against the reference and, with
    ``with_control``, the control (the reference in float8) and the
    fault that leaves out half of each batch, each against the
    reference. A state left unchanged reads 1 on ``change3_leaf_gap``
    by its definition and needs no run."""
    import torch

    st = prepare(ctx)
    st.model = st.step = st.runner = st.loader = st.chunks = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, st.weights, st.corpus, st.check_rows)
    out = {"program": readings_of(ref, st.losses, st.first_grad, st.change, st.weights)}
    if with_control:
        for name, kw in (("control_fp8", {"quant": "fp8"}), ("fault_half_batch", {"half": True})):
            other = reference_steps(ctx, st.weights, st.corpus, st.check_rows, **kw)
            change = {n: other.params[n].detach() - st.weights[n] for n in other.params}
            out[name] = readings_of(ref, other.losses, other.first_grad, change, st.weights)
    return out
