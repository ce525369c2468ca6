"""Training entry of the vanilla RNN cell (``ds2_birnn1280.train_rnn``):
the train entry (``entries/train.py``) as it is, its set-up, check
steps, window and readings, with this cell's reference
(``lib/reference_rnn.py``) in place of ``lib/reference.py``, which knows
only the GRU and the LSTM.

The train entry is loaded from its file as a module of this entry's own,
and only that copy's ``reference_steps`` is replaced, so the train entry
runs unchanged wherever else it is loaded.

Set-up fails at once, before the corpus is made, where the program has
no vanilla RNN kernel (``tpuasr_torch.ops.birnn``): its plain loop would
take minutes a step at these shapes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchmark.lib.harness import Context, Result

_spec = importlib.util.spec_from_file_location("benchmark_entry_train_of_train_rnn",
                                               Path(__file__).with_name("train.py"))
train = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(train)


def reference_steps(ctx: Context, weights: dict, corpus, check_rows, quant=None, half=False):
    """``train.reference_steps`` on ``lib/reference_rnn.py``: the
    reference's three steps on the check rows (``half``: the fault that
    leaves out half of each batch; ``quant="fp8"``: the control)."""
    from benchmark.lib.reference_rnn import TrainReference, no_tf32

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


train.reference_steps = reference_steps


def _needs_the_kernel() -> None:
    import tpuasr_torch.ops.birnn  # noqa: F401 (K6f/K6b; raises on a program without them)


def run(ctx: Context) -> Result:
    _needs_the_kernel()
    return train.run(ctx)


def control_readings(ctx: Context, keep: dict, with_control: bool) -> dict:
    _needs_the_kernel()
    return train.control_readings(ctx, keep, with_control)
