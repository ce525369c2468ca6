"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped): a sound run is correct, and a run whose timed path
is broken underneath is not, once for each fault the cell can have. A
one-chip cell has no exchange between chips to leave out."""

import pytest
import torch

from benchmark.tests import tiny


def run_cell(cell: str, **model):
    ctx = tiny.context(cell, **model)
    return tiny.entry(ctx.mix["entry"]).run(ctx)


@pytest.mark.parametrize("cell", ["ds2_bigru800.train", "ds2_bilstm800.train",
                                  "ds2_bilstm800.serve"])
def test_sound_run_is_correct(cell):
    res = run_cell(cell)
    assert res.correct, res.checks
    assert res.attempted > 0 and res.failed == 0


def test_train_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    res = run_cell("ds2_bigru800.train")
    assert not res.correct
    assert dict((k, v) for k, v, _ in res.checks)["change3_median_leaf_gap"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    import tpuasr_torch.train.step as step

    real = step.batch_loss

    def half(model, frontend_cfg, waves, wave_lengths, labels, label_lengths, valid, *a, **kw):
        valid = torch.as_tensor(valid).clone()
        valid[valid.shape[0] // 2:] = False  # the mean over the first half
        return real(model, frontend_cfg, waves, wave_lengths, labels, label_lengths, valid,
                    *a, **kw)

    monkeypatch.setattr(step, "batch_loss", half)
    assert not run_cell("ds2_bigru800.train").correct


def test_serve_altered_token_is_not_correct(monkeypatch):
    from tpuasr_torch.decode.greedy import GreedyDecoder

    real = GreedyDecoder.decode

    def altered(self, logits, lengths, return_offsets=False):
        texts, offsets = real(self, logits, lengths, return_offsets=True)
        texts = [("Q" if t[:1] != "Q" else "Z") + t[1:] if t else t for t in texts]
        return (texts, offsets) if return_offsets else texts

    monkeypatch.setattr(GreedyDecoder, "decode", altered)
    assert not run_cell("ds2_bilstm800.serve").correct
