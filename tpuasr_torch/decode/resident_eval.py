"""Whole-corpus evaluation over a device-resident corpus (port of
``tpuasr/decode/resident_eval.py``).

The reference's test.py loops host batches through the GPU one at a
time. Here the corpus sits in device memory (``data.resident``) and each
bucket's schedule runs as one chunk: forward and decode for every row on
the device, one copy of the indices in and one read-back out, the host
only assembling strings and scoring.

Decoders: ``GreedyDecoder`` and ``DeviceBeamDecoder`` (K3 takes every
beam width, class count and LM mode, so any device beam runs here);
other decoders (the host beam) use the per-batch loop.
"""

from __future__ import annotations

import torch

from tpuasr_torch.audio.frontend import FrontendConfig


def supports_resident_eval(decoder) -> bool:
    """Can ``ResidentEvaluator`` drive this decoder? Unlike the JAX
    package's, no beam width, class count or batch size keeps a device
    beam off this path."""
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.greedy import GreedyDecoder

    return isinstance(decoder, (GreedyDecoder, DeviceBeamDecoder))


class ResidentEvaluator:
    """Evaluation of ``model`` over a ``ResidentBatchLoader``'s corpus,
    one chunk per bucket.

    Usage::

        ev = ResidentEvaluator(model, frontend_cfg, decoder)
        for hyp, ref in ev.pairs(resident_loader):
            meter.update(hyp, ref)

    Hypotheses are the decoder's own: ``decoder.decode`` gives the same
    strings on the same logits."""

    def __init__(self, model, frontend_cfg: FrontendConfig, decoder):
        from tpuasr_torch.decode.beam import DeviceBeamDecoder
        from tpuasr_torch.decode.greedy import GreedyDecoder
        from tpuasr_torch.train.step import (
            make_resident_beam_eval_runner,
            make_resident_eval_runner,
        )

        self.decoder = decoder
        device = next(model.parameters()).device
        if isinstance(decoder, GreedyDecoder):
            self._runner = make_resident_eval_runner(model, frontend_cfg,
                                                     blank_id=decoder.alphabet.blank_id)
            self._mode = "greedy"
        elif isinstance(decoder, DeviceBeamDecoder):
            cfg = decoder.cfg
            self._n_classes = model.config.n_classes
            self._runner = make_resident_beam_eval_runner(
                model, frontend_cfg, beam_width=cfg.beam_width, blank_id=cfg.blank_id,
                cutoff_top_n=cfg.cutoff_top_n, cutoff_prob=cfg.cutoff_prob,
                prune_logp=cfg.prune_logp,
                **decoder.kernel_lm_kwargs(self._n_classes, device))
            self._mode = "beam"
        else:
            raise TypeError(f"no resident eval path for {type(decoder).__name__}")

    def hyps(self, loader, epoch: int = 0):
        """Yield (manifest index, hypothesis) over the loader's corpus."""
        from tpuasr_torch.decode.beam import _backtrack

        for _, bank, idx_mat, n_valid, _ in loader.bucket_chunks(epoch):
            row_to_entry = {v: k for k, v in bank.rows.items()}
            k_rows, b = idx_mat.shape
            if self._mode == "greedy":
                ids, emit, _ = self._runner(bank, idx_mat)
                picked = torch.where(emit, ids, -1).cpu().numpy()  # the one read-back
                for k in range(k_rows):
                    for j in range(int(n_valid[k])):
                        row = picked[k, j]
                        hyp = self.decoder.alphabet.decode(row[row >= 0])
                        yield row_to_entry[int(idx_mat[k, j])], hyp
            else:
                parents, chars, scores = self._runner(bank, idx_mat)
                host = self.decoder.to_host(parents.flatten(0, 1), chars.flatten(0, 1),
                                            scores.flatten(0, 1), self._n_classes)
                store, toff, blen, _ = _backtrack(*host)
                for k in range(k_rows):
                    for j in range(int(n_valid[k])):
                        r = k * b + j
                        hyp, _ = self.decoder.readout(store[r, 0], toff[r, 0], blen[r, 0])
                        yield row_to_entry[int(idx_mat[k, j])], hyp

    def pairs(self, loader, epoch: int = 0):
        """Yield (hypothesis, reference transcript) per utterance."""
        texts = loader.texts
        for i, hyp in self.hyps(loader, epoch):
            yield hyp, texts[i]

