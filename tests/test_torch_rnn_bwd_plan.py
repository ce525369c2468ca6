"""The launch plan of the fused RNN backward kernels
(``tpuasr_torch/ops/rnn_plan.py``), on the CPU: no GPU, no JAX. The
plan is the one source of the persistent loop's tiling, so what the
kernel relies on is checked here: each (direction, unit) has one owner
block, the grid fits the card (one block per SM, so the cooperative
launch is co-resident), the shared memory fits a block, and the weights
are pinned where they fit and read from L2 where they do not.
"""

import re
from pathlib import Path

import pytest

from tpuasr_torch.ops import rnn_plan
from tpuasr_torch.ops.rnn_plan import UNITS, rnn_bwd_plan

N_SMS = 132  # an H100 SXM
SMEM = 232448  # opt-in shared memory a block, H100
HS = (16, 100, 800, 1760)
BS = (1, 9, 32, 33, 96)


def _regions(plan):
    """(offset, bytes) of each shared-memory region, in order."""
    state = plan.slices_per_block * plan.B * UNITS * 4
    return [
        (plan.off_carry, state),
        (plan.off_carry_c, state if plan.n_gates == 4 else 0),
        (plan.off_direct, state),
        (plan.off_hg, 2 * plan.slices_per_block * plan.B * plan.n_gates * UNITS * 4
         if plan.n_gates > 1 else 0),  # the vanilla RNN's K6b reads ys, not hg
        (plan.off_red, rnn_plan.NWARPS * UNITS * rnn_plan.ROW_TILE * 4),
        (plan.off_w, plan.pinned_rows * plan.w_stride * plan.itemsize),
    ]


@pytest.mark.parametrize("n_gates", [1, 3, 4], ids=["rnn", "gru", "lstm"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_plan_owns_every_unit_once_and_fits_the_card(n_gates, itemsize):
    for nd in (1, 2):
        for h in HS:
            for b in BS:
                plan = rnn_bwd_plan(nd, b, h, n_gates, itemsize, N_SMS, SMEM)
                per_dir = plan.HP // UNITS
                owners = {}
                for blk in range(plan.n_blocks):
                    first = blk * plan.slices_per_block
                    for s in range(first, min(first + plan.slices_per_block, plan.n_slices)):
                        d, j0 = divmod(s, per_dir)
                        for j in range(j0 * UNITS, j0 * UNITS + UNITS):
                            owners.setdefault((d, j), []).append(blk)
                want = {(d, j) for d in range(nd) for j in range(h)}
                assert want <= set(owners), (nd, h, b)
                assert all(len(owners[k]) == 1 for k in want), (nd, h, b)
                assert plan.n_blocks <= N_SMS
                assert plan.smem_bytes <= SMEM
                at = 0
                for off, size in _regions(plan):  # in order, aligned, disjoint
                    assert off % 16 == 0 and off >= at
                    at = off + size
                assert at <= plan.smem_bytes
                assert 0 <= plan.pinned_rows <= plan.slices_per_block * UNITS
                # the 8 warps' column ranges cover dhg's padded row
                assert plan.warp_ksteps * rnn_plan.NWARPS * 16 >= plan.GP >= n_gates * h
                assert plan.HP % UNITS == 0 and plan.GP % 16 == 0


@pytest.mark.parametrize("n_gates,h,blocks,spb", [(3, 800, 100, 1), (4, 800, 100, 1),
                                                  (1, 1280, 80, 2)], ids=["gru", "lstm", "rnn"])
def test_flagship_pins_every_weight_row(n_gates, h, blocks, spb):
    """D=2, B=32, bf16. H=800: 100 blocks, each with its 16 rows of w_h
    in shared memory (76.8 KB for the GRU, 102.4 KB for the LSTM). The
    vanilla RNN at H=1280: 160 slices, two a block, 80 blocks, each with
    its 32 rows of w_h (82 KB) and no hg buffers."""
    plan = rnn_bwd_plan(2, 32, h, n_gates, 2, N_SMS, SMEM)
    assert plan.n_slices == 2 * h // UNITS
    assert plan.n_blocks == blocks and plan.slices_per_block == spb
    assert plan.pinned_rows == spb * UNITS
    assert spb * UNITS * n_gates * h * 2 <= plan.pinned_rows * plan.w_stride * 2
    assert (plan.off_red == plan.off_hg) == (n_gates == 1)


@pytest.mark.parametrize("n_gates", [3, 4], ids=["gru", "lstm"])
def test_wide_layers_read_the_overflow_from_l2(n_gates):
    """H=1760: 220 slices on 132 SMs, two a block; their 32 rows of w_h
    do not fit beside the carries, so part of them stays in L2."""
    plan = rnn_bwd_plan(2, 32, 1760, n_gates, 2, N_SMS, SMEM)
    assert plan.slices_per_block == 2 and plan.n_blocks == 110
    assert 0 < plan.pinned_rows < 2 * UNITS
    assert plan.smem_bytes <= SMEM


def test_plan_sizes_the_grid_to_the_card():
    small = rnn_bwd_plan(2, 32, 800, 3, 2, n_sms=40, smem_per_block=SMEM)
    assert small.n_blocks <= 40 and small.slices_per_block == 3
    assert rnn_bwd_plan(2, 32, 800, 3, 2, N_SMS, 100_000).pinned_rows < UNITS


def test_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="do not fit"):
        rnn_bwd_plan(2, 4096, 800, 4, 2, N_SMS, SMEM)
    for n_gates in (2, 5):
        with pytest.raises(ValueError):
            rnn_bwd_plan(2, 32, 800, n_gates, 2, N_SMS, SMEM)
    with pytest.raises(ValueError):
        rnn_bwd_plan(2, 32, 800, 3, 2, 0, SMEM)


def test_plan_fields_match_the_c_layout():
    """as_ints() fills the C side's BwdLayout field by field."""
    src = (Path(rnn_plan.__file__).parent / "csrc" / "rnn_bwd.cuh").read_text()
    body = re.search(r"struct BwdLayout \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip() for decl in re.findall(r"int ([^;]+);", body) for f in decl.split(",")]
    plan = rnn_bwd_plan(2, 32, 800, 3, 2, N_SMS, SMEM)
    assert len(fields) == len(plan.as_ints()) == 15
    assert fields[:4] == ["n_blocks", "spb", "n_slices", "pinned"]
    assert fields[-2:] == ["HP", "GP"]
