"""The launch plan of the fused RNN forward kernels and the row groups of
both directions (``tpuasr_torch/ops/rnn_plan.py``), on the CPU: no GPU,
no JAX. The plan is the one source of the persistent forward loop's
tiling, so what the kernel relies on is checked here: each (direction,
unit) has one owner block, the grid fits the card (one block per SM, so
the cooperative launch is co-resident), the shared memory fits a block,
the weights are pinned where they fit and read from L2 where they do
not, and a batch past one plan's limit is split into row groups that
cover every row once.
"""

import re
from pathlib import Path

import pytest

from tpuasr_torch.ops import rnn_plan
from tpuasr_torch.ops.rnn_plan import (
    ROW_TILE,
    UNITS,
    max_bwd_rows,
    max_fwd_rows,
    rnn_bwd_plan,
    rnn_fwd_plan,
    row_groups,
)

N_SMS = 132  # an H100 SXM
SMEM = 232448  # opt-in shared memory a block, H100
HS = (8, 16, 100, 800, 1760)
BS = (1, 9, 32, 33, 96, 448)


def _regions(plan):
    """(offset, bytes) of each shared-memory region, in order."""
    state = plan.slices_per_block * plan.B * UNITS * 4
    return [
        (plan.off_h, state),
        (plan.off_c, state if plan.n_gates == 4 else 0),
        (plan.off_red, rnn_plan.NWARPS * plan.n_gates * UNITS * ROW_TILE * 4),
        (plan.off_w, plan.pinned_rows * plan.w_stride * plan.itemsize),
    ]


@pytest.mark.parametrize("n_gates", [1, 3, 4], ids=["rnn", "gru", "lstm"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_plan_owns_every_unit_once_and_fits_the_card(n_gates, itemsize):
    for nd in (1, 2):
        for h in HS:
            for b in BS:
                plan = rnn_fwd_plan(nd, b, h, n_gates, itemsize, N_SMS, SMEM)
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
                assert 0 <= plan.pinned_rows <= plan.slices_per_block * n_gates * UNITS
                # whole 32-column chunks cover k; the pinned rows are 16-byte aligned
                assert plan.KP % 32 == 0 and h <= plan.KP < h + 32
                assert plan.w_stride >= plan.KP
                assert itemsize == 4 or plan.w_stride * itemsize % 16 == 0
                assert plan.HP % UNITS == 0


@pytest.mark.parametrize("n_gates", [1, 3, 4], ids=["rnn", "gru", "lstm"])
def test_weight_rows_avoid_bank_conflicts(n_gates):
    """bf16: two rows of a quarter warp's 16-byte loads 64 bytes apart mod
    128; f32: the 16 units' rows at one column on distinct banks."""
    for h in HS:
        bf = rnn_fwd_plan(2, 32, h, n_gates, 2, N_SMS, SMEM)
        assert bf.w_stride * 2 % 128 == 64
        f32 = rnn_fwd_plan(2, 32, h, n_gates, 4, N_SMS, SMEM)
        assert len({u * f32.w_stride % 32 for u in range(UNITS)}) == UNITS


@pytest.mark.parametrize("n_gates,h,blocks,spb,ws", [(3, 800, 100, 1, 800),
                                                     (4, 800, 100, 1, 800),
                                                     (1, 1280, 80, 2, 1312)],
                         ids=["gru", "lstm", "rnn"])
def test_flagship_pins_every_weight_row(n_gates, h, blocks, spb, ws):
    """D=2, B=32, bf16. H=800: 100 blocks, each with its n_gates x 16
    columns of w_h in shared memory, rows unpadded (76.8 KB for the GRU,
    102.4 KB for the LSTM). The vanilla RNN at H=1280: 160 slices, two a
    block, 80 blocks, each with its 2 x 16 columns in rows padded to 1312
    (84 KB)."""
    plan = rnn_fwd_plan(2, 32, h, n_gates, 2, N_SMS, SMEM)
    assert plan.n_slices == 2 * h // UNITS
    assert plan.n_blocks == blocks and plan.slices_per_block == spb
    assert plan.pinned_rows == spb * n_gates * UNITS
    assert plan.w_stride == ws
    assert plan.pinned_rows * plan.w_stride * 2 == spb * n_gates * UNITS * ws * 2 <= SMEM


@pytest.mark.parametrize("n_gates", [3, 4], ids=["gru", "lstm"])
def test_wide_and_f32_layers_read_the_overflow_from_l2(n_gates):
    """H=1760: 220 slices on 132 SMs, two a block, whose rows of w_h do
    not fit; f32 weights fit the GRU at H=800, not the LSTM, and
    neither at H=1760."""
    wide = rnn_fwd_plan(2, 32, 1760, n_gates, 2, N_SMS, SMEM)
    assert wide.slices_per_block == 2 and wide.n_blocks == 110
    assert 0 < wide.pinned_rows < 2 * n_gates * UNITS
    assert wide.smem_bytes <= SMEM
    f32 = rnn_fwd_plan(2, 32, 800, n_gates, 4, N_SMS, SMEM)
    assert (f32.pinned_rows == n_gates * UNITS) == (n_gates == 3)
    f32_wide = rnn_fwd_plan(2, 32, 1760, n_gates, 4, N_SMS, SMEM)
    assert f32_wide.pinned_rows < 2 * n_gates * UNITS


def test_plan_sizes_the_grid_to_the_card():
    small = rnn_fwd_plan(2, 32, 800, 3, 2, n_sms=40, smem_per_block=SMEM)
    assert small.n_blocks <= 40 and small.slices_per_block == 3
    assert rnn_fwd_plan(2, 32, 800, 3, 2, N_SMS, 60_000).pinned_rows < 3 * UNITS


def test_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="do not fit|does not fit"):
        rnn_fwd_plan(2, 8192, 800, 4, 2, N_SMS, SMEM)
    for n_gates in (2, 5):
        with pytest.raises(ValueError):
            rnn_fwd_plan(2, 32, 800, n_gates, 2, N_SMS, SMEM)
    with pytest.raises(ValueError):
        rnn_fwd_plan(2, 32, 800, 3, 2, 0, SMEM)


def test_plan_fields_match_the_c_layout():
    """as_ints() fills the C side's FwdLayout field by field."""
    src = (Path(rnn_plan.__file__).parent / "csrc" / "rnn_fwd.cuh").read_text()
    body = re.search(r"struct FwdLayout \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip() for decl in re.findall(r"int ([^;]+);", body) for f in decl.split(",")]
    plan = rnn_fwd_plan(2, 32, 800, 3, 2, N_SMS, SMEM)
    assert len(fields) == len(plan.as_ints()) == 12
    names = {"n_blocks": "n_blocks", "spb": "slices_per_block", "n_slices": "n_slices",
             "pinned": "pinned_rows", "ws": "w_stride", "off_h": "off_h", "off_c": "off_c",
             "off_red": "off_red", "off_w": "off_w", "smem": "smem_bytes", "HP": "HP",
             "KP": "KP"}
    assert [getattr(plan, names[f]) for f in fields] == plan.as_ints()


@pytest.mark.parametrize("case", [
    ("gru", 800, 3, 422), ("lstm", 800, 4, 306), ("gru", 1760, 3, 211), ("lstm", 1760, 4, 153),
    ("rnn", 1280, 1, 844),
], ids=lambda c: f"{c[0]}-{c[1]}" if isinstance(c, tuple) else None)
def test_max_bwd_rows_is_the_bound_the_plan_raises_at(case):
    """The backward's largest batch on an H100, bf16: one more row and a
    single plan refuses (its carries do not fit)."""
    _, h, n_gates, want = case
    got = max_bwd_rows(2, h, n_gates, 2, N_SMS, SMEM)
    assert got == want
    rnn_bwd_plan(2, got, h, n_gates, 2, N_SMS, SMEM)
    with pytest.raises(ValueError, match="do not fit"):
        rnn_bwd_plan(2, got + 1, h, n_gates, 2, N_SMS, SMEM)


@pytest.mark.parametrize("n_gates", [1, 3, 4], ids=["rnn", "gru", "lstm"])
def test_max_fwd_rows_is_the_bound_the_plan_raises_at(n_gates):
    for h in (800, 1280, 1760):
        got = max_fwd_rows(2, h, n_gates, 2, N_SMS, SMEM)
        assert got >= 512  # far past any serving or training batch
        rnn_fwd_plan(2, got, h, n_gates, 2, N_SMS, SMEM)
        with pytest.raises(ValueError, match="does not fit"):
            rnn_fwd_plan(2, got + 1, h, n_gates, 2, N_SMS, SMEM)


@pytest.mark.parametrize("n_gates", [3, 4], ids=["gru", "lstm"])
def test_row_groups_cover_every_row_once_at_b1024(n_gates):
    """B=1024 at H=800 bf16: past the backward's one-plan limit, so its
    rows go in groups, each held by a plan; the forward takes it whole."""
    b = 1024
    limit = max_bwd_rows(2, 800, n_gates, 2, N_SMS, SMEM)
    groups = row_groups(b, limit)
    assert len(groups) == -(-b // limit) > 1
    rows = [r for b0, b1 in groups for r in range(b0, b1)]
    assert rows == list(range(b))
    for b0, b1 in groups:
        assert 0 < b1 - b0 <= limit
        rnn_bwd_plan(2, b1 - b0, 800, n_gates, 2, N_SMS, SMEM)
    assert row_groups(b, max_fwd_rows(2, 800, n_gates, 2, N_SMS, SMEM)) == [(0, b)]
    assert row_groups(5, 5) == [(0, 5)] and row_groups(7, 3) == [(0, 2), (2, 4), (4, 7)]
    with pytest.raises(ValueError):
        row_groups(3, 0)
