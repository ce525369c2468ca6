"""Launch plan of the fused RNN backward kernels (K1b, K4b, K5b).

The backward runs in two launches (``csrc/rnn_bwd.cuh``): one tensor-core
GEMM that computes hg = h_{t-1} @ w_h + b_h for every step at once, and
one persistent, cooperative launch for the reverse time loop. This
module decides the loop's tiling and is its one source: the C side reads
every count and shared-memory offset from the ``BwdPlan`` it is handed
(``BwdPlan.as_ints``) and computes none of them itself.

The loop's work is cut into slices of ``UNITS`` hidden units of one
direction. A block owns ``slices_per_block`` consecutive slices (slice s
is direction ``s // (HP / UNITS)``, units ``UNITS * (s % (HP / UNITS))``
on), for every batch row: it does the gate math of its units, and, after
the step's grid barrier, the carry product for the same units, walking
the rows in tiles of ``ROW_TILE``. In the carry product each of the 8
warps streams ``warp_ksteps`` k-steps (16 columns each) of the step's
dhg from L2 into registers; dhg is not staged in shared memory. The
block's shared memory holds, in order: the carries it owns (dh, and dc
for the LSTM) and the step's direct term, all f32 (slices x B x UNITS);
hg of the step and of the next one (two buffers of slices x B x n_gates
x UNITS f32); the 8 warps' partial sums (8 x UNITS x ROW_TILE f32); and,
with what is left, the block's rows of w_h (one row per unit, n_gates*H
values at the weights' itemsize, padded to ``w_stride``). Rows beyond
``pinned_rows`` are read from L2 inside the same kernel.

Nothing here needs CUDA; ``tests/test_torch_rnn_bwd_plan.py`` checks the
plan on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

UNITS = 16        # hidden units per slice: the M of one m16n8k16 product
ROW_TILE = 32     # batch rows per carry-product pass: 4 n-tiles of 8
NTHREADS = 256    # threads per block (8 warps)
NWARPS = NTHREADS // 32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def weight_stride(g_padded: int, itemsize: int) -> int:
    """Elements per pinned w_h row: at least ``g_padded``, and a stride
    whose 32-bit words fall on distinct banks for the 8 rows x 4 words
    of an m16n8k16 A fragment (bf16: 8 mod 64 elements; f32: 4 mod
    32)."""
    if itemsize == 2:
        return g_padded + (8 - g_padded) % 64
    return g_padded + (4 - g_padded) % 32


@dataclass(frozen=True)
class BwdPlan:
    """The persistent loop's tiling for one (D, B, H, n_gates, dtype)."""

    D: int
    B: int
    H: int
    n_gates: int
    itemsize: int
    HP: int               # H rounded up to UNITS (hg's padded unit axis)
    GP: int               # n_gates*H rounded up to 16 (dhg's padded row)
    n_slices: int
    slices_per_block: int
    n_blocks: int
    warp_ksteps: int      # k-steps of the carry product a warp streams
    w_stride: int         # elements per pinned w_h row
    pinned_rows: int      # block-local rows of w_h kept in shared memory
    off_carry: int        # byte offsets into dynamic shared memory
    off_carry_c: int
    off_direct: int
    off_hg: int
    off_red: int
    off_w: int
    smem_bytes: int

    def as_ints(self) -> list[int]:
        """The fields the C side reads, in its ``BwdLayout`` order."""
        return [self.n_blocks, self.slices_per_block, self.n_slices, self.pinned_rows,
                self.warp_ksteps, self.w_stride, self.off_carry, self.off_carry_c,
                self.off_direct, self.off_hg, self.off_red, self.off_w, self.smem_bytes,
                self.HP, self.GP]


def rnn_bwd_plan(D: int, B: int, H: int, n_gates: int, itemsize: int, n_sms: int,
                 smem_per_block: int) -> BwdPlan:
    """The plan for direction count D, batch B, hidden H, ``n_gates``
    (3: GRU, 4: LSTM) and weights of ``itemsize`` bytes (2: bf16, 4:
    f32) on a card of ``n_sms`` SMs with ``smem_per_block`` bytes of
    opt-in shared memory a block. One block per SM at most, so the
    cooperative launch is co-resident. Raises ValueError when the
    carries do not fit (very large B)."""
    if D < 1 or B < 1 or H < 1 or n_gates not in (3, 4) or itemsize not in (2, 4):
        raise ValueError(f"no backward plan for D={D} B={B} H={H} "
                         f"n_gates={n_gates} itemsize={itemsize}")
    if n_sms < 1:
        raise ValueError(f"n_sms must be positive, got {n_sms}")
    HP = _round_up(H, UNITS)
    GP = _round_up(n_gates * H, 16)
    n_slices = D * (HP // UNITS)
    spb = -(-n_slices // n_sms)
    n_blocks = -(-n_slices // spb)
    state = spb * B * UNITS * 4
    sizes = {"carry": state, "carry_c": state if n_gates == 4 else 0, "direct": state,
             "hg": 2 * spb * B * n_gates * UNITS * 4}
    sizes["red"] = NWARPS * UNITS * ROW_TILE * 4
    fixed = sum(sizes.values())
    if fixed > smem_per_block:
        raise ValueError(f"the backward's carries for B={B} do not fit in "
                         f"{smem_per_block} bytes of shared memory")
    ws = weight_stride(GP, itemsize)
    row_bytes = ws * itemsize
    pinned = min(spb * UNITS, (smem_per_block - fixed) // row_bytes)
    offs, at = {}, 0
    for name, size in (*sizes.items(), ("w", pinned * row_bytes)):
        offs[name] = at
        at += _round_up(size, 16)
    return BwdPlan(D=D, B=B, H=H, n_gates=n_gates, itemsize=itemsize, HP=HP, GP=GP,
                   n_slices=n_slices, slices_per_block=spb, n_blocks=n_blocks,
                   warp_ksteps=-(-GP // 16 // NWARPS), w_stride=ws, pinned_rows=pinned,
                   off_carry=offs["carry"], off_carry_c=offs["carry_c"],
                   off_direct=offs["direct"], off_hg=offs["hg"],
                   off_red=offs["red"], off_w=offs["w"],
                   smem_bytes=at)
