"""Launch plans of the fused RNN kernels: the backward (K1b, K4b, K5b,
K6b) and the forward (K1f, K4f, K5f, K6f).

Both run their time loop in one persistent, cooperative launch
(``csrc/rnn_bwd.cuh``, ``csrc/rnn_fwd.cuh``). This module decides the
loops' tiling and is its one source: the C side reads every count and
shared-memory offset from the ``BwdPlan`` or ``FwdPlan`` it is handed
(``as_ints``) and computes none of them itself.

Both loops cut their work into slices of ``UNITS`` hidden units of one
direction. A block owns ``slices_per_block`` consecutive slices (slice s
is direction ``s // (HP / UNITS)``, units ``UNITS * (s % (HP / UNITS))``
on), for every batch row, walking the rows in tiles of ``ROW_TILE``.

The backward (two launches: a tensor-core GEMM that computes hg = h_{t-1}
@ w_h + b_h for every step at once, then the reverse loop; the vanilla
RNN's K6b, one gate, reads the forward's ys instead of hg and runs the
loop alone): a block does
the gate math of its units and, after the step's grid barrier, the carry
product for the same units. In the carry product each of the 8 warps
streams ``warp_ksteps`` k-steps (16 columns each) of the step's dhg from
L2 into registers; dhg is not staged in shared memory. The block's shared
memory holds, in order: the carries it owns (dh, and dc for the LSTM) and
the step's direct term, all f32 (slices x B x UNITS); hg of the step and
of the next one (two buffers of slices x B x n_gates x UNITS f32, none
at one gate); the 8
warps' partial sums (8 x UNITS x ROW_TILE f32); and, with what is left,
the block's rows of w_h (one row per unit, n_gates*H values at the
weights' itemsize, padded to ``w_stride``).

The forward (one launch): per step, after one grid barrier, a block reads
its direction's h_{t-1} from ys[t-1] in L2, multiplies it by its
n_gates x UNITS columns of w_h and does the gate math of its units. Its
shared memory holds, in order: the f32 h_{t-1} of its units (and the
LSTM's f32 c), slices x B x UNITS each; the 8 warps' partial sums of
one row tile (8 x n_gates x ROW_TILE x UNITS f32; each warp multiplies
an eighth of k); and, with what is left, its columns of w_h as rows (one
row per (slice, gate, unit), H values padded to ``w_stride``). At B=32, H=800 the plan fills 100 of the H100's
132 SMs, as the backward's does. The other 32 stay idle: splitting a
slice's gates across blocks would send every gate's hg through L2 behind
a second barrier a step, and splitting its rows, which needs no exchange,
takes 200 blocks for the flagship's 100 slices, more than the card
holds at once.

Rows of w_h beyond ``pinned_rows`` are read from L2 inside the same
kernels. A batch whose state does not fit one block's shared memory
(``max_bwd_rows``, ``max_fwd_rows``) is run in row groups
(``row_groups``): every row's recursion is independent of the others.

Nothing here needs CUDA; ``tests/test_torch_rnn_bwd_plan.py`` and
``tests/test_torch_rnn_fwd_plan.py`` check the plans on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

UNITS = 16        # hidden units per slice: the M of one m16n8k16 product
ROW_TILE = 32     # batch rows per pass of a product: 4 n-tiles of 8
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


def _slicing(D: int, H: int, n_sms: int) -> tuple[int, int, int, int]:
    """(HP, n_slices, slices_per_block, n_blocks): the slices of UNITS
    units of every direction, dealt to at most ``n_sms`` blocks."""
    HP = _round_up(H, UNITS)
    n_slices = D * (HP // UNITS)
    spb = -(-n_slices // n_sms)
    return HP, n_slices, spb, -(-n_slices // spb)


def _bwd_state(spb: int, B: int, n_gates: int) -> dict[str, int]:
    """Bytes of the backward's shared regions before w_h, in their order."""
    state = spb * B * UNITS * 4
    hg = 2 * spb * B * n_gates * UNITS * 4 if n_gates > 1 else 0  # K6b reads ys, not hg
    return {"carry": state, "carry_c": state if n_gates == 4 else 0, "direct": state,
            "hg": hg, "red": NWARPS * UNITS * ROW_TILE * 4}


def _fwd_state(spb: int, B: int, n_gates: int) -> dict[str, int]:
    """Bytes of the forward's shared regions before w_h, in their order."""
    state = spb * B * UNITS * 4
    return {"h": state, "c": state if n_gates == 4 else 0,
            "red": NWARPS * n_gates * UNITS * ROW_TILE * 4}


def _max_rows(state, spb: int, n_gates: int, smem_per_block: int) -> int:
    """The largest B whose ``state`` (bytes linear in B, each region a
    multiple of 16) fits ``smem_per_block``; 0 if none."""
    fixed = sum(state(spb, 0, n_gates).values())
    per_row = sum(state(spb, 1, n_gates).values()) - fixed
    return max(0, (smem_per_block - fixed) // per_row)


def _check(kind: str, D: int, B: int, H: int, n_gates: int, itemsize: int, n_sms: int):
    if D < 1 or B < 1 or H < 1 or n_gates not in (1, 3, 4) or itemsize not in (2, 4):
        raise ValueError(f"no {kind} plan for D={D} B={B} H={H} "
                         f"n_gates={n_gates} itemsize={itemsize}")
    if n_sms < 1:
        raise ValueError(f"n_sms must be positive, got {n_sms}")


def rnn_bwd_plan(D: int, B: int, H: int, n_gates: int, itemsize: int, n_sms: int,
                 smem_per_block: int) -> BwdPlan:
    """The plan for direction count D, batch B, hidden H, ``n_gates``
    (1: vanilla tanh RNN, 3: GRU, 4: LSTM) and weights of ``itemsize``
    bytes (2: bf16, 4: f32) on a card of ``n_sms`` SMs with
    ``smem_per_block`` bytes of opt-in shared memory a block. One block per SM at most, so the
    cooperative launch is co-resident. Raises ValueError when the
    carries do not fit (B past ``max_bwd_rows``)."""
    _check("backward", D, B, H, n_gates, itemsize, n_sms)
    HP, n_slices, spb, n_blocks = _slicing(D, H, n_sms)
    GP = _round_up(n_gates * H, 16)
    sizes = _bwd_state(spb, B, n_gates)
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


def max_bwd_rows(D: int, H: int, n_gates: int, itemsize: int, n_sms: int,
                 smem_per_block: int) -> int:
    """The largest batch for which ``rnn_bwd_plan`` does not raise."""
    _check("backward", D, 1, H, n_gates, itemsize, n_sms)
    return _max_rows(_bwd_state, _slicing(D, H, n_sms)[2], n_gates, smem_per_block)


def row_groups(B: int, max_rows: int) -> list[tuple[int, int]]:
    """[start, stop) of consecutive row groups of at most ``max_rows``
    that cover rows 0 .. B - 1 once, as even as they can be."""
    if max_rows < 1:
        raise ValueError("no row of this batch fits a block's shared memory")
    n = -(-B // max_rows)
    edges = [B * i // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def fwd_weight_stride(k_padded: int, itemsize: int) -> int:
    """Elements per pinned w_h row of the forward: at least ``k_padded``
    (a multiple of 32). bf16: a stride of 32 mod 64 elements, so that the
    two rows of a quarter warp's 16-byte A-fragment loads (4 lanes x 16
    bytes each) fall on disjoint banks; f32: an odd stride, so that the 16
    units' rows read at one column by the FMA path fall on distinct
    banks."""
    if itemsize == 2:
        return k_padded + (32 - k_padded) % 64
    return k_padded + (1 - k_padded) % 32


@dataclass(frozen=True)
class FwdPlan:
    """The forward loop's tiling for one (D, B, H, n_gates, dtype)."""

    D: int
    B: int
    H: int
    n_gates: int
    itemsize: int
    HP: int               # H rounded up to UNITS
    KP: int               # H rounded up to 32: the columns of whole chunks
    n_slices: int
    slices_per_block: int
    n_blocks: int
    w_stride: int         # elements per pinned w_h row
    pinned_rows: int      # block-local rows of w_h kept in shared memory
    off_h: int            # byte offsets into dynamic shared memory
    off_c: int
    off_red: int
    off_w: int
    smem_bytes: int

    def as_ints(self) -> list[int]:
        """The fields the C side reads, in its ``FwdLayout`` order."""
        return [self.n_blocks, self.slices_per_block, self.n_slices, self.pinned_rows,
                self.w_stride, self.off_h, self.off_c, self.off_red, self.off_w,
                self.smem_bytes, self.HP, self.KP]


def rnn_fwd_plan(D: int, B: int, H: int, n_gates: int, itemsize: int, n_sms: int,
                 smem_per_block: int) -> FwdPlan:
    """The forward plan for direction count D, batch B, hidden H,
    ``n_gates`` (1: vanilla tanh RNN, 3: GRU, 4: LSTM) and weights of
    ``itemsize`` bytes on a card of ``n_sms`` SMs with ``smem_per_block``
    bytes of opt-in shared memory a block. One block per SM at most, so the cooperative launch
    is co-resident. Raises ValueError when the state of B rows does not
    fit (``max_fwd_rows``)."""
    _check("forward", D, B, H, n_gates, itemsize, n_sms)
    HP, n_slices, spb, n_blocks = _slicing(D, H, n_sms)
    KP = _round_up(H, 32)
    sizes = _fwd_state(spb, B, n_gates)
    fixed = sum(sizes.values())
    if fixed > smem_per_block:
        raise ValueError(f"the forward's state for B={B} does not fit in "
                         f"{smem_per_block} bytes of shared memory")
    ws = fwd_weight_stride(KP, itemsize)
    row_bytes = ws * itemsize
    pinned = min(spb * n_gates * UNITS, (smem_per_block - fixed) // row_bytes)
    offs, at = {}, 0
    for name, size in (*sizes.items(), ("w", pinned * row_bytes)):
        offs[name] = at
        at += _round_up(size, 16)
    return FwdPlan(D=D, B=B, H=H, n_gates=n_gates, itemsize=itemsize, HP=HP, KP=KP,
                   n_slices=n_slices, slices_per_block=spb, n_blocks=n_blocks,
                   w_stride=ws, pinned_rows=pinned, off_h=offs["h"], off_c=offs["c"],
                   off_red=offs["red"], off_w=offs["w"], smem_bytes=at)


def max_fwd_rows(D: int, H: int, n_gates: int, itemsize: int, n_sms: int,
                 smem_per_block: int) -> int:
    """The largest batch for which ``rnn_fwd_plan`` does not raise."""
    _check("forward", D, 1, H, n_gates, itemsize, n_sms)
    return _max_rows(_fwd_state, _slicing(D, H, n_sms)[2], n_gates, smem_per_block)
