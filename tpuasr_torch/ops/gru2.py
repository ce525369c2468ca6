"""Fused bidirectional GRU time loop, gate-major layout (port of
``tpuasr/ops/gru2.py``).

The math is ``tpuasr_torch.ops.gru``'s (K1) exactly; only the layout
differs: every gate is its own (B, H) plane. xg (T, D, 3, B, H), w_h
(D, 3, H, H) with ``w_h[d, g, k, j]``, b_h (D, 3, H), mask (T, D, B),
direction 1 time-flipped by the caller.

``bigru2_forward`` wraps the hand-written Hopper kernel
``csrc/bigru2_fwd.cu`` (one persistent launch a call, replacing ``tpuasr/ops/gru2.py:_fwd_kernel``);
``bigru2_reference`` is its plain PyTorch version. ``bigru2_backward``
wraps ``csrc/bigru2_bwd.cu`` (replacing ``tpuasr/ops/gru2.py:_bwd_kernel``):
dg (T, D, 4, B, H) = [dr_pre, dz_pre, dn_pre, dhn] * m in xg's dtype;
``bigru2_backward_reference`` is its plain version. ``BiGRU2Function``
is the autograd function around both. The kernels run K1's compiled
body with gate-major strides, so on the same weights they equal K1's
bit for bit.

The wrappers use the plain versions only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops.gru import (
    BWD_LAUNCHES,
    check_inputs,
    check_states,
    rnn_weight_grads,
    run_backward,
    run_forward,
    shift_time,
)


def _hg(h: torch.Tensor, w: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """Per-gate recurrent products in f32: (D, B, H) x (D, 3, H, H) ->
    (D, 3, B, H), plus b_h."""
    nd, b, h_dim = h.shape
    hg = torch.bmm(h[:, None].expand(nd, 3, b, h_dim).reshape(nd * 3, b, h_dim),
                   w.reshape(nd * 3, h_dim, h_dim))
    return hg.reshape(nd, 3, b, h_dim) + bh


def bigru2_reference(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch time loop; the oracle of the kernel.

    Args:
      xg: (T, D, 3, B, H) gate-major input projections, f32 or bf16.
      w_h: (D, 3, H, H) recurrent weights (used at xg's dtype).
      b_h: (D, 3, H) recurrent bias (used in f32).
      mask: (T, D, B) per-direction validity.
    Returns:
      ys: (T, D, B, H) in xg's dtype; padded frames hold the carried h.
    """
    dt = xg.dtype
    t_len, nd, _, b, h_dim = xg.shape
    w = w_h.to(dt).to(torch.float32)  # bf16 products are exact in f32
    bh = b_h.to(torch.float32)[:, :, None, :]
    h = xg.new_zeros((nd, b, h_dim))
    ys = xg.new_empty((t_len, nd, b, h_dim))
    for t in range(t_len):
        hf = h.to(torch.float32)
        xr, xz, xn = xg[t].to(torch.float32).unbind(1)
        hr, hz, hn = _hg(hf, w, bh).unbind(1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * hf
        m = mask[t].to(torch.float32)[:, :, None]
        h = (m * h_new + (1.0 - m) * hf).to(dt)
        ys[t] = h
    return ys


def bigru2_backward_reference(xg: torch.Tensor, w_h: torch.Tensor,
                              b_h: torch.Tensor, mask: torch.Tensor,
                              h_prev: torch.Tensor,
                              dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reverse-time loop with ``_bwd_kernel``'s numerics
    (K1b's: gates recomputed from h_prev, dL/dh carried in f32, the
    product with w_h^T from the unrounded [dr_pre, dz_pre, dhn], dh passed
    through masked frames).

    Args as ``bigru2_reference``, plus h_prev (the forward's ys shifted
    one step later) and dy, (T, D, B, H) in xg's dtype.
    Returns dg (T, D, 4, B, H) = [dr_pre, dz_pre, dn_pre, dhn] * m,
    rounded to xg's dtype.
    """
    dt = xg.dtype
    t_len, nd, _, b, h_dim = xg.shape
    w = w_h.to(dt).to(torch.float32)
    bh = b_h.to(torch.float32)[:, :, None, :]
    dh_c = torch.zeros((nd, b, h_dim), dtype=torch.float32, device=xg.device)
    dg = xg.new_empty((t_len, nd, 4, b, h_dim))
    for t in reversed(range(t_len)):
        hp = h_prev[t].to(torch.float32)
        xr, xz, xn = xg[t].to(torch.float32).unbind(1)
        hr, hz, hn = _hg(hp, w, bh).unbind(1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dh_c + dy[t].to(torch.float32)
        m = mask[t].to(torch.float32)[:, :, None]
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        dn_pre = dn * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dhn = dn_pre * r
        dhg = torch.stack([dr_pre, dz_pre, dhn], dim=1) * m[:, None]  # (D, 3, B, H)
        # sum over gates of dhg[g] @ w[g]^T, the same f32 products as K1's
        dh_prev = torch.bmm(dhg.transpose(1, 2).reshape(nd, b, 3 * h_dim),
                            w.permute(0, 2, 1, 3).reshape(nd, h_dim, 3 * h_dim)
                            .transpose(1, 2))
        dh_c = m * (dh_prev + dh * z * m) + (1.0 - m) * dh
        dg[t] = (torch.stack([dr_pre, dz_pre, dn_pre, dhn], dim=1) * m[:, None]).to(dt)
    return dg


def bigru2_forward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Gate-major fused GRU time loop: (T, D, 3, B, H) -> (T, D, B, H).

    CUDA tensors run the Hopper kernel (one launch a call, or one a row
    group, each counted in ``bigru2_forward.launches``); CPU tensors run
    ``bigru2_reference``. Arguments as for ``bigru2_reference``, but on
    CUDA they must be contiguous, w_h at xg's dtype and b_h/mask f32.
    """
    if xg.device.type == "cpu":
        return bigru2_reference(xg, w_h, b_h, mask)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru2_forward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask, gate_major=True)
    t_len, nd, _, b, _ = xg.shape
    ys = torch.empty((t_len, nd, b, h), dtype=xg.dtype, device=xg.device)
    if ys.numel() == 0:
        return ys
    bigru2_forward.launches += run_forward("bigru2_fwd", 3, xg, w_h, b_h, mask, ys,
                                           batch_axis=3)
    return ys


bigru2_forward.launches = 0


def bigru2_backward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                    mask: torch.Tensor, h_prev: torch.Tensor,
                    dy: torch.Tensor) -> torch.Tensor:
    """Reverse-time gate-major GRU gradients: -> dg (T, D, 4, B, H).

    CUDA tensors run the Hopper kernel (two launches a call whatever T,
    two a row group, each counted in ``bigru2_backward.launches``); CPU
    tensors run
    ``bigru2_backward_reference``. On CUDA, h_prev and dy must be
    contiguous and in xg's dtype, with the shape of ys.
    """
    if xg.device.type == "cpu":
        return bigru2_backward_reference(xg, w_h, b_h, mask, h_prev, dy)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru2_backward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask, gate_major=True)
    t_len, nd, _, b, _ = xg.shape
    check_states(xg, (t_len, nd, b, h), h_prev=h_prev, dy=dy)
    dg = torch.empty((t_len, nd, 4, b, h), dtype=xg.dtype, device=xg.device)
    if dg.numel() == 0:
        return dg
    groups = run_backward("bigru2_bwd", 3, xg, w_h, b_h, mask, h_prev, dy, dg, batch_axis=3)
    bigru2_backward.launches += BWD_LAUNCHES * groups
    return dg


bigru2_backward.launches = 0


class BiGRU2Function(torch.autograd.Function):
    """``bigru2_forward`` with ``bigru2_backward`` as its gradient (the
    ``custom_vjp`` of ``tpuasr.ops.gru2.bigru_pallas2``,
    ``tpuasr/ops/gru2.py:243-250``). dxg is dg's first three gates in
    xg's dtype; dw and db are ``rnn_weight_grads`` of h_prev and dhg =
    [dr_pre, dz_pre, dhn] (read from the rounded dg in place): f32 sums
    over time and batch, gate-major (D, 3, H, H) in w_h's dtype.
    """

    @staticmethod
    def forward(ctx, xg, w_h, b_h, mask):
        ys = bigru2_forward(xg, w_h, b_h, mask)
        ctx.save_for_backward(xg, w_h, b_h, mask, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        xg, w_h, b_h, mask, ys = ctx.saved_tensors
        h_prev = shift_time(ys)
        dg = bigru2_backward(xg, w_h, b_h, mask, h_prev, dy.to(xg.dtype).contiguous())
        dw, db = rnn_weight_grads(h_prev, dg, (0, 1, 3), w_h, b_h)
        return dg[:, :, :3], dw, db, None
