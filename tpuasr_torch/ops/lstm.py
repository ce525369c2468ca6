"""Fused bidirectional LSTM time loop (port of ``tpuasr/ops/lstm.py``).

``bilstm_forward`` is the wrapper of the hand-written Hopper kernel
``csrc/bilstm_fwd.cu`` (one persistent launch a call), which replaces
the TPU kernel ``tpuasr/ops/lstm.py:_fwd_kernel``. ``bilstm_reference`` is its plain
PyTorch version with the same numerics: gates [i, f, g, o], the
recurrent product and ``b_h`` in f32, h carried rounded to xg's dtype
and c carried in f32, masked frames carrying both through. Both return
the hidden states ys and the cell states cs, rounded to xg's dtype.

``bilstm_backward`` wraps ``csrc/bilstm_bwd.cu``, which replaces
``tpuasr/ops/lstm.py:_bwd_kernel``: the reverse-time gate pre-activation
gradients dhg (== dxg, (T, D, B, 4H) in xg's dtype) with f32 dh and dc
carries, from the rounded cs. ``bilstm_backward_reference`` is its plain
version. ``BiLSTMFunction`` is the autograd function around both, the
``custom_vjp`` of ``tpuasr.ops.lstm.bilstm_pallas``.

The wrappers use the plain versions only for CPU tensors; on a CUDA
tensor they launch the kernel or raise. Layout and direction contract
as in ``tpuasr_torch.ops.gru``: xg (T, D, B, 4H), w_h (D, H, 4H), b_h
(D, 4H), mask (T, D, B), direction 1 time-flipped by the caller.
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


def _gates(xg_t: torch.Tensor, hg: torch.Tensor, h_dim: int):
    """[i, f, g, o] activations from f32 (D, B, 4H) projections."""
    xi, xf, xc, xo = xg_t.split(h_dim, dim=-1)
    hi, hf, hc, ho = hg.split(h_dim, dim=-1)
    return (torch.sigmoid(xi + hi), torch.sigmoid(xf + hf),
            torch.tanh(xc + hc), torch.sigmoid(xo + ho))


def bilstm_reference(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                     mask: torch.Tensor):
    """Plain PyTorch time loop; the oracle of the kernel.

    Args:
      xg: (T, D, B, 4H) input projections, f32 or bf16.
      w_h: (D, H, 4H) recurrent weights (used at xg's dtype).
      b_h: (D, 4H) recurrent bias (used in f32).
      mask: (T, D, B) per-direction validity.
    Returns:
      ys, cs: (T, D, B, H) hidden and cell states in xg's dtype; padded
      frames hold the carried states.
    """
    dt = xg.dtype
    t_len, nd, b, _ = xg.shape
    h_dim = w_h.shape[1]
    w = w_h.to(dt).to(torch.float32)  # bf16 products are exact in f32
    bh = b_h.to(torch.float32)[:, None, :]
    h = xg.new_zeros((nd, b, h_dim))
    c = torch.zeros((nd, b, h_dim), dtype=torch.float32, device=xg.device)
    ys = xg.new_empty((t_len, nd, b, h_dim))
    cs = xg.new_empty((t_len, nd, b, h_dim))
    for t in range(t_len):
        hf = h.to(torch.float32)
        i, f, g, o = _gates(xg[t].to(torch.float32), torch.bmm(hf, w) + bh, h_dim)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t].to(torch.float32)[:, :, None]
        h = (m * h_new + (1.0 - m) * hf).to(dt)
        c = m * c_new + (1.0 - m) * c
        ys[t] = h
        cs[t] = c.to(dt)
    return ys, cs


def bilstm_backward_reference(xg: torch.Tensor, w_h: torch.Tensor,
                              b_h: torch.Tensor, mask: torch.Tensor,
                              h_prev: torch.Tensor, c_prev: torch.Tensor,
                              cs: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reverse-time loop with ``_bwd_kernel``'s numerics.

    Args as ``bilstm_reference``, plus (T, D, B, H) tensors in xg's
    dtype: h_prev and c_prev, the forward's ys and cs shifted one step
    later (zero at t = 0), cs itself, and dy, the gradient of ys. The
    gates are recomputed from h_prev (products and b_h in f32), tanh is
    taken of the rounded cs, dL/dh and dL/dc are carried in f32, the
    product with w_h^T uses the unrounded dhg, and masked frames pass
    dh and dc through.
    Returns dhg (T, D, B, 4H) = [di, df, dg, do] pre-activation
    gradients * m, rounded to xg's dtype (it is also dxg).
    """
    dt = xg.dtype
    t_len, nd, b, g4 = xg.shape
    h_dim = g4 // 4
    w = w_h.to(dt).to(torch.float32)
    w_t = w.transpose(1, 2)
    bh = b_h.to(torch.float32)[:, None, :]
    f32 = dict(dtype=torch.float32, device=xg.device)
    dh_c = torch.zeros((nd, b, h_dim), **f32)
    dc_c = torch.zeros((nd, b, h_dim), **f32)
    out = xg.new_empty((t_len, nd, b, g4))
    for t in reversed(range(t_len)):
        hp = h_prev[t].to(torch.float32)
        i, f, g, o = _gates(xg[t].to(torch.float32), torch.bmm(hp, w) + bh, h_dim)
        tc = torch.tanh(cs[t].to(torch.float32))
        m = mask[t].to(torch.float32)[:, :, None]
        dh = dh_c + dy[t].to(torch.float32)
        do = dh * tc
        dct = dc_c + dh * o * (1.0 - tc * tc)
        di = dct * g
        df = dct * c_prev[t].to(torch.float32)
        dg = dct * i
        dc_prev = dct * f
        dhg = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                         dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1) * m
        dh_c = m * torch.bmm(dhg, w_t) + (1.0 - m) * dh
        dc_c = m * dc_prev + (1.0 - m) * dc_c
        out[t] = dhg.to(dt)
    return out


def bilstm_forward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                   mask: torch.Tensor):
    """Fused LSTM time loop over D directions: (T, D, B, 4H) -> (ys, cs),
    each (T, D, B, H).

    CUDA tensors run the Hopper kernel (one launch a call, or one a row
    group, each counted in ``bilstm_forward.launches``); CPU tensors run
    ``bilstm_reference``. Arguments as for ``bilstm_reference``, but on
    CUDA they must be contiguous, w_h at xg's dtype and b_h/mask f32.
    """
    if xg.device.type == "cpu":
        return bilstm_reference(xg, w_h, b_h, mask)
    if xg.device.type != "cuda":
        raise ValueError(f"bilstm_forward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask, n_gates=4)
    t_len, nd, b, _ = xg.shape
    ys = torch.empty((t_len, nd, b, h), dtype=xg.dtype, device=xg.device)
    cs = torch.empty_like(ys)
    if ys.numel() == 0:
        return ys, cs
    bilstm_forward.launches += run_forward("bilstm_fwd", 4, xg, w_h, b_h, mask, ys, cs=cs)
    return ys, cs


bilstm_forward.launches = 0


def bilstm_backward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                    mask: torch.Tensor, h_prev: torch.Tensor,
                    c_prev: torch.Tensor, cs: torch.Tensor,
                    dy: torch.Tensor) -> torch.Tensor:
    """Reverse-time LSTM gate gradients: -> dhg (T, D, B, 4H).

    CUDA tensors run the Hopper kernel (two launches a call whatever T,
    the hg GEMM and the persistent loop, two a row group, each counted in
    ``bilstm_backward.launches``); CPU tensors run
    ``bilstm_backward_reference``. On CUDA, h_prev, c_prev, cs and dy
    must be contiguous and in xg's dtype, with the shape of ys.
    """
    if xg.device.type == "cpu":
        return bilstm_backward_reference(xg, w_h, b_h, mask, h_prev, c_prev, cs, dy)
    if xg.device.type != "cuda":
        raise ValueError(f"bilstm_backward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask, n_gates=4)
    t_len, nd, b, _ = xg.shape
    check_states(xg, (t_len, nd, b, h), h_prev=h_prev, c_prev=c_prev, cs=cs, dy=dy)
    dhg = torch.empty_like(xg)
    if dhg.numel() == 0:
        return dhg
    groups = run_backward("bilstm_bwd", 4, xg, w_h, b_h, mask, h_prev, dy, dhg,
                          c_prev=c_prev, cs=cs)
    bilstm_backward.launches += BWD_LAUNCHES * groups
    return dhg


bilstm_backward.launches = 0


class BiLSTMFunction(torch.autograd.Function):
    """``bilstm_forward``'s ys with ``bilstm_backward`` as its gradient
    (the ``custom_vjp`` of ``tpuasr.ops.lstm.bilstm_pallas``). dxg is dhg
    in xg's dtype; dw and db are ``rnn_weight_grads`` of h_prev and the
    rounded dhg: f32 sums over time and batch, cast to w_h's and b_h's
    dtypes (``tpuasr/ops/lstm.py:266-275``).
    """

    @staticmethod
    def forward(ctx, xg, w_h, b_h, mask):
        ys, cs = bilstm_forward(xg, w_h, b_h, mask)
        ctx.save_for_backward(xg, w_h, b_h, mask, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dy):
        xg, w_h, b_h, mask, ys, cs = ctx.saved_tensors
        h_prev = shift_time(ys)
        dhg = bilstm_backward(xg, w_h, b_h, mask, h_prev, shift_time(cs), cs,
                              dy.to(xg.dtype).contiguous())
        dw, db = rnn_weight_grads(h_prev, dhg, (0, 1, 2, 3), w_h, b_h)
        return dhg, dw, db, None
