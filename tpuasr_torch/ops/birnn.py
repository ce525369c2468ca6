"""Fused bidirectional vanilla (tanh) RNN time loop: K6f and K6b.

The layer is the reference's ``--rnn-type rnn`` (``nn.RNN``, tanh):
``h_t = m_t tanh(xg_t + h_{t-1} @ w_h + b_h) + (1 - m_t) h_{t-1}``, the
input projection ``xg`` computed outside. The JAX package runs it as a
``lax.scan`` under every impl and has no TPU kernel for it; the port's
kernels are one-gate instances of the shared persistent loops
(``csrc/rnn_fwd.cuh``, ``csrc/rnn_bwd.cuh``, tiled by ``rnn_plan.py``).

``birnn_forward`` wraps ``csrc/birnn_fwd.cu`` (one persistent launch a
call); ``birnn_reference`` is its plain PyTorch version with the same
numerics: the recurrent product and ``b_h`` in f32, tanh in f32, the
carried h rounded to xg's dtype every step, masked frames carrying h
through. ``birnn_backward`` wraps ``csrc/birnn_bwd.cu``: the
pre-activation gradients d(pre) = (dy + dh) (1 - y^2) m in reverse time,
with y the forward's rounded ys and an f32 carried dh; it needs neither
xg nor a recomputed hg, so it is one launch a call.
``birnn_backward_reference`` is its plain version. ``BiRNNFunction`` is
the autograd function around both.

The wrappers use the plain versions only for CPU tensors; on a CUDA
tensor they launch the kernel or raise. Each forward call counts as a
vanilla layer call in ``tpuasr_torch.profiling`` while a profile runs:
``rnn.tanh_kernel_calls`` when it ran K6f, ``rnn.tanh_loop_calls`` when
it ran the plain loop. Layout and direction contract as in
``tpuasr_torch.ops.gru``: xg (T, D, B, H), w_h (D, H, H), b_h (D, H),
mask (T, D, B), direction 1 time-flipped by the caller.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops.gru import (
    check_inputs,
    check_states,
    rnn_weight_grads,
    run_backward,
    run_forward,
)
from tpuasr_torch.profiling import count

BWD_LAUNCHES = 1  # per backward call and row group: the loop alone, no hg GEMM


def birnn_reference(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch time loop; the oracle of K6f.

    Args:
      xg: (T, D, B, H) input projections, f32 or bf16.
      w_h: (D, H, H) recurrent weights (used at xg's dtype).
      b_h: (D, H) recurrent bias (used in f32).
      mask: (T, D, B) per-direction validity.
    Returns:
      ys: (T, D, B, H) in xg's dtype; padded frames hold the carried h.
    """
    dt = xg.dtype
    t_len, nd, b, h_dim = xg.shape
    w = w_h.to(dt).to(torch.float32)  # bf16 products are exact in f32
    bh = b_h.to(torch.float32)[:, None, :]
    h = xg.new_zeros((nd, b, h_dim))
    ys = xg.new_empty((t_len, nd, b, h_dim))
    for t in range(t_len):
        hf = h.to(torch.float32)
        h_new = torch.tanh(xg[t].to(torch.float32) + (torch.bmm(hf, w) + bh))
        m = mask[t].to(torch.float32)[:, :, None]
        h = (m * h_new + (1.0 - m) * hf).to(dt)
        ys[t] = h
    return ys


def birnn_backward_reference(w_h: torch.Tensor, mask: torch.Tensor, ys: torch.Tensor,
                             dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reverse-time loop with K6b's numerics.

    Args: w_h (D, H, H) and mask (T, D, B) as ``birnn_reference``; ys
    (T, D, B, H), the forward's output, and dy, its gradient, both in
    w_h's dtype. dL/dh is carried in f32, the derivative of tanh is
    taken from the rounded ys, the product with w_h^T uses the unrounded
    d(pre), and masked frames pass dh through.
    Returns d(pre) (T, D, B, H) = (dy + dh) (1 - y^2) m, rounded to ys's
    dtype (it is also dxg).
    """
    dt = ys.dtype
    t_len, nd, b, h_dim = ys.shape
    w_t = w_h.to(dt).to(torch.float32).transpose(1, 2)
    dh_c = torch.zeros((nd, b, h_dim), dtype=torch.float32, device=ys.device)
    out = ys.new_empty((t_len, nd, b, h_dim))
    for t in reversed(range(t_len)):
        y = ys[t].to(torch.float32)
        m = mask[t].to(torch.float32)[:, :, None]
        dh = dh_c + dy[t].to(torch.float32)
        dpre = dh * (1.0 - y * y) * m
        dh_c = torch.bmm(dpre, w_t) + (1.0 - m) * dh
        out[t] = dpre.to(dt)
    return out


def birnn_forward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Fused vanilla RNN time loop over D directions: (T, D, B, H) ->
    (T, D, B, H).

    CUDA tensors run K6f (one launch a call, or one a row group past
    ``max_fwd_rows``, each counted in ``birnn_forward.launches``); CPU
    tensors run ``birnn_reference``. Arguments as for
    ``birnn_reference``, but on CUDA they must be contiguous, w_h at xg's
    dtype and b_h/mask f32.
    """
    if xg.device.type == "cpu":
        count("rnn.tanh_loop_calls")
        return birnn_reference(xg, w_h, b_h, mask)
    if xg.device.type != "cuda":
        raise ValueError(f"birnn_forward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask, n_gates=1)
    count("rnn.tanh_kernel_calls")
    ys = torch.empty_like(xg)
    if ys.numel() == 0:
        return ys
    birnn_forward.launches += run_forward("birnn_fwd", 1, xg, w_h, b_h, mask, ys)
    return ys


birnn_forward.launches = 0


def birnn_backward(w_h: torch.Tensor, mask: torch.Tensor, ys: torch.Tensor,
                   dy: torch.Tensor) -> torch.Tensor:
    """Reverse-time vanilla RNN pre-activation gradients: -> d(pre)
    (T, D, B, H).

    CUDA tensors run K6b (one launch a call whatever T, one a row group
    past ``max_bwd_rows``, each counted in ``birnn_backward.launches``);
    CPU tensors run ``birnn_backward_reference``. On CUDA, ys and dy must
    be contiguous, in w_h's dtype and of one shape.
    """
    if ys.device.type == "cpu":
        return birnn_backward_reference(w_h, mask, ys, dy)
    if ys.device.type != "cuda":
        raise ValueError(f"birnn_backward runs on cuda or cpu, not {ys.device}")
    check_inputs(ys, w_h, None, mask, n_gates=1)
    check_states(ys, tuple(ys.shape), dy=dy)
    dpre = torch.empty_like(ys)
    if dpre.numel() == 0:
        return dpre
    groups = run_backward("birnn_bwd", 1, ys, w_h, None, mask, ys, dy, dpre)
    birnn_backward.launches += BWD_LAUNCHES * groups
    return dpre


birnn_backward.launches = 0


class BiRNNFunction(torch.autograd.Function):
    """``birnn_forward`` with ``birnn_backward`` as its gradient. dxg is
    d(pre) in xg's dtype; dw and db are ``rnn_weight_grads`` of h_{t-1}
    (ys read a step back) and the rounded d(pre): f32 sums over time and
    batch, cast to w_h's and b_h's dtypes, as ``BiLSTMFunction`` forms
    them. Saves ys, not xg."""

    @staticmethod
    def forward(ctx, xg, w_h, b_h, mask):
        ys = birnn_forward(xg, w_h, b_h, mask)
        ctx.save_for_backward(w_h, b_h, mask, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        w_h, b_h, mask, ys = ctx.saved_tensors
        dpre = birnn_backward(w_h, mask, ys, dy.to(ys.dtype).contiguous())
        dw, db = rnn_weight_grads(ys, dpre, (0,), w_h, b_h, shift=1)
        return dpre, dw, db, None
