"""Fused bidirectional GRU time loop (port of ``tpuasr/ops/gru.py``).

``bigru_forward`` is the wrapper of the hand-written Hopper kernel
``csrc/bigru_fwd.cu`` (one persistent launch a call, ``csrc/rnn_fwd.cuh``),
which replaces the TPU kernel ``tpuasr/ops/gru.py:_fwd_kernel``. ``bigru_reference`` is its plain
PyTorch version with the same numerics: the recurrent product and
``b_h`` in f32, gate math in f32, the carried h rounded to xg's dtype
every step, masked frames carrying h through.

``bigru_backward`` wraps ``csrc/bigru_bwd.cu``, which replaces
``tpuasr/ops/gru.py:_bwd_kernel``: the reverse-time gate gradients,
packed ``[dr_pre, dz_pre, dn_pre, dhn]`` (4H) in xg's dtype, with an
f32 carried dh. ``bigru_backward_reference`` is its plain version.
``BiGRUFunction`` is the autograd function around both, forming dxg,
dw and db from the packed gradients as ``_bigru_bwd`` does.

The wrappers use the plain versions only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.

The input projections ``xg`` are computed outside, as in the JAX
package. Direction 1 is the TIME-FLIPPED sequence (the model passes
``flip(x, time)`` with mask ``t >= T - len`` and flips the output back).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuasr_torch.ops import _build
from tpuasr_torch.ops.rnn_plan import (
    max_bwd_rows,
    max_fwd_rows,
    rnn_bwd_plan,
    rnn_fwd_plan,
    row_groups,
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def bigru_reference(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch time loop; the oracle of the kernel.

    Args:
      xg: (T, D, B, 3H) input projections, f32 or bf16.
      w_h: (D, H, 3H) recurrent weights (used at xg's dtype).
      b_h: (D, 3H) recurrent bias (used in f32).
      mask: (T, D, B) per-direction validity.
    Returns:
      ys: (T, D, B, H) in xg's dtype; padded frames hold the carried h.
    """
    dt = xg.dtype
    t_len, nd, b, _ = xg.shape
    h_dim = w_h.shape[1]
    w = w_h.to(dt).to(torch.float32)  # bf16 products are exact in f32
    bh = b_h.to(torch.float32)[:, None, :]
    h = xg.new_zeros((nd, b, h_dim))
    ys = xg.new_empty((t_len, nd, b, h_dim))
    for t in range(t_len):
        hf = h.to(torch.float32)
        xr, xz, xn = xg[t].to(torch.float32).split(h_dim, dim=-1)
        hr, hz, hn = (torch.bmm(hf, w) + bh).split(h_dim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * hf
        m = mask[t].to(torch.float32)[:, :, None]
        h = (m * h_new + (1.0 - m) * hf).to(dt)
        ys[t] = h
    return ys


def bigru_backward_reference(xg: torch.Tensor, w_h: torch.Tensor,
                             b_h: torch.Tensor, mask: torch.Tensor,
                             h_prev: torch.Tensor,
                             dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reverse-time loop with ``_bwd_kernel``'s numerics.

    Args as ``bigru_reference``, plus h_prev (T, D, B, H): the forward's
    ys shifted one step later (h_0 = 0), and dy (T, D, B, H): the
    gradient of ys, both in xg's dtype. The kernel recomputes the gates
    from h_prev (products and b_h in f32), carries dL/dh in f32, keeps
    dhg = [dr_pre, dz_pre, dhn] in f32 for the product with w_h^T, and
    passes dh through masked frames.
    Returns packed (T, D, B, 4H) = [dr_pre, dz_pre, dn_pre, dhn] * m,
    rounded to xg's dtype.
    """
    dt = xg.dtype
    t_len, nd, b, g3 = xg.shape
    h_dim = g3 // 3
    w = w_h.to(dt).to(torch.float32)
    w_t = w.transpose(1, 2)
    bh = b_h.to(torch.float32)[:, None, :]
    dh_c = torch.zeros((nd, b, h_dim), dtype=torch.float32, device=xg.device)
    packed = xg.new_empty((t_len, nd, b, 4 * h_dim))
    for t in reversed(range(t_len)):
        hp = h_prev[t].to(torch.float32)
        xr, xz, xn = xg[t].to(torch.float32).split(h_dim, dim=-1)
        hr, hz, hn = (torch.bmm(hp, w) + bh).split(h_dim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dh_c + dy[t].to(torch.float32)
        m = mask[t].to(torch.float32)[:, :, None]
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        dh_direct = dh * z
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hn
        dhn = dn_pre * r
        dz_pre = dz * z * (1.0 - z)
        dr_pre = dr * r * (1.0 - r)
        dhg = torch.cat([dr_pre, dz_pre, dhn], dim=-1) * m
        dh_prev = torch.bmm(dhg, w_t) + dh_direct * m
        dh_c = m * dh_prev + (1.0 - m) * dh
        packed[t] = (torch.cat([dr_pre, dz_pre, dn_pre, dhn], dim=-1) * m).to(dt)
    return packed


def shift_time(x: torch.Tensor) -> torch.Tensor:
    """x one step later along time (axis 0), zero at t = 0: the previous
    states h_{t-1} (and the LSTM's c_{t-1}) that the backward kernels
    read."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def check_inputs(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor | None,
                 mask: torch.Tensor, n_gates: int = 3,
                 gate_major: bool = False) -> int:
    """Raise unless the fused RNN kernels take these inputs; returns H.
    Layouts: xg (T, D, B, n_gates*H), w_h (D, H, n_gates*H), b_h
    (D, n_gates*H); gate-major xg (T, D, n_gates, B, H), w_h
    (D, n_gates, H, H), b_h (D, n_gates, H); mask (T, D, B); D in (1, 2);
    xg and w_h f32 or bf16 alike, b_h and mask f32, all contiguous on
    xg's device. b_h None: a kernel that takes none (the vanilla RNN's
    backward)."""
    g = n_gates
    if xg.dim() != (5 if gate_major else 4):
        layout = f"(T, D, {g}, B, H)" if gate_major else f"(T, D, B, {g}H)"
        raise ValueError(f"xg must be {layout}, got {tuple(xg.shape)}")
    if gate_major:
        t_len, nd, _, b, _ = xg.shape
        h = w_h.shape[-1] if w_h.dim() == 4 else -1
        want = {"xg": (t_len, nd, g, b, h), "w_h": (nd, g, h, h), "b_h": (nd, g, h)}
    else:
        t_len, nd, b, _ = xg.shape
        h = w_h.shape[1] if w_h.dim() == 3 else -1
        want = {"xg": (t_len, nd, b, g * h), "w_h": (nd, h, g * h), "b_h": (nd, g * h)}
    if nd not in (1, 2) or tuple(xg.shape) != want["xg"]:
        raise ValueError(f"xg {tuple(xg.shape)} does not match w_h "
                         f"{tuple(w_h.shape)}: need D in (1, 2) and {g} gates of H")
    want["mask"] = (t_len, nd, b)
    named = [(n, t) for n, t in (("xg", xg), ("w_h", w_h), ("b_h", b_h), ("mask", mask))
             if t is not None]
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    if xg.dtype not in DTYPE_CODE or w_h.dtype != xg.dtype:
        raise TypeError(f"xg and w_h must share float32 or bfloat16, got "
                        f"{xg.dtype} and {w_h.dtype}")
    if any(t.dtype != torch.float32 for n, t in named if n in ("b_h", "mask")):
        raise TypeError("b_h and mask must be float32")
    for name, t in named:
        if t.device != xg.device:
            raise ValueError(f"{name} is on {t.device}, xg on {xg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return h


def check_states(xg: torch.Tensor, shape: tuple, **states: torch.Tensor) -> None:
    """Raise unless every named tensor has ``shape`` and is contiguous,
    in xg's dtype and on xg's device (the backward kernels' per-step
    inputs)."""
    for name, t in states.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != xg.dtype:
            raise TypeError(f"{name} must be {xg.dtype}, got {t.dtype}")
        if t.device != xg.device:
            raise ValueError(f"{name} is on {t.device}, xg on {xg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def kernel_library(name: str) -> ctypes.CDLL:
    """The library of an RNN kernel (built on first use), ``bigru[2]_fwd``,
    ``bilstm_fwd``, ``birnn_fwd``, ``bigru[2]_bwd``, ``bilstm_bwd`` or
    ``birnn_bwd``, with its C signatures; the forward libraries share
    theirs (the LSTM's adds cs), and so do the backward ones (the vanilla
    RNN's has no hg GEMM)."""
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name.endswith("fwd"):
        n_out = 2 if name == "bilstm_fwd" else 1  # ys (and cs)
        fns = {f"tpuasr_{name}": [p] * (4 + n_out) + [p] * 3 + [i] * 5 + [p]}
    else:
        fns = {f"tpuasr_{name}_loop": [p] * 13 + [i] * 5 + [p]}
        if name != "birnn_bwd":
            fns[f"tpuasr_{name}_hg"] = [p] * 4 + [i] * 6 + [p]
    fns["tpuasr_rnn_device_limits"] = [ctypes.POINTER(i)] * 2
    for fn_name, argtypes in fns.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpuasr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpuasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


@functools.cache
def _device_limits(name: str, index: int) -> tuple[int, int]:
    """(SMs, opt-in shared memory bytes a block) of CUDA device ``index``:
    the SM count from torch, the shared memory from the C side."""
    lib = kernel_library(name)
    n_sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        raise_on(lib, lib.tpuasr_rnn_device_limits(ctypes.byref(n_sms), ctypes.byref(smem)),
                 f"{name} device query")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem.value


def _card(name: str, dev: torch.device) -> tuple[int, int]:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _device_limits(name, index)


def _rows(x: torch.Tensor, axis: int, b0: int, b1: int) -> torch.Tensor:
    """Rows b0 .. b1 - 1 of a tensor whose batch axis is ``axis``,
    contiguous (the tensor itself when they are all of its rows)."""
    if b0 == 0 and b1 == x.shape[axis]:
        return x
    return x.narrow(axis, b0, b1 - b0).contiguous()


BWD_LAUNCHES = 2  # per backward call and row group: the hg GEMM and the persistent loop
# (the vanilla RNN's K6b: the loop alone, ops.birnn.BWD_LAUNCHES)
# A list to time the backward's two launches: each call appends CUDA
# events {"hg": (start, end), "loop": (start, end)} per row group; None:
# no events.
bwd_events: list | None = None
BWD_PARTS = ("hg_wait", "gate", "barrier", "dhg_wait", "product", "loop")  # the C side's timer
# A list to split the backward loop's step: each call appends, per row
# group, {"timer": (n_blocks, 6) int64 tensor of clock64 sums over the
# steps in BWD_PARTS order (thread 0 of each block), "T": steps}; None:
# no timer (the main path).
bwd_parts: list | None = None


def run_backward(name: str, n_gates: int, xg: torch.Tensor, w_h: torch.Tensor,
                 b_h: torch.Tensor | None, mask: torch.Tensor, h_prev: torch.Tensor,
                 dy: torch.Tensor, out: torch.Tensor, c_prev: torch.Tensor | None = None,
                 cs: torch.Tensor | None = None, batch_axis: int = 2) -> int:
    """Launch a fused RNN backward (``csrc/rnn_bwd.cuh``) into ``out``:
    the hg GEMM over every step, then the persistent reverse loop, tiled
    by ``rnn_bwd_plan`` for this card. ``name`` is the library
    (``bigru_bwd``, ``bigru2_bwd``, ``bilstm_bwd``; ``birnn_bwd``, one
    gate, runs the loop alone, on ys in xg's and h_prev's places and with
    no b_h); inputs are checked by the caller; ``batch_axis`` is the
    batch axis of xg and out (3 in the
    gate-major layout; 2 in every other tensor). A batch larger than one
    plan holds (``max_bwd_rows``) runs in row groups, each its own GEMM
    and loop: every row's recursion is independent, so the result is
    that of one call. A group's rows are copied into contiguous tensors
    (and its output back), so that the kernels index one batch size; the
    copies are taken only past the plan's limit (422 rows at BiGRU-800 on
    an H100). Appends the launches' CUDA events to ``bwd_events``, and the
    loop's step timer to ``bwd_parts``, when that is a list. Returns the
    number of row groups."""
    t_len, nd = xg.shape[:2]
    b, h = h_prev.shape[2], h_prev.shape[3]
    dev = xg.device
    lib = kernel_library(name)
    n_sms, smem = _card(name, dev)
    groups = row_groups(b, max_bwd_rows(nd, h, n_gates, xg.element_size(), n_sms, smem))
    code = DTYPE_CODE[xg.dtype]
    ptr = (lambda x: None if x is None else x.data_ptr())
    f32 = dict(dtype=torch.float32, device=dev)
    for b0, b1 in groups:
        bg = b1 - b0
        plan = rnn_bwd_plan(nd, bg, h, n_gates, xg.element_size(), n_sms, smem)
        xg_g, out_g = _rows(xg, batch_axis, b0, b1), _rows(out, batch_axis, b0, b1)
        mask_g, hp_g, dy_g = (_rows(x, 2, b0, b1) for x in (mask, h_prev, dy))
        cp_g, cs_g = (None if x is None else _rows(x, 2, b0, b1) for x in (c_prev, cs))
        hg = (torch.empty((t_len, nd, bg, n_gates, plan.HP), **f32)  # hg of every step
              if n_gates > 1 else None)
        dhg = torch.zeros((2, nd, bg, plan.GP), **f32)  # dhg of steps t % 2 (put_dhg); pad stays 0
        bar = torch.zeros((1,), dtype=torch.int32, device=dev)  # grid barrier counter
        timer = (None if bwd_parts is None else
                 torch.zeros((plan.n_blocks, len(BWD_PARTS)), dtype=torch.int64, device=dev))
        ints = plan.as_ints()
        layout = (ctypes.c_int * len(ints))(*ints)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            ev = None if bwd_events is None else [
                torch.cuda.Event(enable_timing=True) for _ in range(3)]
            if ev:
                ev[0].record()
            if hg is not None:
                err = getattr(lib, f"tpuasr_{name}_hg")(
                    hp_g.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), hg.data_ptr(),
                    t_len, nd, bg, h, plan.HP, code, stream)
                raise_on(lib, err, f"{name} hg")
            if ev:
                ev[1].record()
            err = getattr(lib, f"tpuasr_{name}_loop")(
                xg_g.data_ptr(), w_h.data_ptr(), mask_g.data_ptr(), hp_g.data_ptr(),
                ptr(cp_g), ptr(cs_g), dy_g.data_ptr(), ptr(hg), out_g.data_ptr(),
                dhg.data_ptr(), bar.data_ptr(), ptr(timer), layout, t_len, nd, bg, h, code,
                stream)
            raise_on(lib, err, f"{name} loop")
            if ev:
                ev[2].record()
                bwd_events.append({"hg": (ev[0], ev[1]), "loop": (ev[1], ev[2])})
        if timer is not None:
            bwd_parts.append({"timer": timer, "T": t_len})
        if out_g is not out:
            out.narrow(batch_axis, b0, bg).copy_(out_g)
    return len(groups)


FWD_PARTS = ("barrier", "h_load", "product", "gate", "loop")  # the C side's timer columns
# A list to split the forward's step: each call appends, per row group,
# {"timer": (n_blocks, 5) int64 tensor of clock64 sums over the steps in
# FWD_PARTS order (thread 0 of each block), "T": steps}; None: no timer
# (the main path).
fwd_parts: list | None = None


def run_forward(name: str, n_gates: int, xg: torch.Tensor, w_h: torch.Tensor,
                b_h: torch.Tensor, mask: torch.Tensor, ys: torch.Tensor,
                cs: torch.Tensor | None = None, batch_axis: int = 2) -> int:
    """Launch a fused RNN forward (``csrc/rnn_fwd.cuh``: one persistent,
    cooperative launch for the whole time loop) into ys (and the LSTM's
    cs), tiled by ``rnn_fwd_plan`` for this card. ``name`` is the library
    (``bigru_fwd``, ``bigru2_fwd``, ``bilstm_fwd``); inputs are checked by
    the caller; ``batch_axis`` is xg's batch axis (3 in the gate-major
    layout). A batch whose state does not fit one block (``max_fwd_rows``,
    2,864 rows at BiGRU-800 on an H100) runs in row groups, copied as the
    backward's are. Returns the number of row groups (launches)."""
    t_len, nd = xg.shape[:2]
    b, h = ys.shape[2], ys.shape[3]
    dev = xg.device
    lib = kernel_library(name)
    n_sms, smem = _card(name, dev)
    groups = row_groups(b, max_fwd_rows(nd, h, n_gates, xg.element_size(), n_sms, smem))
    code = DTYPE_CODE[xg.dtype]
    outs = (ys,) if cs is None else (ys, cs)
    for b0, b1 in groups:
        bg = b1 - b0
        plan = rnn_fwd_plan(nd, bg, h, n_gates, xg.element_size(), n_sms, smem)
        xg_g, mask_g = _rows(xg, batch_axis, b0, b1), _rows(mask, 2, b0, b1)
        outs_g = tuple(_rows(o, 2, b0, b1) for o in outs)
        bar = torch.zeros((1,), dtype=torch.int32, device=dev)  # grid barrier counter
        timer = (None if fwd_parts is None else
                 torch.zeros((plan.n_blocks, len(FWD_PARTS)), dtype=torch.int64, device=dev))
        ints = plan.as_ints()
        layout = (ctypes.c_int * len(ints))(*ints)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"tpuasr_{name}")(
                xg_g.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_g.data_ptr(),
                *(o.data_ptr() for o in outs_g), bar.data_ptr(),
                None if timer is None else timer.data_ptr(), layout, t_len, nd, bg, h, code,
                stream)
        raise_on(lib, err, name)
        if timer is not None:
            fwd_parts.append({"timer": timer, "T": t_len})
        for o, o_g in zip(outs, outs_g):
            if o_g is not o:
                o.narrow(2, b0, bg).copy_(o_g)
    return len(groups)


def bigru_forward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Fused GRU time loop over D directions: (T, D, B, 3H) -> (T, D, B, H).

    CUDA tensors run the Hopper kernel (one launch a call, or one a row
    group past ``max_fwd_rows``, each counted in
    ``bigru_forward.launches``); CPU tensors run ``bigru_reference``.
    Arguments as for ``bigru_reference``, but on CUDA they must be
    contiguous, w_h at xg's dtype and b_h/mask f32.
    """
    if xg.device.type == "cpu":
        return bigru_reference(xg, w_h, b_h, mask)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru_forward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask)
    t_len, nd, b, _ = xg.shape
    ys = torch.empty((t_len, nd, b, h), dtype=xg.dtype, device=xg.device)
    if ys.numel() == 0:
        return ys
    bigru_forward.launches += run_forward("bigru_fwd", 3, xg, w_h, b_h, mask, ys)
    return ys


bigru_forward.launches = 0


def bigru_backward(xg: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                   mask: torch.Tensor, h_prev: torch.Tensor,
                   dy: torch.Tensor) -> torch.Tensor:
    """Reverse-time GRU gate gradients: -> packed (T, D, B, 4H).

    CUDA tensors run the Hopper kernel (two launches a call whatever T,
    the hg GEMM and the persistent loop, two a row group past
    ``max_bwd_rows``, each counted in ``bigru_backward.launches``); CPU
    tensors run
    ``bigru_backward_reference``. On CUDA, h_prev and dy must be
    contiguous and in xg's dtype, with the shape of ys.
    """
    if xg.device.type == "cpu":
        return bigru_backward_reference(xg, w_h, b_h, mask, h_prev, dy)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru_backward runs on cuda or cpu, not {xg.device}")
    h = check_inputs(xg, w_h, b_h, mask)
    t_len, nd, b, _ = xg.shape
    check_states(xg, (t_len, nd, b, h), h_prev=h_prev, dy=dy)
    packed = torch.empty((t_len, nd, b, 4 * h), dtype=xg.dtype, device=xg.device)
    if packed.numel() == 0:
        return packed
    groups = run_backward("bigru_bwd", 3, xg, w_h, b_h, mask, h_prev, dy, packed)
    bigru_backward.launches += BWD_LAUNCHES * groups
    return packed


bigru_backward.launches = 0


class BiGRUFunction(torch.autograd.Function):
    """``bigru_forward`` with ``bigru_backward`` as its gradient (the
    ``custom_vjp`` of ``tpuasr.ops.gru.bigru_pallas``). dxg is the
    packed gradient's first 3H columns in xg's dtype; dw is the f32
    einsum of h_prev and dhg = [dr_pre, dz_pre, dhn] (read back from the
    rounded packed output), cast to w_h's dtype; db is dhg's f32 sum.
    Each gradient comes back in its input's dtype, as in the JAX package.
    """

    @staticmethod
    def forward(ctx, xg, w_h, b_h, mask):
        ys = bigru_forward(xg, w_h, b_h, mask)
        ctx.save_for_backward(xg, w_h, b_h, mask, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        xg, w_h, b_h, mask, ys = ctx.saved_tensors
        g3 = xg.shape[-1]
        h = g3 // 3
        h_prev = shift_time(ys)
        packed = bigru_backward(xg, w_h, b_h, mask, h_prev,
                                dy.to(xg.dtype).contiguous())
        dxg = packed[..., :g3]
        dhg = torch.cat([packed[..., :2 * h], packed[..., g3:]], dim=-1).to(torch.float32)
        dw = torch.einsum("tdbh,tdbg->dhg", h_prev.to(torch.float32), dhg)
        db = dhg.sum(dim=(0, 2))
        return dxg, dw.to(w_h.dtype), db.to(b_h.dtype), None
