"""CTC forward-backward recursions (port of ``tpuasr/ops/ctc.py``).

``ctc_alpha`` wraps the hand-written Hopper kernel ``csrc/ctc.cu``'s
alpha recursion, which replaces ``tpuasr/ops/ctc.py:_alpha_kernel``;
``ctc_beta`` wraps its beta recursion, which replaces ``_beta_kernel``
and emits the unmasked, unscaled dL/demit. ``ctc_alpha_reference`` and
``ctc_beta_reference`` are their plain PyTorch versions with the same
arithmetic. The wrappers use the plain versions only for CPU tensors;
on a CUDA tensor they launch the kernel or raise.

``CTCFromEmit`` is the port of ``ctc_loss_from_emit``: per-utterance
NLL from log-emissions, its gradient the forward-backward identity
dL/demit_t(s) = -exp(alpha_t(s) + beta_t(s) - logp). ``alpha0``, the
loss from the last alphas and the beta kernel's pre-shifted inputs are
formed in torch outside the kernels, as in the JAX package. All masks
are float 0/1 (``init_mask`` is additive: 0 or LOG_EPS).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuasr_torch.ops import _build

LOG_EPS = -1e30


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=LOG_EPS)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.clamp(out, min=LOG_EPS)


def _shift_right(x, fill):
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_left(x, fill):
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def ctc_alpha_reference(emit, allow_skip, valid_s, frame_valid, alpha0):
    """Plain log-space alpha recursion.

    Args: emit (T, B, S), allow_skip and valid_s (B, S), frame_valid
    (T, B), alpha0 (B, S), all f32. Returns alphas (T, B, S) f32:
    alphas[0] = alpha0; later frames pass alpha through where invalid.
    """
    a = alpha0
    out = [a]
    skip = allow_skip > 0.5
    valid = valid_s > 0.5
    for t in range(1, emit.shape[0]):
        a1 = _shift_right(a, LOG_EPS)
        a2 = torch.where(skip, _shift_right(a1, LOG_EPS), LOG_EPS)
        new = _lse3(a, a1, a2) + emit[t]
        new = torch.clamp(torch.where(valid, new, LOG_EPS), min=LOG_EPS)
        a = torch.where(frame_valid[t][:, None] > 0.5, new, a)
        out.append(a)
    return torch.stack(out)


def ctc_beta_reference(emit_next, skip2, fv_next, beta_init, alphas, logp):
    """Plain reverse-time beta recursion -> dL/demit (T, B, S), before
    the frame mask and the cotangent. Inputs are pre-shifted by one
    frame (emit_next[t] = emit[t+1], last row LOG_EPS; fv_next[t] =
    frame_valid[t+1], last row 0; skip2[s] = allow_skip[s+2]); logp is
    (B,)."""
    beta = beta_init
    skip = skip2 > 0.5
    demit = torch.empty_like(alphas)
    for t in reversed(range(alphas.shape[0])):
        term0 = torch.clamp(beta + emit_next[t], min=LOG_EPS)
        term1 = _shift_left(term0, LOG_EPS)
        term2 = torch.where(skip, _shift_left(term1, LOG_EPS), LOG_EPS)
        beta = torch.where(fv_next[t][:, None] > 0.5, _lse3(term0, term1, term2), beta)
        demit[t] = -torch.exp(torch.clamp(alphas[t] + beta - logp[:, None], max=0.0))
    return demit


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built on first use) with its C signatures."""
    lib = _build.load("ctc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpuasr_ctc_alpha.argtypes = [p] * 6 + [i] * 3 + [p]
    lib.tpuasr_ctc_alpha.restype = ctypes.c_int
    lib.tpuasr_ctc_beta.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.tpuasr_ctc_beta.restype = ctypes.c_int
    lib.tpuasr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(what: str, ref: torch.Tensor, **tensors) -> None:
    """Every tensor f32, contiguous and on ref's CUDA device, with the
    shape given beside it."""
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch(fn_name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        msg = lib.tpuasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} kernel launch failed: {msg} ({err})")


def ctc_alpha(emit, allow_skip, valid_s, frame_valid, alpha0):
    """Alpha recursion: (T, B, S) -> alphas (T, B, S), arguments as
    ``ctc_alpha_reference``. CUDA tensors run the Hopper kernel (one
    launch, counted in ``ctc_alpha.launches``); CPU tensors run the
    plain version."""
    if emit.device.type == "cpu":
        return ctc_alpha_reference(emit, allow_skip, valid_s, frame_valid, alpha0)
    if emit.device.type != "cuda":
        raise ValueError(f"ctc_alpha runs on cuda or cpu, not {emit.device}")
    if emit.dim() != 3 or emit.shape[0] == 0:
        raise ValueError(f"emit must be (T>0, B, S), got {tuple(emit.shape)}")
    t, b, s = emit.shape
    _check("ctc_alpha", emit, emit=(emit, (t, b, s)),
           allow_skip=(allow_skip, (b, s)), valid_s=(valid_s, (b, s)),
           frame_valid=(frame_valid, (t, b)), alpha0=(alpha0, (b, s)))
    alphas = torch.empty_like(emit)
    if alphas.numel() == 0:
        return alphas
    with torch.cuda.device(emit.device):
        stream = torch.cuda.current_stream(emit.device).cuda_stream
        _launch("tpuasr_ctc_alpha", emit.data_ptr(), allow_skip.data_ptr(),
                valid_s.data_ptr(), frame_valid.data_ptr(), alpha0.data_ptr(),
                alphas.data_ptr(), t, b, s, stream)
    ctc_alpha.launches += 1
    return alphas


ctc_alpha.launches = 0


def ctc_beta(emit_next, skip2, fv_next, beta_init, alphas, logp):
    """Beta recursion -> dL/demit (T, B, S), arguments as
    ``ctc_beta_reference``. CUDA tensors run the Hopper kernel (one
    launch, counted in ``ctc_beta.launches``); CPU tensors run the plain
    version."""
    if alphas.device.type == "cpu":
        return ctc_beta_reference(emit_next, skip2, fv_next, beta_init, alphas, logp)
    if alphas.device.type != "cuda":
        raise ValueError(f"ctc_beta runs on cuda or cpu, not {alphas.device}")
    if alphas.dim() != 3:
        raise ValueError(f"alphas must be (T, B, S), got {tuple(alphas.shape)}")
    t, b, s = alphas.shape
    _check("ctc_beta", alphas, emit_next=(emit_next, (t, b, s)),
           skip2=(skip2, (b, s)), fv_next=(fv_next, (t, b)),
           beta_init=(beta_init, (b, s)), alphas=(alphas, (t, b, s)),
           logp=(logp, (b,)))
    demit = torch.empty_like(alphas)
    if demit.numel() == 0:
        return demit
    with torch.cuda.device(alphas.device):
        stream = torch.cuda.current_stream(alphas.device).cuda_stream
        _launch("tpuasr_ctc_beta", emit_next.data_ptr(), skip2.data_ptr(),
                fv_next.data_ptr(), beta_init.data_ptr(), alphas.data_ptr(),
                logp.data_ptr(), demit.data_ptr(), t, b, s, stream)
    ctc_beta.launches += 1
    return demit


ctc_beta.launches = 0


def _loss_from_alphas(alphas, end_mask):
    """(T, B, S) alphas + (B, S) final-state mask -> (B,) logp."""
    final = alphas[-1] + torch.where(end_mask > 0.5, 0.0, LOG_EPS)
    m_safe = torch.clamp(final.max(dim=1).values, min=LOG_EPS)
    logp = m_safe + torch.log(torch.exp(final - m_safe[:, None]).sum(dim=1))
    return torch.clamp(logp, min=LOG_EPS)


class CTCFromEmit(torch.autograd.Function):
    """Per-utterance CTC NLL from log-emissions ``emit`` (T, B, S), with
    ``init_mask``, ``allow_skip``, ``valid_s``, ``end_mask`` (B, S) and
    ``frame_valid`` (T, B); the gradient flows to ``emit`` only."""

    @staticmethod
    def forward(ctx, emit, init_mask, allow_skip, valid_s, frame_valid, end_mask):
        alpha0 = torch.clamp(init_mask + emit[0], min=LOG_EPS)
        alphas = ctc_alpha(emit, allow_skip, valid_s, frame_valid, alpha0)
        logp = _loss_from_alphas(alphas, end_mask)
        ctx.save_for_backward(emit, allow_skip, frame_valid, end_mask, alphas, logp)
        return -logp

    @staticmethod
    def backward(ctx, dloss):
        emit, allow_skip, frame_valid, end_mask, alphas, logp = ctx.saved_tensors
        emit_next = torch.cat([emit[1:], torch.full_like(emit[:1], LOG_EPS)]).contiguous()
        fv_next = torch.cat([frame_valid[1:], torch.zeros_like(frame_valid[:1])]).contiguous()
        skip2 = _shift_left(_shift_left(allow_skip, 0.0), 0.0).contiguous()
        beta_init = torch.where(end_mask > 0.5, 0.0, LOG_EPS).to(torch.float32)
        demit = ctc_beta(emit_next, skip2, fv_next, beta_init, alphas, logp)
        demit = demit * frame_valid[:, :, None] * dloss[None, :, None]
        return demit, None, None, None, None, None
