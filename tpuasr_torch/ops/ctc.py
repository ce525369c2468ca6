"""CTC forward-backward recursions (port of ``tpuasr/ops/ctc.py``).

``ctc_alpha`` wraps the hand-written Hopper kernel ``csrc/ctc.cu``'s
alpha recursion, which replaces ``tpuasr/ops/ctc.py:_alpha_kernel``;
``ctc_beta`` wraps its beta recursion, which replaces ``_beta_kernel``
together with the work ``_bwd`` does around it: it takes the unshifted
emissions, frame mask and skip mask, forms beta's start from
``end_mask``, and returns the finished dL/demit, masked by the frame
mask and scaled by the cotangent. ``ctc_alpha_reference`` and
``ctc_beta_reference`` are their plain PyTorch versions with the same
arithmetic (the shift, mask and scale written out). The wrappers use the
plain versions only for CPU tensors; on a CUDA tensor they launch the
kernel or raise, and an S whose two rows do not fit a block's shared
memory (~29,000 on an H100) raises before any launch.

``CTCFromEmit`` is the port of ``ctc_loss_from_emit``: per-utterance
NLL from log-emissions, its gradient the forward-backward identity
dL/demit_t(s) = -exp(alpha_t(s) + beta_t(s) - logp). ``alpha0`` and the
loss from the last alphas are formed in torch, as in the JAX package.
All masks are float 0/1 (``init_mask`` is additive: 0 or LOG_EPS).
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


def ctc_beta_reference(emit, allow_skip, frame_valid, end_mask, alphas, logp, dloss):
    """Plain reverse-time beta recursion -> dL/demit (T, B, S), as the
    JAX package's ``_bwd`` forms it: its kernel's recursion on the inputs
    shifted by one frame (emit[t+1], LOG_EPS past the last frame;
    frame_valid[t+1], 0 past it; allow_skip[s+2]), beta starting at 0 on
    ``end_mask`` and LOG_EPS elsewhere, then times frame_valid[t] and the
    cotangent ``dloss`` (B,). logp is (B,)."""
    emit_next = torch.cat([emit[1:], torch.full_like(emit[:1], LOG_EPS)])
    fv_next = torch.cat([frame_valid[1:], torch.zeros_like(frame_valid[:1])])
    skip = _shift_left(_shift_left(allow_skip, 0.0), 0.0) > 0.5
    beta = torch.where(end_mask > 0.5, 0.0, LOG_EPS).to(alphas.dtype)
    demit = torch.empty_like(alphas)
    for t in reversed(range(alphas.shape[0])):
        term0 = torch.clamp(beta + emit_next[t], min=LOG_EPS)
        term1 = _shift_left(term0, LOG_EPS)
        term2 = torch.where(skip, _shift_left(term1, LOG_EPS), LOG_EPS)
        beta = torch.where(fv_next[t][:, None] > 0.5, _lse3(term0, term1, term2), beta)
        demit[t] = -torch.exp(torch.clamp(alphas[t] + beta - logp[:, None], max=0.0))
    return demit * frame_valid[:, :, None] * dloss[None, :, None]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built on first use) with its C signatures."""
    lib = _build.load("ctc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpuasr_ctc_plan.argtypes = [i] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.tpuasr_ctc_plan.restype = ctypes.c_int
    lib.tpuasr_ctc_alpha.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.tpuasr_ctc_alpha.restype = ctypes.c_int
    lib.tpuasr_ctc_beta.argtypes = [p] * 9 + [i] * 4 + [p]
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


CTC_PARTS = ("inputs", "lse3", "store", "exchange", "loop")  # the C side's timer columns
# A list to split K2a's and K2b's step: each launch appends {"kernel":
# "alpha" or "beta", "timer": (B, len(CTC_PARTS)) int64 tensor of clock64
# sums over the steps (thread 0 of each block), "T": the call's frames};
# None: no timer (the main path).
ctc_parts: list | None = None


def _timer(kernel: str, b: int, t: int, device):
    """A zeroed timer buffer, recorded in ``ctc_parts``, or None."""
    if ctc_parts is None:
        return None
    timer = torch.zeros((b, len(CTC_PARTS)), dtype=torch.int64, device=device)
    ctc_parts.append({"kernel": kernel, "timer": timer, "T": t})
    return timer


def _raise_on(lib, err: int, fn_name: str) -> None:
    if err != 0:
        msg = lib.tpuasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} kernel launch failed: {msg} ({err})")


def ctc_plan(kind: str, t: int, s: int, device, slots: int = 0) -> dict:
    """The C side's launch plan for ``kind`` ("alpha" or "beta", which
    share it) at (T, S) on the CUDA ``device``: slots a thread (J),
    threads, shared memory bytes. ``slots`` (0: the kernel's default, one
    slot a thread up to S = 1024) is for measurements and tests. Launches
    nothing; raises ValueError with the reason when S does not fit: two
    rows of S floats and the frame mask in a block's shared memory (S up
    to ~29,000 on an H100)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return dict(_plan(kind, t, s, index, slots))


@functools.lru_cache(maxsize=256)
def _plan(kind: str, t: int, s: int, index: int, slots: int) -> tuple:
    lib = _lib()
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(index):
        err = lib.tpuasr_ctc_plan(t, s, slots, out)
    _raise_on(lib, err, "tpuasr_ctc_plan")
    j, threads, smem, optin = out
    if j == 0:
        raise ValueError(
            f"ctc_{kind}: S={s} does not fit: two rows of S floats and the frame mask "
            f"need {smem} bytes of shared memory, and a block of this card has {optin}")
    return (("slots", j), ("threads", threads), ("smem", smem))


def ctc_alpha(emit, allow_skip, valid_s, frame_valid, alpha0, *, _slots=0):
    """Alpha recursion: (T, B, S) -> alphas (T, B, S), arguments as
    ``ctc_alpha_reference``. CUDA tensors run the Hopper kernel (one
    launch, counted in ``ctc_alpha.launches``); CPU tensors run the plain
    version. ``_slots`` overrides the launch plan's slots a thread
    (``ctc_plan``), for measurements and tests."""
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
    ctc_plan("alpha", t, s, emit.device, _slots)
    timer = _timer("alpha", b, t, emit.device)
    lib = _lib()
    with torch.cuda.device(emit.device):
        stream = torch.cuda.current_stream(emit.device).cuda_stream
        err = lib.tpuasr_ctc_alpha(
            emit.data_ptr(), allow_skip.data_ptr(), valid_s.data_ptr(),
            frame_valid.data_ptr(), alpha0.data_ptr(), alphas.data_ptr(),
            None if timer is None else timer.data_ptr(), t, b, s, _slots, stream)
    _raise_on(lib, err, "tpuasr_ctc_alpha")
    ctc_alpha.launches += 1
    return alphas


ctc_alpha.launches = 0


def ctc_beta(emit, allow_skip, frame_valid, end_mask, alphas, logp, dloss, *, _slots=0):
    """Beta recursion -> the finished dL/demit (T, B, S), arguments as
    ``ctc_beta_reference``. CUDA tensors run the Hopper kernel (one
    launch, counted in ``ctc_beta.launches``); CPU tensors run the plain
    version. ``_slots`` as ``ctc_alpha``'s."""
    if alphas.device.type == "cpu":
        return ctc_beta_reference(emit, allow_skip, frame_valid, end_mask, alphas, logp, dloss)
    if alphas.device.type != "cuda":
        raise ValueError(f"ctc_beta runs on cuda or cpu, not {alphas.device}")
    if alphas.dim() != 3 or alphas.shape[0] == 0:
        raise ValueError(f"alphas must be (T>0, B, S), got {tuple(alphas.shape)}")
    t, b, s = alphas.shape
    _check("ctc_beta", alphas, emit=(emit, (t, b, s)), allow_skip=(allow_skip, (b, s)),
           frame_valid=(frame_valid, (t, b)), end_mask=(end_mask, (b, s)),
           alphas=(alphas, (t, b, s)), logp=(logp, (b,)), dloss=(dloss, (b,)))
    demit = torch.empty_like(alphas)
    if demit.numel() == 0:
        return demit
    ctc_plan("beta", t, s, alphas.device, _slots)
    timer = _timer("beta", b, t, alphas.device)
    lib = _lib()
    with torch.cuda.device(alphas.device):
        stream = torch.cuda.current_stream(alphas.device).cuda_stream
        err = lib.tpuasr_ctc_beta(
            emit.data_ptr(), allow_skip.data_ptr(), frame_valid.data_ptr(),
            end_mask.data_ptr(), alphas.data_ptr(), logp.data_ptr(), dloss.data_ptr(),
            demit.data_ptr(), None if timer is None else timer.data_ptr(), t, b, s, _slots,
            stream)
    _raise_on(lib, err, "tpuasr_ctc_beta")
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
    ``frame_valid`` (T, B); the gradient flows to ``emit`` only. The
    forward runs K2a (``ctc_alpha``) and the loss from the last alphas;
    the backward is one call of K2b (``ctc_beta``), which takes the
    saved inputs as they are and returns the gradient already masked by
    ``frame_valid`` and scaled by the cotangent."""

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
        dloss = dloss.to(torch.float32).contiguous()
        demit = ctc_beta(emit, allow_skip, frame_valid, end_mask, alphas, logp, dloss)
        return demit, None, None, None, None, None
