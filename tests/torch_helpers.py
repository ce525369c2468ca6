"""Shared helpers of the tpuasr_torch parity tests (test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def gru_inputs(rng, t, b, h, nd=2, lengths=None, n_gates=3):
    """Seeded numpy inputs of the fused GRU (or, with ``n_gates=4``, the
    fused LSTM): xg (T, D, B, GH), w_h (D, H, GH), b_h (D, GH), mask
    (T, D, B) with direction 1 in the time-flipped layout (valid where
    t >= T - len)."""
    g = n_gates
    xg = (rng.randn(t, nd, b, g * h) * 0.5).astype(np.float32)
    w_h = (rng.randn(nd, h, g * h) * 0.3).astype(np.float32)
    b_h = (rng.randn(nd, g * h) * 0.1).astype(np.float32)
    if lengths is None:
        lengths = rng.randint(0, t + 1, size=(b,))
    lengths = np.asarray(lengths)
    m_fwd = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    m_bwd = (np.arange(t)[:, None] >= (t - lengths)[None, :]).astype(np.float32)
    mask = np.stack([m_fwd, m_bwd][:nd], axis=1)
    return xg, w_h, b_h, mask


def gate_major(xg, w_h, b_h):
    """K1's (T, D, B, 3H) / (D, H, 3H) / (D, 3H) arrays relaid out as
    K5's gate-major (T, D, 3, B, H) / (D, 3, H, H) / (D, 3, H)."""
    t, nd, b, g3 = xg.shape
    h = g3 // 3
    return (np.ascontiguousarray(xg.reshape(t, nd, b, 3, h).transpose(0, 1, 3, 2, 4)),
            np.ascontiguousarray(w_h.reshape(nd, h, 3, h).transpose(0, 2, 1, 3)),
            np.ascontiguousarray(b_h.reshape(nd, 3, h)))
