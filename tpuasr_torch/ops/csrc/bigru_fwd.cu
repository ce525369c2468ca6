// Fused bidirectional GRU time loop, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/gru.py:_fwd_kernel (launched by
// bigru_pallas at gru.py:201) and computes exactly what it computes:
//   hg  = h_{t-1} @ w_h[d] + b_h[d]          (products and sum in f32)
//   r   = sigmoid(xr + hr), z = sigmoid(xz + hz)
//   n   = tanh(xn + r * hn)
//   h'  = (1 - z) * n + z * h_{t-1}
//   h_t = round_to_xg_dtype(m * h' + (1 - m) * h_{t-1})
// Gate order [r, z, n] (PyTorch/cuDNN). The carried h is rounded to the
// dtype of xg every step (the TPU kernel's scratch is xg.dtype), and a
// masked frame carries h through; callers re-mask the outputs.
//
// Layouts (all contiguous): xg (T, D, B, 3H), w_h (D, H, 3H),
// b_h (D, 3H) f32, mask (T, D, B) f32 -> ys (T, D, B, H); D in {1, 2},
// any T, B, H. T is float or __nv_bfloat16.
//
// Bound. Per step the work is D (B x H) @ (H x 3H) products: at the
// serving shape (T=251, B=32, H=800, D=2) 61.7 GFLOP in all, 62 us on
// the bf16 tensor cores, against 110.6 MB of xg/ys/w_h/mask traffic
// (33 us at 3.35 TB/s) — operations bound it. The time loop is strictly
// sequential, though, and one step is far too small to fill the card.
//
// Design (the simple first version; rnn.cuh holds the body it shares
// with K5f and K4f). One launch per time step covers both directions;
// the stream orders the steps, and step t reads ys[t-1] as its h, so no
// block exchanges anything within a step. A block owns 16 hidden units
// of one direction for 32 batch rows: h_{t-1} staged in shared memory as
// f32, the k reduction split over 8 warps, w_h read from L2, CUDA-core
// f32 FMAs. Its FMAs alone would take ~5 us a step on 100 SMs; on an
// H100 a step takes ~29 us (PERF.md). Left for later: a persistent
// kernel with w_h pinned in shared memory across the SMs, a grid
// barrier per step, and tensor-core products.

#include "rnn.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h and ys share it).
// Returns cudaGetLastError() after the launches (0 = success).
int tpuasr_bigru_fwd(const void* xg, const void* w_h, const float* b_h,
                     const float* mask, void* ys, int T_len, int D, int B,
                     int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t h = H;
  const GateStrides xs{B * 3 * h, 3 * h, h};  // (D, B, 3H)
  const WLayout wl{3 * H, H};                 // (H, 3H)
  if (dtype == 0)
    return gru_fwd_all<float>(xg, xs, w_h, wl, b_h, mask, ys, T_len, D, B, H, s);
  if (dtype == 1)
    return gru_fwd_all<__nv_bfloat16>(xg, xs, w_h, wl, b_h, mask, ys, T_len, D,
                                      B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
