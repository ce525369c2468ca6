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
// sequential, though, and one step is far too small to fill the card:
// what bounds a step in practice is the grid-wide exchange of h_t.
//
// Design (rnn_fwd.cuh, shared with K5f and K4f): one persistent,
// cooperative launch per call. 100 blocks at the flagship shape, each
// owning 16 units of one direction with their 3 x 16 columns of w_h
// pinned in shared memory (76.8 KB) for the whole call; per step one grid
// barrier, each block's read of its direction's h_{t-1} (51.2 KB of
// ys[t-1]) from L2, the product on mma.sync m16n8k16 (600 tiles a block)
// and the gate math in registers. It replaced one launch per step, whose
// blocks re-read w_h from L2 and ran the product on f32 FMAs (PERF.md).

#include "rnn_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h and ys share it). bar: one
// zeroed uint32; timer: null or (n_blocks, 5) int64; layout:
// rnn_plan.FwdPlan.as_ints(). Returns cudaGetLastError() after the launch
// (0 = success), or the refusal of a grid that cannot be co-resident.
int tpuasr_bigru_fwd(const void* xg, const void* w_h, const float* b_h, const float* mask,
                     void* ys, unsigned int* bar, long long* timer, const int* layout,
                     int T_len, int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  return fwd_loop<3>(xg, GateStrides{B * 3 * h, 3 * h, h}, w_h, WLayout{3 * H, H}, b_h, mask,
                     ys, nullptr, bar, timer, layout, T_len, D, B, H, dtype,
                     static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
