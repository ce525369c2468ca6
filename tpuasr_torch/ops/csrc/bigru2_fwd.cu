// Fused bidirectional GRU time loop in the gate-major layout, forward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/gru2.py:_fwd_kernel (launched by
// _fwd at gru2.py:176). Its math is K1f's exactly (bigru_fwd.cu): gates
// [r, z, n], products and b_h in f32, the carried h rounded to xg's
// dtype every step, masked frames carrying h through. Only the layout
// differs: the TPU kernel keeps every gate as its own (B, H) plane so
// that Mosaic never cuts a (B, 3H) row at H=800, which is not a multiple
// of its 128-lane tiles.
//
// Layouts (all contiguous): xg (T, D, 3, B, H), w_h (D, 3, H, H) with
// w_h[d, g, k, j], b_h (D, 3, H) f32, mask (T, D, B) f32 -> ys
// (T, D, B, H); D in {1, 2}, any T, B, H. T is float or __nv_bfloat16.
//
// Bound: K1f's work, 62 us at T=251, B=32, H=800, D=2 on the bf16 tensor
// cores (operations).
//
// Design. On Hopper no layout forces a relayout, so K5f runs K1f's
// compiled body (rnn.cuh: gru_fwd_step) with the gate-major strides:
// the same loads, the same FMAs in the same order. K5f therefore equals
// K1f bit for bit on the same weights, and every later speed-up of K1f
// is K5f's too.

#include "rnn.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h and ys share it).
// Returns cudaGetLastError() after the launches (0 = success).
int tpuasr_bigru2_fwd(const void* xg, const void* w_h, const float* b_h,
                      const float* mask, void* ys, int T_len, int D, int B,
                      int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t h = H;
  const GateStrides xs{3 * B * h, h, B * h};  // (D, 3, B, H)
  const WLayout wl{H, H * H};                 // (3, H, H)
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
