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
// compiled loop (rnn_fwd.cuh: rnn_fwd_loop) with the gate-major strides:
// the loop pins w_h's columns in K1's order and reads xg through its
// strides, so every load, product and sum is K1f's. K5f therefore equals
// K1f bit for bit on the same weights, and every later speed-up of K1f
// is K5f's too.

#include "rnn_fwd.cuh"

extern "C" {

// As tpuasr_bigru_fwd, for xg (T, D, 3, B, H) and w_h (D, 3, H, H).
int tpuasr_bigru2_fwd(const void* xg, const void* w_h, const float* b_h, const float* mask,
                      void* ys, unsigned int* bar, long long* timer, const int* layout,
                      int T_len, int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  return fwd_loop<3>(xg, GateStrides{3 * B * h, h, B * h}, w_h, WLayout{H, H * H}, b_h, mask,
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
