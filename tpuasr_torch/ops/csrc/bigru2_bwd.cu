// Fused bidirectional GRU time loop in the gate-major layout, backward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/gru2.py:_bwd_kernel (launched by
// _bwd at gru2.py:217). Its math is K1b's exactly (bigru_bwd.cu): hg
// recomputed from the bf16 h_{t-1}, dL/dh carried in f32, the product
// with w_h^T taken from the unrounded f32 [dr_pre, dz_pre, dhn], masked
// frames passing dh through, only the emitted gradients rounded. It
// emits them gate-major: dg (T, D, 4, B, H) = [dr_pre, dz_pre, dn_pre,
// dhn] * m in xg's dtype.
//
// Layouts (all contiguous): xg (T, D, 3, B, H), w_h (D, 3, H, H),
// b_h (D, 3, H) f32, mask (T, D, B) f32, h_prev and dy (T, D, B, H) ->
// dg (T, D, 4, B, H); scratch carry (D, B, H), dhg (D, B, 3H) and
// direct (D, B, H), all f32.
//
// Bound: K1b's work, 125 us at T=251, B=32, H=800, D=2 on the bf16
// tensor cores (operations).
//
// Design. K1b's compiled body (rnn.cuh: gru_bwd_gates, then
// rnn_bwd_carry) with the gate-major strides for xg, w_h and dg: two
// launches per reverse step, the same FMAs in the same order, so K5b
// equals K1b bit for bit on the same weights.

#include "rnn.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h, h_prev, dy and dg share
// it). Returns cudaGetLastError() after the launches.
int tpuasr_bigru2_bwd(const void* xg, const void* w_h, const float* b_h,
                      const float* mask, const void* h_prev, const void* dy,
                      void* dg, float* carry, float* dhg, float* direct,
                      int T_len, int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t h = H;
  const GateStrides xs{3 * B * h, h, B * h};  // (D, 3, B, H)
  const WLayout wl{H, H * H};                 // (3, H, H)
  const GateStrides ps{4 * B * h, h, B * h};  // (D, 4, B, H)
  if (dtype == 0)
    return gru_bwd_all<float>(xg, xs, w_h, wl, b_h, mask, h_prev, dy, dg, ps,
                              carry, dhg, direct, T_len, D, B, H, s);
  if (dtype == 1)
    return gru_bwd_all<__nv_bfloat16>(xg, xs, w_h, wl, b_h, mask, h_prev, dy,
                                      dg, ps, carry, dhg, direct, T_len, D, B,
                                      H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
