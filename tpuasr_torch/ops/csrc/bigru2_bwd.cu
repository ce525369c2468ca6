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
// dg (T, D, 4, B, H); scratch as K1b's.
//
// Bound: K1b's work, 125 us at T=251, B=32, H=800, D=2 on the bf16
// tensor cores (operations).
//
// Design. K1b's two kernels (rnn_bwd.cuh) with the gate-major strides for
// xg, w_h and dg. The hg GEMM reads w_h through the layout's strides into
// the same tiles, and the loop pins w_h's rows in K1's column order, so
// every product and sum runs in K1b's order: K5b equals K1b bit for bit
// on the same weights.

#include "rnn_bwd.cuh"

extern "C" {

// As tpuasr_bigru_bwd_hg, for w_h (D, 3, H, H).
int tpuasr_bigru2_bwd_hg(const void* h_prev, const void* w_h, const float* b_h, float* hg,
                         int T_len, int D, int B, int H, int HP, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  return bwd_hg(h_prev, w_h, WLayout{H, H * H}, b_h, hg, T_len, D, B, H, 3, HP, dtype,
                static_cast<cudaStream_t>(stream));
}

// As tpuasr_bigru_bwd_loop, for xg (T, D, 3, B, H), w_h (D, 3, H, H)
// and dg (T, D, 4, B, H).
int tpuasr_bigru2_bwd_loop(const void* xg, const void* w_h, const float* mask,
                           const void* h_prev, const void* c_prev, const void* cs,
                           const void* dy, const float* hg, void* dg, float* dhg,
                           unsigned int* bar, long long* timer, const int* layout, int T_len,
                           int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  return bwd_loop<3>(xg, GateStrides{3 * B * h, h, B * h}, w_h, WLayout{H, H * H}, mask,
                     h_prev, c_prev, cs, dy, hg, dg, GateStrides{4 * B * h, h, B * h}, dhg,
                     bar, timer, layout, T_len, D, B, H, dtype,
                     static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
