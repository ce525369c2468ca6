// Fused bidirectional vanilla (tanh) RNN time loop, forward, for NVIDIA
// Hopper (sm_90a): K6f. The port's own kernel; the JAX package runs this
// layer as a lax.scan under every rnn_impl and has no TPU kernel for it.
//
// Computes, for every direction d, row b and unit j (the reference's
// nn.RNN layer, tanh, with the directions summed by the caller):
//   hg  = h_{t-1} @ w_h[d] + b_h[d]          (products and sum in f32)
//   h'  = tanh(xg_t + hg)
//   h_t = round_to_xg_dtype(m * h' + (1 - m) * h_{t-1})
// The carried h is rounded to xg's dtype every step, as in K1f, and a
// masked frame carries h through; callers re-mask the outputs.
//
// Layouts (all contiguous): xg (T, D, B, H), w_h (D, H, H), b_h (D, H) f32,
// mask (T, D, B) f32 -> ys (T, D, B, H); D in {1, 2}, any T, B, H. T is
// float or __nv_bfloat16.
//
// Bound. Per step D (B x H) @ (H x H) products: at T=826, B=32, H=1280, D=2
// 173 GFLOP, 175 us on the bf16 tensor cores, against 0.28 GB of xg, ys,
// w_h and mask traffic (83 us at 3.35 TB/s): operations bound it, and the
// loop is strictly sequential, each step far too small to fill the card.
//
// Design: K1f's persistent loop (rnn_fwd.cuh) with one gate. At H=1280 the
// 160 slices of 16 units go two a block, 80 blocks, each with its 2 x 16
// columns of w_h pinned (82 KB in bf16); one grid barrier a step.

#include "rnn_fwd.cuh"

extern "C" {

// As tpuasr_bigru_fwd, with xg (T, D, B, H) and w_h (D, H, H).
int tpuasr_birnn_fwd(const void* xg, const void* w_h, const float* b_h, const float* mask,
                     void* ys, unsigned int* bar, long long* timer, const int* layout,
                     int T_len, int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  return fwd_loop<1>(xg, GateStrides{B * h, h, h}, w_h, WLayout{H, H}, b_h, mask, ys, nullptr,
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
