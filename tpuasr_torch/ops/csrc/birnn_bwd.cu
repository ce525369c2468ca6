// Fused bidirectional vanilla (tanh) RNN time loop, backward, for NVIDIA
// Hopper (sm_90a): K6b. The port's own kernel (no TPU kernel exists for
// this layer).
//
// Computes, in reverse time, for every direction d, row b and unit j:
//   dh     = carry + dy_t                  (carry: dL/dh_t, f32)
//   dpre   = dh (1 - y_t^2) m              (y_t = ys[t], as the forward
//                                           rounded it; f32)
//   out_t  = round_to_T(dpre)              (== dxg_t)
//   carry <- m (dpre @ w_h[d]^T) + (1 - m) dh
// so a masked frame passes dh through unchanged. The product with w_h^T is
// taken from the unrounded f32 dpre (bf16 hi + lo halves on the tensor
// cores, ~2^-16 relative), as in K1b and K4b. No hg is recomputed: the
// derivative of tanh needs only its output, so this is the shared loop
// alone, one launch a call (rnn_bwd.cuh, NG = 1).
//
// Layouts (all contiguous): ys, dy (T, D, B, H), w_h (D, H, H), mask
// (T, D, B) f32 -> out (T, D, B, H); scratch dhg (2, D, B, GP) 4-byte words
// zeroed (rnn_bwd.cuh: put_dhg), and a zeroed barrier counter. D in {1, 2};
// any T, B, H. T is float or __nv_bfloat16 (ys, dy, w_h and out share it).
//
// Bound. One (B x H) @ (H x H) product a step and direction: at T=826,
// B=32, H=1280, D=2 173 GFLOP, 175 us on the bf16 tensor cores, against
// 0.41 GB of ys, dy, out, w_h and mask traffic (123 us at 3.35 TB/s):
// operations bound it.

#include "rnn_bwd.cuh"

extern "C" {

// The reverse loop; the signature of the other backward libraries' loops.
// xg, c_prev, cs and hg are unused (pass null); h_prev is ys itself, not
// shifted. layout is rnn_plan.BwdPlan.as_ints(). Returns the launch's error
// code, or cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident.
int tpuasr_birnn_bwd_loop(const void* xg, const void* w_h, const float* mask, const void* ys,
                          const void* c_prev, const void* cs, const void* dy, const float* hg,
                          void* out, float* dhg, unsigned int* bar, long long* timer,
                          const int* layout, int T_len, int D, int B, int H, int dtype,
                          void* stream) {
  using namespace tpuasr_rnn;
  (void)xg, (void)c_prev, (void)cs, (void)hg;
  const size_t h = H;
  const GateStrides s{B * h, h, h};  // (D, B, H)
  return bwd_loop<1>(nullptr, s, w_h, WLayout{H, H}, mask, ys, nullptr, nullptr, dy, nullptr,
                     out, s, dhg, bar, timer, layout, T_len, D, B, H, dtype,
                     static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
