// Fused bidirectional LSTM time loop, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/lstm.py:_bwd_kernel (launched by
// _bilstm_bwd at lstm.py:236) and computes exactly what it computes, in
// reverse time, for every direction d, row b and unit j:
//   hg   = h_{t-1} @ w_h[d] + b_h[d]      (recomputed; products in f32)
//   i, f, g, o from xg_t and hg as in the forward
//   tc   = tanh(cs_t)                     (of the ROUNDED cell state)
//   dh   = carry_h + dy_t,  dc = carry_c  (both carried in f32)
//   do = dh tc,  dct = dc + dh o (1 - tc^2)
//   di = dct g,  df = dct c_{t-1},  dg = dct i,  dc_prev = dct f
//   dhg  = [di i (1 - i), df f (1 - f), dg (1 - g^2), do o (1 - o)] * m
//   dhg_t (emitted) = round_to_T(dhg)     (== dxg_t)
//   carry_h <- m (dhg @ w_h[d]^T) + (1 - m) dh
//   carry_c <- m dc_prev + (1 - m) dc
// The backward never sees the forward's f32 cell state: c_{t-1} is cs
// shifted by a step and tanh is taken of the rounded cs_t, as the TPU
// kernel reads them. The product with w_h^T is taken from the unrounded
// f32 dhg (bf16 hi + lo halves on the tensor cores, ~2^-16 relative), and
// masked frames pass dh and dc through unchanged.
//
// Layouts (all contiguous): xg (T, D, B, 4H), w_h (D, H, 4H), b_h (D, 4H)
// f32, mask (T, D, B) f32; h_prev, c_prev, cs, dy (T, D, B, H) -> dhg
// (T, D, B, 4H); scratch hg (T, D, B, 4, HP) f32, dhg_buf (2, D, B, GP)
// 4-byte words zeroed (rnn_bwd.cuh: put_dhg), and a zeroed barrier
// counter. D in {1, 2}; any T, B, H. T
// is float or __nv_bfloat16 (xg, w_h, h_prev, c_prev, cs, dy and dhg
// share it).
//
// Bound. 2 (B x H) @ (H x 4H) products per step and direction (hg, then
// dhg @ w_h^T): at T=251, B=32, H=800, D=2 164.5 GFLOP, 166 us on the
// bf16 tensor cores, against 319 MB of traffic (95 us at 3.35 TB/s):
// operations bound it.
//
// Design: K1b's two kernels (rnn_bwd.cuh) with four gates. The dc carry
// is elementwise and stays in the owning block's shared memory beside
// the dh carry; a block pins 16 rows of w_h (102.4 KB in bf16).

#include "rnn_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (h_prev, w_h). hg: (T, D, B, 4, HP)
// f32. Returns cudaGetLastError() after the launch.
int tpuasr_bilstm_bwd_hg(const void* h_prev, const void* w_h, const float* b_h, float* hg,
                         int T_len, int D, int B, int H, int HP, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  return bwd_hg(h_prev, w_h, WLayout{4 * H, H}, b_h, hg, T_len, D, B, H, 4, HP, dtype,
                static_cast<cudaStream_t>(stream));
}

// The reverse loop; layout is rnn_plan.BwdPlan.as_ints(). Returns the
// launch's error code, or cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be co-resident.
int tpuasr_bilstm_bwd_loop(const void* xg, const void* w_h, const float* mask,
                           const void* h_prev, const void* c_prev, const void* cs,
                           const void* dy, const float* hg, void* dhg, float* dhg_buf,
                           unsigned int* bar, long long* timer, const int* layout, int T_len,
                           int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  const GateStrides s{B * 4 * h, 4 * h, h};  // (D, B, 4H)
  return bwd_loop<4>(xg, s, w_h, WLayout{4 * H, H}, mask, h_prev, c_prev, cs, dy, hg, dhg,
                     s, dhg_buf, bar, timer, layout, T_len, D, B, H, dtype,
                     static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
