// Fused bidirectional GRU time loop, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/gru.py:_bwd_kernel (launched by
// _bigru_bwd at gru.py:243) and computes exactly what it computes, in
// reverse time, for every direction d, row b and unit j:
//   hg   = h_{t-1} @ w_h[d] + b_h[d]      (recomputed; products in f32)
//   r, z, n from xg_t and hg as in the forward ([r, z, n] gate order)
//   dh   = carry + dy_t                   (carry: dL/dh_t, f32)
//   dn = dh (1 - z), dz = dh (h_{t-1} - n), dn_pre = dn (1 - n^2)
//   dr_pre = dn_pre hn r (1 - r), dz_pre = dz z (1 - z), dhn = dn_pre r
//   dhg  = [dr_pre, dz_pre, dhn] * m      (kept in f32)
//   packed_t = round([dr_pre, dz_pre, dn_pre, dhn] * m)   (xg's dtype)
//   carry <- m (dhg @ w_h[d]^T + dh z m) + (1 - m) dh
// so a masked frame passes dh through unchanged, and the product with
// w_h^T is taken from the unrounded f32 dhg (the TPU kernel's dot_general
// of f32 dhg with bf16 w_h; here bf16 hi + lo halves of dhg on the tensor
// cores, ~2^-16 relative). h_{t-1} is the forward's ys shifted by one step
// (h_0 = 0), given by the caller.
//
// Layouts (all contiguous): xg (T, D, B, 3H), w_h (D, H, 3H),
// b_h (D, 3H) f32, mask (T, D, B) f32, h_prev and dy (T, D, B, H) ->
// packed (T, D, B, 4H); scratch hg (T, D, B, 3, HP) f32, dhg (2, D, B, GP)
// 4-byte words zeroed (rnn_bwd.cuh: put_dhg), and a zeroed barrier
// counter. D in {1, 2}; any T, B, H. T
// is float or __nv_bfloat16 (xg, w_h, h_prev, dy and packed share it).
//
// Bound. hg and dhg @ w_h^T, 2 (B x H) @ (H x 3H) products per step and
// direction: at the train shape (T=251, B=32, H=800, D=2) 123.4 GFLOP,
// 125 us on the bf16 tensor cores, against 239 MB of traffic (71 us at
// 3.35 TB/s): operations bound it. hg (half of them) has no sequential
// dependence; the carry product (the other half) is a chain of T small
// products, each far too small to fill the card.
//
// Design (rnn_bwd.cuh, shared with K5b and K4b): two launches a call.
// hg_gemm computes hg for every step at once on the tensor cores; then
// one persistent cooperative launch runs the reverse loop, a block per
// 16 units of a direction (100 blocks at the train shape), its 16 rows
// of w_h (76.8 KB) and its carry pinned in shared memory, one grid
// barrier a step between the gate math and the carry product.

#include "rnn_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (h_prev, w_h). hg: (T, D, B, 3, HP)
// f32. Returns cudaGetLastError() after the launch.
int tpuasr_bigru_bwd_hg(const void* h_prev, const void* w_h, const float* b_h, float* hg,
                        int T_len, int D, int B, int H, int HP, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  return bwd_hg(h_prev, w_h, WLayout{3 * H, H}, b_h, hg, T_len, D, B, H, 3, HP, dtype,
                static_cast<cudaStream_t>(stream));
}

// The reverse loop; layout is rnn_plan.BwdPlan.as_ints(). c_prev and cs
// are unused (the LSTM's). Returns the launch's error code, or
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident.
int tpuasr_bigru_bwd_loop(const void* xg, const void* w_h, const float* mask,
                          const void* h_prev, const void* c_prev, const void* cs,
                          const void* dy, const float* hg, void* packed, float* dhg,
                          unsigned int* bar, long long* timer, const int* layout, int T_len,
                          int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  return bwd_loop<3>(xg, GateStrides{B * 3 * h, 3 * h, h}, w_h, WLayout{3 * H, H}, mask,
                     h_prev, c_prev, cs, dy, hg, packed, GateStrides{B * 4 * h, 4 * h, h},
                     dhg, bar, timer, layout, T_len, D, B, H, dtype,
                     static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
