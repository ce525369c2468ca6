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
// w_h^T is taken in f32 from the unrounded dhg (the TPU kernel's
// dot_general of f32 dhg with bf16 w_h). h_{t-1} is the forward's ys
// shifted by one step (h_0 = 0), given by the caller.
//
// Layouts (all contiguous): xg (T, D, B, 3H), w_h (D, H, 3H),
// b_h (D, 3H) f32, mask (T, D, B) f32, h_prev and dy (T, D, B, H) ->
// packed (T, D, B, 4H); scratch carry (D, B, H), dhg (D, B, 3H) and
// direct (D, B, H), all f32. D in {1, 2}; any T, B, H. T is float or
// __nv_bfloat16 (xg, w_h, h_prev, dy and packed share it).
//
// Bound. Per step 2 (B x H) @ (H x 3H) products per direction (hg, then
// dhg @ w_h^T): at the train shape (T=251, B=32, H=800, D=2) 123.4
// GFLOP, 125 us on the bf16 tensor cores, against 239 MB of traffic
// (71 us at 3.35 TB/s): operations bound it. As in the forward, the
// time loop is strictly sequential and one step is far too small to
// fill the card.
//
// Design (the simple first version; the body is rnn.cuh's, shared with
// K5b and, for the carry product, K4b). Two launches per reverse time
// step cover both directions, and the stream orders them, so no block
// exchanges anything within a launch:
//   A (gru_bwd_gates): a block owns 16 units of one direction for 32
//     rows, recomputes hg's three columns of each unit from h_{t-1}
//     staged in shared memory (the k reduction over 8 warps), then a
//     thread per (row, unit) does the gate math and writes packed_t,
//     dhg and direct = m dh z m + (1 - m) dh for the unit.
//   B (rnn_bwd_carry): a block owns 16 units k for 32 rows, stages dhg
//     and reduces over the gate axis, reading w_h[d, k, :] from L2; then
//     carry[k] = sum + direct[k]. B reads nothing A reads from carry,
//     so the carry is updated in place.
// CUDA-core f32 FMAs throughout. Left for later: the persistent,
// tensor-core redesign shared with K1f (ROADMAP.md).

#include "rnn.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h, h_prev, dy and packed share
// it). carry, dhg and direct are f32 scratch of (D, B, H), (D, B, 3H)
// and (D, B, H). Returns cudaGetLastError() after the launches.
int tpuasr_bigru_bwd(const void* xg, const void* w_h, const float* b_h,
                     const float* mask, const void* h_prev, const void* dy,
                     void* packed, float* carry, float* dhg, float* direct,
                     int T_len, int D, int B, int H, int dtype, void* stream) {
  using namespace tpuasr_rnn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t h = H;
  const GateStrides xs{B * 3 * h, 3 * h, h};  // (D, B, 3H)
  const WLayout wl{3 * H, H};                 // (H, 3H)
  const GateStrides ps{B * 4 * h, 4 * h, h};  // (D, B, 4H)
  if (dtype == 0)
    return gru_bwd_all<float>(xg, xs, w_h, wl, b_h, mask, h_prev, dy, packed,
                              ps, carry, dhg, direct, T_len, D, B, H, s);
  if (dtype == 1)
    return gru_bwd_all<__nv_bfloat16>(xg, xs, w_h, wl, b_h, mask, h_prev, dy,
                                      packed, ps, carry, dhg, direct, T_len, D,
                                      B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
