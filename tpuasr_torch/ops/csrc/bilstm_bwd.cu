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
// kernel reads them. The product with w_h^T is taken in f32 from the
// unrounded dhg (the TPU kernel's dot_general of f32 dhg with bf16 w_h),
// and masked frames pass dh and dc through unchanged.
//
// Layouts (all contiguous): xg (T, D, B, 4H), w_h (D, H, 4H), b_h (D, 4H)
// f32, mask (T, D, B) f32; h_prev, c_prev, cs, dy (T, D, B, H) -> dhg
// (T, D, B, 4H); scratch carry_h, carry_c, direct (D, B, H) and dhg_f32
// (D, B, 4H), all f32. D in {1, 2}; any T, B, H. T is float or
// __nv_bfloat16 (xg, w_h, h_prev, c_prev, cs, dy and dhg share it).
//
// Bound. Per step 2 (B x H) @ (H x 4H) products per direction (hg, then
// dhg @ w_h^T): at T=251, B=32, H=800, D=2 164.5 GFLOP, 166 us on the
// bf16 tensor cores, against 319 MB of traffic (95 us at 3.35 TB/s):
// operations bound it.
//
// Design (K1b's, rnn.cuh). Two launches per reverse step for both
// directions, ordered by the stream:
//   A (bilstm_bwd_gates): gate_products with four gates recomputes hg
//     from h_{t-1} staged in shared memory; then a thread per (row, unit)
//     does the elementwise backward, writes dhg_t (rounded) and dhg_f32,
//     updates carry_c in place (elementwise, so no exchange between
//     blocks) and writes direct = (1 - m) dh.
//   B (rnn_bwd_carry over 4H columns): carry_h = dhg_f32 @ w_h[d]^T +
//     direct, reading row k of w_h[d] from L2.
// CUDA-core f32 FMAs throughout; left for later: the persistent,
// tensor-core redesign queued for K1.

#include "rnn.cuh"

namespace {

using namespace tpuasr_rnn;

// Launch A of one reverse step. grid = step_grid, block = NTHREADS,
// dynamic shared memory smem_bytes(kc, 4), kc = staged_columns(H).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bilstm_bwd_gates(const T* __restrict__ xg,          // (D, B, 4H) of step t
                 const T* __restrict__ w_h,         // (D, H, 4H)
                 const float* __restrict__ b_h,     // (D, 4H)
                 const float* __restrict__ m_t,     // (D, B) of step t
                 const T* __restrict__ hp,          // (D, B, H): h_{t-1}
                 const T* __restrict__ cp,          // (D, B, H): c_{t-1}
                 const T* __restrict__ cs,          // (D, B, H): c_t
                 const T* __restrict__ dy,          // (D, B, H) of step t
                 const float* __restrict__ carry_h, // (D, B, H): dL/dh_t
                 float* __restrict__ carry_c,       // (D, B, H): dL/dc_t, in place
                 T* __restrict__ dhg_out,           // (D, B, 4H) of step t
                 float* __restrict__ dhg,           // (D, B, 4H)
                 float* __restrict__ direct,        // (D, B, H)
                 int B, int H, int kc) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JB;
  const int b0 = blockIdx.y * BB;
  const size_t G = 4 * static_cast<size_t>(H);
  const T* w_d = w_h + d * H * G;
  const T* hp_d = hp + static_cast<size_t>(d) * B * H;
  gate_products<T, 4>(smem, hp_d, w_d, WLayout{4 * H, H}, B, H, b0, j0, kc);

  const float* bh = b_h + d * G;
  for (int p = threadIdx.x; p < BB * JB; p += NTHREADS) {
    const int row = p / JB, uu = p % JB;
    const int b = b0 + row, j = j0 + uu;
    if (b >= B || j >= H) continue;
    float s[4] = {bh[j], bh[H + j], bh[2 * H + j], bh[3 * H + j]};
    add_partials<4>(s, smem, row, uu);
    const size_t r = static_cast<size_t>(d) * B + b;
    const size_t e = r * H + j;
    const T* x = xg + r * G + j;
    const float ig = sigmoid_f32(to_f32(x[0]) + s[0]);
    const float fg = sigmoid_f32(to_f32(x[H]) + s[1]);
    const float gg = tanhf(to_f32(x[2 * H]) + s[2]);
    const float og = sigmoid_f32(to_f32(x[3 * H]) + s[3]);
    const float tc = tanhf(to_f32(cs[e]));
    const float m = m_t[r];
    const float dh = carry_h[e] + to_f32(dy[e]);
    const float dc_in = carry_c[e];
    const float do_ = dh * tc;
    const float dct = dc_in + dh * og * (1.0f - tc * tc);
    const float di = dct * gg;
    const float df = dct * to_f32(cp[e]);
    const float dg = dct * ig;
    const float dc_prev = dct * fg;
    const float pre[4] = {di * ig * (1.0f - ig) * m, df * fg * (1.0f - fg) * m,
                          dg * (1.0f - gg * gg) * m, do_ * og * (1.0f - og) * m};
    float* dgf = dhg + r * G + j;
    T* out = dhg_out + r * G + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dgf[q * H] = pre[q];
      out[q * H] = from_f32<T>(pre[q]);
    }
    carry_c[e] = m * dc_prev + (1.0f - m) * dc_in;
    direct[e] = (1.0f - m) * dh;
  }
}

template <typename T>
int launch_all(const void* xg, const void* w_h, const float* b_h,
               const float* mask, const void* h_prev, const void* c_prev,
               const void* cs, const void* dy, void* dhg_out, float* carry_h,
               float* carry_c, float* dhg, float* direct, int T_len, int D,
               int B, int H, cudaStream_t stream) {
  const int kc_a = staged_columns(H), kc_b = staged_columns(4 * H);
  const size_t smem_a = smem_bytes(kc_a, 4), smem_b = smem_bytes(kc_b, 1);
  cudaError_t err = allow_smem(bilstm_bwd_gates<T>, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(rnn_bwd_carry<T, 4, true>, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t state = sizeof(float) * D * B * H;
  err = cudaMemsetAsync(carry_h, 0, state, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(carry_c, 0, state, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid = step_grid(D, B, H);
  const size_t x_step = static_cast<size_t>(D) * B * 4 * H;
  const size_t h_step = static_cast<size_t>(D) * B * H;
  const T* x = static_cast<const T*>(xg);
  const T* w = static_cast<const T*>(w_h);
  const T* hp = static_cast<const T*>(h_prev);
  const T* cp = static_cast<const T*>(c_prev);
  const T* c = static_cast<const T*>(cs);
  const T* g = static_cast<const T*>(dy);
  T* out = static_cast<T*>(dhg_out);
  const WLayout wl{4 * H, H};
  for (int t = T_len - 1; t >= 0; --t) {
    bilstm_bwd_gates<T><<<grid, NTHREADS, smem_a, stream>>>(
        x + t * x_step, w, b_h, mask + static_cast<size_t>(t) * D * B,
        hp + t * h_step, cp + t * h_step, c + t * h_step, g + t * h_step,
        carry_h, carry_c, out + t * x_step, dhg, direct, B, H, kc_a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rnn_bwd_carry<T, 4, true><<<grid, NTHREADS, smem_b, stream>>>(
        dhg, w, wl, direct, carry_h, B, H, kc_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h, h_prev, c_prev, cs, dy and
// dhg share it). carry_h, carry_c, direct (D, B, H) and dhg_f32
// (D, B, 4H) are f32 scratch; the carries are zeroed here. Returns
// cudaGetLastError() after the launches.
int tpuasr_bilstm_bwd(const void* xg, const void* w_h, const float* b_h,
                      const float* mask, const void* h_prev, const void* c_prev,
                      const void* cs, const void* dy, void* dhg,
                      float* carry_h, float* carry_c, float* dhg_f32,
                      float* direct, int T_len, int D, int B, int H, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(xg, w_h, b_h, mask, h_prev, c_prev, cs, dy, dhg,
                             carry_h, carry_c, dhg_f32, direct, T_len, D, B, H,
                             s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(xg, w_h, b_h, mask, h_prev, c_prev, cs, dy,
                                      dhg, carry_h, carry_c, dhg_f32, direct,
                                      T_len, D, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
