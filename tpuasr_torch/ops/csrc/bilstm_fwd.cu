// Fused bidirectional LSTM time loop, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/lstm.py:_fwd_kernel (launched by
// _bilstm_fwd at lstm.py:179) and computes exactly what it computes, for
// every direction d, row b and unit j:
//   hg  = h_{t-1} @ w_h[d] + b_h[d]          (products and sum in f32)
//   i = sigmoid(xi + hi), f = sigmoid(xf + hf), g = tanh(xg + hg_g),
//   o = sigmoid(xo + ho)                     (gate order [i, f, g, o])
//   c'  = f c_{t-1} + i g,  h' = o tanh(c')
//   h_t = round_to_T(m h' + (1 - m) h_{t-1}),  c_t = m c' + (1 - m) c_{t-1}
//   ys_t = h_t,  cs_t = round_to_T(c_t)
// The two carries differ, as in the TPU kernel: h is carried rounded to
// xg's dtype (its scratch is xg.dtype, and step t reads ys[t-1] back),
// while c is carried in f32 (its scratch is f32) in a (D, B, H) buffer
// that the thread owning (d, b, j) updates in place, since the c update
// is elementwise. cs, the backward's input, is the rounded copy.
//
// Layouts (all contiguous): xg (T, D, B, 4H), w_h (D, H, 4H), b_h (D, 4H)
// f32, mask (T, D, B) f32 -> ys, cs (T, D, B, H); scratch c (D, B, H) f32.
// D in {1, 2}, any T, B, H. T is float or __nv_bfloat16.
//
// Bound. Per step D (B x H) @ (H x 4H) products: at T=251, B=32, H=800,
// D=2 82.3 GFLOP, 83 us on the bf16 tensor cores, against 165 MB of
// xg/ys/cs/w_h/mask traffic (49 us at 3.35 TB/s): operations bound it.
// As in K1f, the loop is strictly sequential and a step is far too small
// to fill the card.
//
// Design. K1f's (rnn.cuh: gate_products with four gates): one launch per
// step for both directions, a block owning 16 units of one direction for
// 32 rows with h_{t-1} staged in shared memory as f32 and the k reduction
// split over 8 warps (16 rows x 4 gates = 64 accumulators a lane), then a
// thread per (row, unit) for the gate math and the f32 c update. Left for
// later: the persistent, tensor-core redesign queued for K1.

#include "rnn.cuh"

namespace {

using namespace tpuasr_rnn;

// One step. grid = step_grid, block = NTHREADS, dynamic shared memory
// smem_bytes(kc, 4), kc = staged_columns(H).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bilstm_fwd_step(const T* __restrict__ xg,       // (D, B, 4H) of step t
                const T* __restrict__ w_h,      // (D, H, 4H)
                const float* __restrict__ b_h,  // (D, 4H)
                const float* __restrict__ m_t,  // (D, B) of step t
                const T* __restrict__ h_prev,   // (D, B, H) of t-1; null at t=0
                float* __restrict__ c,          // (D, B, H): c_{t-1} in, c_t out
                T* __restrict__ h_out,          // (D, B, H) of step t
                T* __restrict__ c_out,          // (D, B, H) of step t
                int B, int H, int kc) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JB;
  const int b0 = blockIdx.y * BB;
  const size_t G = 4 * static_cast<size_t>(H);
  const T* w_d = w_h + d * H * G;
  const T* hp_d =
      h_prev == nullptr ? nullptr : h_prev + static_cast<size_t>(d) * B * H;
  if (hp_d != nullptr)
    gate_products<T, 4>(smem, hp_d, w_d, WLayout{4 * H, H}, B, H, b0, j0, kc);

  const float* bh = b_h + d * G;
  for (int p = threadIdx.x; p < BB * JB; p += NTHREADS) {
    const int row = p / JB, uu = p % JB;
    const int b = b0 + row, j = j0 + uu;
    if (b >= B || j >= H) continue;
    const size_t r = static_cast<size_t>(d) * B + b;
    float s[4] = {bh[j], bh[H + j], bh[2 * H + j], bh[3 * H + j]};
    float h = 0.0f, cp = 0.0f;  // h_0 = c_0 = 0
    if (hp_d != nullptr) {
      add_partials<4>(s, smem, row, uu);
      h = to_f32(hp_d[static_cast<size_t>(b) * H + j]);
      cp = c[r * H + j];
    }
    const T* x = xg + r * G + j;
    const float ig = sigmoid_f32(to_f32(x[0]) + s[0]);
    const float fg = sigmoid_f32(to_f32(x[H]) + s[1]);
    const float gg = tanhf(to_f32(x[2 * H]) + s[2]);
    const float og = sigmoid_f32(to_f32(x[3 * H]) + s[3]);
    const float c_new = fg * cp + ig * gg;
    const float h_new = og * tanhf(c_new);
    const float m = m_t[r];
    const float h_t = m * h_new + (1.0f - m) * h;
    const float c_t = m * c_new + (1.0f - m) * cp;
    h_out[r * H + j] = from_f32<T>(h_t);
    c_out[r * H + j] = from_f32<T>(c_t);
    c[r * H + j] = c_t;
  }
}

template <typename T>
int launch_all(const void* xg, const void* w_h, const float* b_h,
               const float* mask, void* ys, void* cs, float* c, int T_len,
               int D, int B, int H, cudaStream_t stream) {
  const int kc = staged_columns(H);
  const size_t smem = smem_bytes(kc, 4);
  cudaError_t err = allow_smem(bilstm_fwd_step<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = step_grid(D, B, H);
  const size_t x_step = static_cast<size_t>(D) * B * 4 * H;
  const size_t y_step = static_cast<size_t>(D) * B * H;
  const T* x = static_cast<const T*>(xg);
  T* y = static_cast<T*>(ys);
  T* cy = static_cast<T*>(cs);
  for (int t = 0; t < T_len; ++t) {
    bilstm_fwd_step<T><<<grid, NTHREADS, smem, stream>>>(
        x + t * x_step, static_cast<const T*>(w_h), b_h,
        mask + static_cast<size_t>(t) * D * B,
        t == 0 ? nullptr : y + (t - 1) * y_step, c, y + t * y_step,
        cy + t * y_step, B, H, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h, ys and cs share it); c is
// f32 scratch of (D, B, H), written before it is read. Returns
// cudaGetLastError() after the launches (0 = success).
int tpuasr_bilstm_fwd(const void* xg, const void* w_h, const float* b_h,
                      const float* mask, void* ys, void* cs, float* c,
                      int T_len, int D, int B, int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(xg, w_h, b_h, mask, ys, cs, c, T_len, D, B, H, s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(xg, w_h, b_h, mask, ys, cs, c, T_len, D,
                                     B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
