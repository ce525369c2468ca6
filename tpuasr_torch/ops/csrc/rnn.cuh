// Device code shared by the fused bidirectional RNN time loops for NVIDIA
// Hopper (sm_90a): the BiGRU (K1 in the [k, g*H + j] layout, K5 in the
// gate-major layout) and the BiLSTM (K4). Each kernel source includes it
// and adds its own gate math and C interface.
//
// One step of every loop is the same product: for each direction d, the
// carried h_{t-1} (B, H) times NG gate columns of the recurrent weights,
// hg[b, g, j] = sum_k h_{t-1}[b, k] * w_h[d, k, g, j], in f32 on the CUDA
// cores. A block owns JB hidden units of one direction for BB batch rows
// and computes their NG gate columns. It stages h_{t-1} for its rows in
// shared memory as f32 (up to KC_MAX columns a pass) and splits the k
// reduction across its 8 warps; a lane owns one unit and every other row
// of the block (RB rows x NG gates of accumulators), reads its w_h values
// straight from L2 (the weights of a layer fit the 50 MB L2), one group of
// KG columns ahead, and h as float4 along k. The warps' partial sums meet
// in shared memory, and a thread per (row, unit) then does the gate math
// with no further exchange. The backward (K1b, K4b, K5b) is in
// rnn_bwd.cuh.
//
// The weight layout is a pair of strides (WLayout): element (k, g, j) of
// w_h[d] lies at k * wk + g * wg + j. The input projections and the packed
// gradients of the GRU are addressed the same way (GateStrides), so K1 and
// K5 run one compiled body and agree bit for bit on the same weights.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace tpuasr_rnn {

constexpr int JB = 16;                 // hidden units per block (lane % JB)
constexpr int BB = 32;                 // batch rows per block
constexpr int RB = BB / 2;             // rows per lane: lane / JB + 2i
constexpr int NWARPS = 8;              // warps splitting the reduction
constexpr int NTHREADS = 32 * NWARPS;  // 256
constexpr int KG = 8;                  // reduction values per group
constexpr int KC_MAX = 1024;           // staged columns per pass
constexpr int PAD = 4;                 // floats of padding per staged row
constexpr int SV = 32;                 // staging loads in flight per lane

// Element (k, gate g, unit j) of one direction's recurrent weights lies at
// k * wk + g * wg + j: [k, g*H + j] has wk = NG*H, wg = H; the gate-major
// [g, k, j] has wk = H, wg = H*H.
struct WLayout {
  int wk, wg;
};

// Element (d, row b, gate g, unit j) of a per-step gate tensor lies at
// d * sd + b * sb + g * sg + j: (D, B, NG*H) has sd = B*NG*H, sb = NG*H,
// sg = H; the gate-major (D, NG, B, H) has sd = NG*B*H, sb = H, sg = B*H.
struct GateStrides {
  size_t sd, sb, sg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Columns staged per pass: K rounded up to whole groups for every warp,
// at most KC_MAX.
inline int staged_columns(int K) {
  const int unit = KG * NWARPS;
  const int kc = (K + unit - 1) / unit * unit;
  return kc < KC_MAX ? kc : KC_MAX;
}

// Dynamic shared memory: the staged rows, later reused for the partial
// sums of nc columns per unit.
inline size_t smem_bytes(int kc, int nc) {
  const size_t hs = static_cast<size_t>(BB) * (kc + PAD) * sizeof(float);
  const size_t red = static_cast<size_t>(NWARPS) * nc * BB * JB * sizeof(float);
  return hs > red ? hs : red;
}

// hs[row * (kc + PAD) + kk] = src[(b0 + row) * ld + k0 + kk] as f32, zero
// past B and K; a warp per row at a time, lanes along k (coalesced).
template <typename S>
__device__ __forceinline__ void stage_rows(float* hs, const S* src, size_t ld,
                                           int b0, int B, int k0, int K,
                                           int kc, int warp, int lane) {
  const int stride = kc + PAD;
  for (int row = warp; row < BB; row += NWARPS) {
    const int b = b0 + row;
    const S* p = src + static_cast<size_t>(b < B ? b : 0) * ld;
    for (int kk0 = 0; kk0 < kc; kk0 += 32 * SV) {
      float v[SV];
#pragma unroll
      for (int q = 0; q < SV; ++q) {
        const int kk = kk0 + 32 * q + lane, k = k0 + kk;
        v[q] = (b < B && kk < kc && k < K) ? to_f32(p[k]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < SV; ++q) {
        const int kk = kk0 + 32 * q + lane;
        if (kk < kc) hs[row * stride + kk] = v[q];
      }
    }
  }
}

// w_h[d] at rows k .. k + KG - 1, unit j, every gate; zero past H.
template <typename T, int NG>
__device__ __forceinline__ void load_w(float (&w)[KG][NG], const T* w_d,
                                       WLayout wl, int k, int j, int H) {
#pragma unroll
  for (int q = 0; q < KG; ++q) {
    const bool ok = k + q < H && j < H;
    const T* p = w_d + (ok ? (k + q) * wl.wk + j : 0);
#pragma unroll
    for (int g = 0; g < NG; ++g) w[q][g] = ok ? to_f32(p[g * wl.wg]) : 0.0f;
  }
}

// The block's part of hg = h_{t-1} @ w_h[d] for NG gates: rows b0 ..
// b0 + BB - 1 of hp_d (direction d's (B, H) slice of h_{t-1}), units
// j0 .. j0 + JB - 1. Leaves warp w's partial sum of (gate g, row, unit u)
// in smem[((w * NG + g) * BB + row) * JB + u], after a barrier. Every
// thread of the block calls it.
template <typename T, int NG>
__device__ __forceinline__ void gate_products(float* smem, const T* hp_d,
                                              const T* w_d, WLayout wl, int B,
                                              int H, int b0, int j0, int kc) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int u = lane % JB, par = lane / JB;
  const int stride = kc + PAD;

  float acc[RB][NG];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[i][g] = 0.0f;
  }
  const int kw = kc / NWARPS;  // this warp's columns of a pass
  for (int k0 = 0; k0 < H; k0 += kc) {
    stage_rows(smem, hp_d, H, b0, B, k0, H, kc, warp, lane);
    __syncthreads();
    const int kb = warp * kw, ke = kb + kw;
    float wn[KG][NG];
    load_w<T, NG>(wn, w_d, wl, k0 + kb, j0 + u, H);
    for (int kk = kb; kk < ke; kk += KG) {
      float w[KG][NG];
#pragma unroll
      for (int q = 0; q < KG; ++q) {
#pragma unroll
        for (int g = 0; g < NG; ++g) w[q][g] = wn[q][g];
      }
      if (kk + KG < ke) load_w<T, NG>(wn, w_d, wl, k0 + kk + KG, j0 + u, H);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float hv[KG];
#pragma unroll
        for (int q = 0; q < KG; q += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(
              &smem[(par + 2 * i) * stride + kk + q]);
          hv[q] = h4.x, hv[q + 1] = h4.y, hv[q + 2] = h4.z, hv[q + 3] = h4.w;
        }
#pragma unroll
        for (int q = 0; q < KG; ++q) {
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[i][g] = fmaf(hv[q], w[q][g], acc[i][g]);
        }
      }
    }
    __syncthreads();  // restaged, or reused for the partial sums, next
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int row = par + 2 * i;
#pragma unroll
    for (int g = 0; g < NG; ++g) smem[((warp * NG + g) * BB + row) * JB + u] = acc[i][g];
  }
  __syncthreads();
}

// s[g] += the warps' partial sums of (gate g, row, unit uu), in warp order.
template <int NG>
__device__ __forceinline__ void add_partials(float (&s)[NG], const float* red,
                                             int row, int uu) {
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
#pragma unroll
    for (int g = 0; g < NG; ++g) s[g] += red[((w * NG + g) * BB + row) * JB + uu];
  }
}

// Sets a kernel's dynamic shared memory limit; cudaSuccess or the error.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline dim3 step_grid(int D, int B, int H) {
  return dim3((H + JB - 1) / JB, (B + BB - 1) / BB, D);
}

// ------------------------------------------------------------------ GRU

// One forward step of the GRU, gates [r, z, n] (K1f, K5f):
//   hg  = h_{t-1} @ w_h[d] + b_h[d]          (products and sum in f32)
//   r   = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h_t = round_to_T(m * ((1 - z) n + z h_{t-1}) + (1 - m) h_{t-1})
// h_prev is null at t = 0 (h_0 = 0, the product vanishes). grid =
// step_grid, block = NTHREADS, dynamic shared memory smem_bytes(kc, 3).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gru_fwd_step(const T* __restrict__ xg,       // step t, strides xs
             GateStrides xs,
             const T* __restrict__ w_h,      // (D, ...) in layout wl
             WLayout wl,
             const float* __restrict__ b_h,  // (D, 3H) == (D, 3, H)
             const float* __restrict__ m_t,  // (D, B) of step t
             const T* __restrict__ h_prev,   // (D, B, H) of t-1, or null
             T* __restrict__ h_out,          // (D, B, H) of step t
             int B, int H, int kc) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JB;
  const int b0 = blockIdx.y * BB;
  const T* w_d = w_h + static_cast<size_t>(d) * 3 * H * H;
  const T* hp_d =
      h_prev == nullptr ? nullptr : h_prev + static_cast<size_t>(d) * B * H;
  if (hp_d != nullptr) gate_products<T, 3>(smem, hp_d, w_d, wl, B, H, b0, j0, kc);

  const float* bh = b_h + static_cast<size_t>(d) * 3 * H;
  for (int p = threadIdx.x; p < BB * JB; p += NTHREADS) {
    const int row = p / JB, uu = p % JB;
    const int b = b0 + row, j = j0 + uu;
    if (b >= B || j >= H) continue;
    float s[3] = {bh[j], bh[H + j], bh[2 * H + j]};
    float h = 0.0f;
    if (hp_d != nullptr) {
      add_partials<3>(s, smem, row, uu);
      h = to_f32(hp_d[static_cast<size_t>(b) * H + j]);
    }
    const T* x = xg + d * xs.sd + b * xs.sb + j;
    const float rg = sigmoid_f32(to_f32(x[0]) + s[0]);
    const float zg = sigmoid_f32(to_f32(x[xs.sg]) + s[1]);
    const float ng = tanhf(to_f32(x[2 * xs.sg]) + rg * s[2]);
    const float h_new = (1.0f - zg) * ng + zg * h;
    const size_t r = static_cast<size_t>(d) * B + b;
    const float m = m_t[r];
    h_out[r * H + j] = from_f32<T>(m * h_new + (1.0f - m) * h);
  }
}

// The whole forward time loop: one gru_fwd_step launch per step, both
// directions in each; the stream orders the steps. Returns
// cudaGetLastError() after the launches.
template <typename T>
int gru_fwd_all(const void* xg, GateStrides xs, const void* w_h, WLayout wl,
                const float* b_h, const float* mask, void* ys, int T_len,
                int D, int B, int H, cudaStream_t stream) {
  const int kc = staged_columns(H);
  const size_t smem = smem_bytes(kc, 3);
  cudaError_t err = allow_smem(gru_fwd_step<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = step_grid(D, B, H);
  const size_t x_step = static_cast<size_t>(D) * B * 3 * H;
  const size_t y_step = static_cast<size_t>(D) * B * H;
  const T* x = static_cast<const T*>(xg);
  T* y = static_cast<T*>(ys);
  for (int t = 0; t < T_len; ++t) {
    gru_fwd_step<T><<<grid, NTHREADS, smem, stream>>>(
        x + t * x_step, xs, static_cast<const T*>(w_h), wl, b_h,
        mask + static_cast<size_t>(t) * D * B,
        t == 0 ? nullptr : y + (t - 1) * y_step, y + t * y_step, B, H, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpuasr_rnn
