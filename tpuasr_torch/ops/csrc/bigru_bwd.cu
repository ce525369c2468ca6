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
// Design (the simple first version, K1f v2's layout). Two launches per
// reverse time step cover both directions, and the stream orders them,
// so no block exchanges anything within a launch:
//   A (gates): a block owns JB units of one direction for BB rows,
//     stages h_{t-1} for its rows in shared memory as f32, splits the k
//     reduction of hg's three columns of each unit over 8 warps, sums
//     the partials in shared memory, then a thread per (row, unit) does
//     the gate math and writes packed_t, dhg and direct = m dh z m +
//     (1 - m) dh for the unit.
//   B (carry): a block owns JB units k for BB rows, stages dhg (3H f32
//     columns, in passes of at most KC_MAX) and reduces over the gate
//     axis, reading w_h[d, k, :] (a contiguous row) from L2; then
//     carry[k] = sum + direct[k]. B reads nothing A reads from carry,
//     so the carry is updated in place.
// CUDA-core f32 FMAs throughout. Left for later: the persistent,
// tensor-core redesign shared with K1f (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int JB = 16;                 // units per block (lane % JB)
constexpr int BB = 32;                 // batch rows per block
constexpr int RB = BB / 2;             // rows per lane: lane / JB + 2i
constexpr int NWARPS = 8;              // warps splitting the reduction
constexpr int NTHREADS = 32 * NWARPS;  // 256
constexpr int KG = 8;                  // reduction values per group
constexpr int KC_MAX = 1024;           // staged columns per pass
constexpr int PAD = 4;                 // floats of padding per staged row
constexpr int SV = 32;                 // staging loads in flight per lane

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
int staged_columns(int K) {
  const int unit = KG * NWARPS;
  const int kc = (K + unit - 1) / unit * unit;
  return kc < KC_MAX ? kc : KC_MAX;
}

// Dynamic shared memory: the staged rows, later reused for the partial
// sums of NC columns per unit.
size_t smem_bytes(int kc, int nc) {
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

// hg's w_h values for k .. k + KG - 1 at unit j, gates r, z, n; zero
// past H.
template <typename T>
__device__ __forceinline__ void load_w3(float (&w)[KG][3], const T* w_d, int k,
                                        int j, int H) {
  const int G = 3 * H;
#pragma unroll
  for (int q = 0; q < KG; ++q) {
    const bool ok = k + q < H && j < H;
    const T* p = w_d + static_cast<size_t>(ok ? k + q : 0) * G + (ok ? j : 0);
    w[q][0] = ok ? to_f32(p[0]) : 0.0f;
    w[q][1] = ok ? to_f32(p[H]) : 0.0f;
    w[q][2] = ok ? to_f32(p[2 * H]) : 0.0f;
  }
}

// w_h[d, k, g .. g + KG - 1] (a row of w_h along the gate axis); zero
// past H and 3H.
template <typename T>
__device__ __forceinline__ void load_wrow(float (&w)[KG], const T* w_d, int g,
                                          int k, int H) {
  const int G = 3 * H;
  const T* p = w_d + static_cast<size_t>(k < H ? k : 0) * G;
#pragma unroll
  for (int q = 0; q < KG; ++q)
    w[q] = (k < H && g + q < G) ? to_f32(p[g + q]) : 0.0f;
}

// Launch A of one reverse step. grid = (ceil(H/JB), ceil(B/BB), D),
// block = NTHREADS, dynamic shared memory smem_bytes(kc, 3).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bigru_bwd_gates(const T* __restrict__ xg,      // (D, B, 3H) of step t
                const T* __restrict__ w_h,     // (D, H, 3H)
                const float* __restrict__ b_h, // (D, 3H)
                const float* __restrict__ m_t, // (D, B) of step t
                const T* __restrict__ hp,      // (D, B, H): h_{t-1}
                const T* __restrict__ dy,      // (D, B, H) of step t
                const float* __restrict__ carry,  // (D, B, H): dL/dh_t
                T* __restrict__ packed,        // (D, B, 4H) of step t
                float* __restrict__ dhg,       // (D, B, 3H)
                float* __restrict__ direct,    // (D, B, H)
                int B, int H, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;   // staged h_{t-1}
  float* red = smem;  // red[((warp * 3 + g) * BB + row) * JB + u], after

  const int d = blockIdx.z;
  const int j0 = blockIdx.x * JB;
  const int b0 = blockIdx.y * BB;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int u = lane % JB, par = lane / JB;
  const int G = 3 * H;
  const int stride = kc + PAD;
  const T* w_d = w_h + static_cast<size_t>(d) * H * G;
  const T* hp_d = hp + static_cast<size_t>(d) * B * H;

  float acc[RB][3];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
  const int kw = kc / NWARPS;
  for (int k0 = 0; k0 < H; k0 += kc) {
    stage_rows(hs, hp_d, H, b0, B, k0, H, kc, warp, lane);
    __syncthreads();
    const int kb = warp * kw, ke = kb + kw;
    float wn[KG][3];
    load_w3(wn, w_d, k0 + kb, j0 + u, H);
    for (int kk = kb; kk < ke; kk += KG) {
      float w[KG][3];
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        w[q][0] = wn[q][0];
        w[q][1] = wn[q][1];
        w[q][2] = wn[q][2];
      }
      if (kk + KG < ke) load_w3(wn, w_d, k0 + kk + KG, j0 + u, H);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float hv[KG];
#pragma unroll
        for (int q = 0; q < KG; q += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(
              &hs[(par + 2 * i) * stride + kk + q]);
          hv[q] = h4.x, hv[q + 1] = h4.y, hv[q + 2] = h4.z, hv[q + 3] = h4.w;
        }
#pragma unroll
        for (int q = 0; q < KG; ++q) {
          acc[i][0] = fmaf(hv[q], w[q][0], acc[i][0]);
          acc[i][1] = fmaf(hv[q], w[q][1], acc[i][1]);
          acc[i][2] = fmaf(hv[q], w[q][2], acc[i][2]);
        }
      }
    }
    __syncthreads();  // hs is restaged, or reused for red, next
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int row = par + 2 * i;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      red[((warp * 3 + g) * BB + row) * JB + u] = acc[i][g];
  }
  __syncthreads();

  // gate gradients: a thread per (row, unit) of the block
  const float* bh = b_h + static_cast<size_t>(d) * G;
  for (int p = tid; p < BB * JB; p += NTHREADS) {
    const int row = p / JB, uu = p % JB;
    const int b = b0 + row, j = j0 + uu;
    if (b >= B || j >= H) continue;
    float s[3] = {bh[j], bh[H + j], bh[2 * H + j]};
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
#pragma unroll
      for (int g = 0; g < 3; ++g) s[g] += red[((w * 3 + g) * BB + row) * JB + uu];
    }
    const size_t r = static_cast<size_t>(d) * B + b;
    const T* x = xg + r * G;
    const float h = to_f32(hp_d[static_cast<size_t>(b) * H + j]);
    const float rg = sigmoid_f32(to_f32(x[j]) + s[0]);
    const float zg = sigmoid_f32(to_f32(x[H + j]) + s[1]);
    const float ng = tanhf(to_f32(x[2 * H + j]) + rg * s[2]);
    const float dh = carry[r * H + j] + to_f32(dy[r * H + j]);
    const float m = m_t[r];
    const float dn = dh * (1.0f - zg);
    const float dz = dh * (h - ng);
    const float dh_direct = dh * zg;
    const float dn_pre = dn * (1.0f - ng * ng);
    const float dr = dn_pre * s[2];
    const float dhn = dn_pre * rg;
    const float dz_pre = dz * zg * (1.0f - zg);
    const float dr_pre = dr * rg * (1.0f - rg);
    float* dg = dhg + r * G;
    dg[j] = dr_pre * m;
    dg[H + j] = dz_pre * m;
    dg[2 * H + j] = dhn * m;
    T* pk = packed + r * 4 * H;
    pk[j] = from_f32<T>(dr_pre * m);
    pk[H + j] = from_f32<T>(dz_pre * m);
    pk[2 * H + j] = from_f32<T>(dn_pre * m);
    pk[3 * H + j] = from_f32<T>(dhn * m);
    direct[r * H + j] = m * (dh_direct * m) + (1.0f - m) * dh;
  }
}

// Launch B of one reverse step: carry[d, b, k] = sum_g dhg[d, b, g] *
// w_h[d, k, g] + direct[d, b, k]. grid = (ceil(H/JB), ceil(B/BB), D),
// block = NTHREADS, dynamic shared memory smem_bytes(kc, 1).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bigru_bwd_carry(const float* __restrict__ dhg,     // (D, B, 3H)
                const T* __restrict__ w_h,         // (D, H, 3H)
                const float* __restrict__ direct,  // (D, B, H)
                float* __restrict__ carry,         // (D, B, H)
                int B, int H, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;   // staged dhg
  float* red = smem;  // red[(warp * BB + row) * JB + u], after

  const int d = blockIdx.z;
  const int k0u = blockIdx.x * JB;
  const int b0 = blockIdx.y * BB;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int u = lane % JB, par = lane / JB;
  const int G = 3 * H;
  const int stride = kc + PAD;
  const T* w_d = w_h + static_cast<size_t>(d) * H * G;
  const float* dg_d = dhg + static_cast<size_t>(d) * B * G;
  const int k = k0u + u;  // this lane's unit

  float acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = 0.0f;
  const int kw = kc / NWARPS;
  for (int g0 = 0; g0 < G; g0 += kc) {
    stage_rows(hs, dg_d, G, b0, B, g0, G, kc, warp, lane);
    __syncthreads();
    const int gb = warp * kw, ge = gb + kw;
    float wn[KG];
    load_wrow(wn, w_d, g0 + gb, k, H);
    for (int gg = gb; gg < ge; gg += KG) {
      float w[KG];
#pragma unroll
      for (int q = 0; q < KG; ++q) w[q] = wn[q];
      if (gg + KG < ge) load_wrow(wn, w_d, g0 + gg + KG, k, H);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float hv[KG];
#pragma unroll
        for (int q = 0; q < KG; q += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(
              &hs[(par + 2 * i) * stride + gg + q]);
          hv[q] = h4.x, hv[q + 1] = h4.y, hv[q + 2] = h4.z, hv[q + 3] = h4.w;
        }
#pragma unroll
        for (int q = 0; q < KG; ++q) acc[i] = fmaf(hv[q], w[q], acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) red[(warp * BB + par + 2 * i) * JB + u] = acc[i];
  __syncthreads();

  for (int p = tid; p < BB * JB; p += NTHREADS) {
    const int row = p / JB, uu = p % JB;
    const int b = b0 + row, kk = k0u + uu;
    if (b >= B || kk >= H) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[(w * BB + row) * JB + uu];
    const size_t idx = (static_cast<size_t>(d) * B + b) * H + kk;
    carry[idx] = s + direct[idx];
  }
}

template <typename T>
int launch_all(const void* xg, const void* w_h, const float* b_h,
               const float* mask, const void* h_prev, const void* dy,
               void* packed, float* carry, float* dhg, float* direct,
               int T_len, int D, int B, int H, cudaStream_t stream) {
  const int kc_a = staged_columns(H), kc_b = staged_columns(3 * H);
  const size_t smem_a = smem_bytes(kc_a, 3), smem_b = smem_bytes(kc_b, 1);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_bwd_gates<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bigru_bwd_carry<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(carry, 0, sizeof(float) * D * B * H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((H + JB - 1) / JB, (B + BB - 1) / BB, D);
  const size_t x_step = static_cast<size_t>(D) * B * 3 * H;
  const size_t h_step = static_cast<size_t>(D) * B * H;
  const size_t p_step = static_cast<size_t>(D) * B * 4 * H;
  const T* x = static_cast<const T*>(xg);
  const T* hp = static_cast<const T*>(h_prev);
  const T* g = static_cast<const T*>(dy);
  T* pk = static_cast<T*>(packed);
  const T* w = static_cast<const T*>(w_h);
  for (int t = T_len - 1; t >= 0; --t) {
    bigru_bwd_gates<T><<<grid, NTHREADS, smem_a, stream>>>(
        x + t * x_step, w, b_h, mask + static_cast<size_t>(t) * D * B,
        hp + t * h_step, g + t * h_step, carry, pk + t * p_step, dhg, direct,
        B, H, kc_a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bigru_bwd_carry<T><<<grid, NTHREADS, smem_b, stream>>>(
        dhg, w, direct, carry, B, H, kc_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xg, w_h, h_prev, dy and packed share
// it). carry, dhg and direct are f32 scratch of (D, B, H), (D, B, 3H)
// and (D, B, H). Returns cudaGetLastError() after the launches.
int tpuasr_bigru_bwd(const void* xg, const void* w_h, const float* b_h,
                     const float* mask, const void* h_prev, const void* dy,
                     void* packed, float* carry, float* dhg, float* direct,
                     int T_len, int D, int B, int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(xg, w_h, b_h, mask, h_prev, dy, packed, carry,
                             dhg, direct, T_len, D, B, H, s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(xg, w_h, b_h, mask, h_prev, dy, packed,
                                     carry, dhg, direct, T_len, D, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
