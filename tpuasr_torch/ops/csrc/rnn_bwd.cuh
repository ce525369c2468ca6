// The fused bidirectional RNN backward for NVIDIA Hopper (sm_90a), shared
// by the BiGRU (K1b in the [k, g*H + j] layout, K5b gate-major), the
// BiLSTM (K4b) and the vanilla tanh RNN (K6b, one gate). Two launches a
// call, whatever T (K6b: the loop alone, see below):
//
// 1. hg_gemm: hg for every step at once, HG[t, d] = h_{t-1}[t, d] @ w_h[d]
//    + b_h[d], one (T*B) x H x NG*H product per direction. hg depends on
//    the forward's ys only, not on the backward's carry, so it leaves the
//    sequential chain. bf16 on the tensor cores (mma.sync m16n8k16, f32
//    accumulators, ldmatrix from a cp.async double buffer); f32 on f32
//    FMAs (never TF32). HG is f32 (T, D, B, NG, HP), HP = H rounded up to
//    16, so a slice of 16 units of one gate is 64 aligned bytes.
//
// 2. rnn_bwd_loop: the reverse time loop in one persistent, cooperative
//    launch (rnn_plan.py decides its tiling and hands it over as a
//    BwdLayout). A block owns slices of 16 units of one direction for
//    every row and keeps, for the whole call, its rows of w_h[d] (the
//    rows k of its units, all NG*H columns, in the K1 order c = g*H + j
//    whatever the global layout) and its carries in shared memory. Each
//    reverse step t:
//      (a) gate math for its units from HG[t] (prefetched a step ahead
//          with cp.async), xg_t, h_{t-1}, dy_t and m_t (read into
//          registers a step ahead) and its own carry; it writes the
//          emitted gradients of step t and its columns of the dhg buffer
//          dhg[t % 2] (D, B, GP): f32, or for bf16 weights the bf16 hi
//          and lo halves of each f32 value (put_dhg);
//      one grid barrier (a release/acquire counter);
//      (b) the carry product for the same units k: carry[b, k] =
//          sum_c dhg[t % 2][d, b, c] w_h[d, k, c] + direct[b, k]. Each warp
//          streams a contiguous range of dhg's columns from L2 into
//          registers with ld.global.cg (L1 is not coherent across blocks),
//          16 bytes a lane (put_dhg's units), BW_PREFETCH k-steps ahead;
//          the 8 ranges' partial sums meet in shared memory in range
//          order. bf16 weights: tensor cores with the pinned rows as A and
//          dhg's hi and lo halves as B, two products into f32
//          accumulators, so the product of the unrounded f32 dhg is kept
//          to ~2^-16 relative; f32 weights: f32 FMAs.
//    The double buffer on t % 2 makes one barrier a step enough: a block
//    writes dhg[t % 2] again at step t - 2 only after the barrier of step
//    t - 1, which every block passes after its part (b) of step t.
// No sum uses atomics; every reduction has a fixed order, so a call is
// bit-identical to the next, and K5b to K1b on relaid-out inputs.
//
// K6b (NG = 1) needs no hg: the derivative of tanh is read from the
// forward's output, d(pre)_t = (dy_t + carry) (1 - y_t^2) m_t with y_t =
// ys[t] as the forward rounded it, so it skips the GEMM and runs the loop
// alone, on ys in h_{t-1}'s place and without xg. A trace names it
// rnn_bwd_loop<T, 1>.
//
// A per-part step timer (clock64 spans of thread 0, summed over steps:
// the wait for HG[t], the gate math, the barrier wait, the wait for dhg's
// words, the rest of the carry product with its reduction, and the whole
// loop) is written when the caller hands a buffer; on the main path it is
// null. While it runs, every warp waits for each k-step's words of dhg
// before that k-step's product, so the wait is a span of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rnn.cuh"

namespace tpuasr_rnn {

constexpr int BW_UNITS = 16;  // units per slice (rnn_plan.UNITS)
constexpr int BW_ROWS = 32;   // rows per carry-product pass (ROW_TILE)
constexpr int BW_THREADS = 256;
constexpr int BW_PARTS = 6;  // timer: hg wait, gate math, barrier, dhg wait, product, loop

// rnn_plan.BwdPlan.as_ints(), in order. Byte offsets into dynamic shared
// memory.
struct BwdLayout {
  int n_blocks, spb, n_slices, pinned;
  int warp_ksteps;  // k-steps (16 columns) of the carry product a warp streams
  int ws;           // elements per pinned w_h row
  int off_carry, off_carry_c, off_direct, off_hg, off_red, off_w;
  int smem;
  int HP, GP;  // H rounded up to 16 (hg's unit axis), NG*H to 16 (dhg's row)
};

// One call's tensors. out is the emitted gradient of every step (GRU:
// packed [dr_pre, dz_pre, dn_pre, dhn] * m; LSTM: dhg), 4 gates at
// strides ps. cp and cs (c_{t-1} and c_t) are the LSTM's, else null.
template <typename T>
struct BwdArgs {
  const T* xg;
  GateStrides xs;
  const T* w_h;
  WLayout wl;
  const float* mask;  // (T, D, B)
  const T* hp;        // (T, D, B, H): h_{t-1}; the vanilla RNN's ys (h_t)
  const T* cp;        // (T, D, B, H): c_{t-1} (LSTM)
  const T* cs;        // (T, D, B, H): c_t (LSTM)
  const T* dy;        // (T, D, B, H)
  const float* hg;    // (T, D, B, NG, HP); null for the vanilla RNN
  T* out;
  GateStrides ps;
  float* dhg;         // (2, D, B, GP) 4-byte words (put_dhg), zero past NG*H
  unsigned int* bar;  // grid barrier counter, zero at the call's start
  long long* timer;   // (n_blocks, BW_PARTS) clock64 sums, or null
  int T_len, D, B, H, HP, GP;
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// ------------------------------------------------------------- hg GEMM

constexpr int HG_BM = 128, HG_BN = 128, HG_BK = 32;  // bf16 tiles
constexpr int HG_APAD = 8, HG_BPAD = 8;              // bf16 elements

// HG[t, d, b, g, j] = sum_k hp[t, d, b, k] w_h[d, k, g*H + j] + b_h[d, g*H + j]
// for rows m = t*B + b < M = T*B and columns n = g*H + j < G = NG*H.
// bf16: 8 warps of 32 x 64 outputs on mma.sync, a two-stage cp.async
// ring (16-byte copies when H % 8 == 0, so that no copy crosses a gate
// or a row; else element loads). grid = (ceil(G/128), ceil(M/128), D).
__global__ void __launch_bounds__(256)
hg_gemm_bf16(const __nv_bfloat16* __restrict__ hp, const __nv_bfloat16* __restrict__ w_h,
             WLayout wl, const float* __restrict__ b_h, float* __restrict__ hg, int M,
             int B, int D, int H, int NG, int HP) {
  __shared__ __align__(16) __nv_bfloat16 As[2][HG_BM][HG_BK + HG_APAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][HG_BK][HG_BN + HG_BPAD];
  const int d = blockIdx.z;
  const int m0 = blockIdx.y * HG_BM, n0 = blockIdx.x * HG_BN;
  const int G = NG * H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 64
  const __nv_bfloat16* w_d = w_h + static_cast<size_t>(d) * H * G;
  const bool vec = H % 8 == 0;

  auto a_row = [&](int m) {  // h_{t-1}[t, d, b, :], m = t*B + b
    const int t = m / B, b = m - t * B;
    return hp + (static_cast<size_t>(t) * D + d) * B * H + static_cast<size_t>(b) * H;
  };
  auto load = [&](int stage, int k0) {
    if (vec) {
      for (int p = tid; p < HG_BM * HG_BK / 8; p += 256) {
        const int r = p / (HG_BK / 8), kk = (p % (HG_BK / 8)) * 8;
        const int m = m0 + r, k = k0 + kk;
        const bool ok = m < M && k < H;
        cp_async16(&As[stage][r][kk], ok ? a_row(m) + k : hp, ok);
      }
      for (int p = tid; p < HG_BK * HG_BN / 8; p += 256) {
        const int kr = p / (HG_BN / 8), nn = (p % (HG_BN / 8)) * 8;
        const int k = k0 + kr, n = n0 + nn;
        const bool ok = k < H && n < G;
        const int g = ok ? n / H : 0;
        const __nv_bfloat16* src =
            ok ? w_d + static_cast<size_t>(k) * wl.wk + static_cast<size_t>(g) * wl.wg +
                     (n - g * H)
               : w_h;
        cp_async16(&Bs[stage][kr][nn], src, ok);
      }
    } else {
      for (int p = tid; p < HG_BM * HG_BK; p += 256) {
        const int r = p / HG_BK, kk = p % HG_BK;
        const int m = m0 + r, k = k0 + kk;
        As[stage][r][kk] = (m < M && k < H) ? a_row(m)[k] : __float2bfloat16_rn(0.0f);
      }
      for (int p = tid; p < HG_BK * HG_BN; p += 256) {
        const int kr = p / HG_BN, nn = p % HG_BN;
        Bs[stage][kr][nn] = w_at(w_d, wl, k0 + kr, n0 + nn, H, G);
      }
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int n_k = (H + HG_BK - 1) / HG_BK;
  load(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_k) {
      load(st ^ 1, (kt + 1) * HG_BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < HG_BK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = lane / 8, r = lane % 8;
        ldmatrix_x4(a[i], &As[st][wm * 32 + i * 16 + r + (q & 1) * 8][ks + (q >> 1) * 8]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bq[2];
        ldmatrix_x2_trans(bq, &Bs[st][ks + (lane % 16)][wn * 64 + j * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], bq[0], bq[1]);
      }
    }
    __syncthreads();  // the stage is overwritten by the next load
  }

  const int gq = lane / 4, tq = lane % 4;
  const float* bh = b_h + static_cast<size_t>(d) * G;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + i * 16 + gq + half * 8;
      if (m >= M) continue;
      const int t = m / B, b = m - t * B;
      float* row = hg + ((static_cast<size_t>(t) * D + d) * B + b) * NG * HP;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 64 + j * 8 + tq * 2 + e;
          if (n >= G) continue;
          const int g = n / H;
          row[g * HP + (n - g * H)] = acc[i][j][half * 2 + e] + bh[n];
        }
      }
    }
  }
}

// The same product in f32 on f32 FMAs: 64 x 64 tiles, 4 x 4 outputs a
// thread, k in order. grid = (ceil(G/64), ceil(M/64), D).
__global__ void __launch_bounds__(256)
hg_gemm_f32(const float* __restrict__ hp, const float* __restrict__ w_h, WLayout wl,
            const float* __restrict__ b_h, float* __restrict__ hg, int M, int B, int D,
            int H, int NG, int HP) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int d = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = NG * H;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const float* w_d = w_h + static_cast<size_t>(d) * H * G;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int p = tid; p < BM * BK; p += 256) {
      const int r = p / BK, kk = p % BK, m = m0 + r, k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < H) {
        const int t = m / B, b = m - t * B;
        v = hp[((static_cast<size_t>(t) * D + d) * B + b) * H + k];
      }
      As[kk][r] = v;
    }
    for (int p = tid; p < BK * BN; p += 256) {
      const int kr = p / BN, nn = p % BN;
      Bs[kr][nn] = w_at(w_d, wl, k0 + kr, n0 + nn, H, G);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(As[kk][tm + 16 * i], Bs[kk][tn + 16 * j], acc[i][j]);
    }
    __syncthreads();
  }
  const float* bh = b_h + static_cast<size_t>(d) * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm + 16 * i;
    if (m >= M) continue;
    const int t = m / B, b = m - t * B;
    float* row = hg + ((static_cast<size_t>(t) * D + d) * B + b) * NG * HP;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + 16 * j;
      if (n >= G) continue;
      const int g = n / H;
      row[g * HP + (n - g * H)] = acc[i][j] + bh[n];
    }
  }
}

// Launches the hg product for T = float or __nv_bfloat16.
template <typename T>
int hg_gemm(const void* hp, const void* w_h, WLayout wl, const float* b_h, float* hg,
            int T_len, int D, int B, int H, int NG, int HP, cudaStream_t stream) {
  const int M = T_len * B, G = NG * H;
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((G + HG_BN - 1) / HG_BN, (M + HG_BM - 1) / HG_BM, D);
    hg_gemm_bf16<<<grid, 256, 0, stream>>>(static_cast<const __nv_bfloat16*>(hp),
                                           static_cast<const __nv_bfloat16*>(w_h), wl, b_h,
                                           hg, M, B, D, H, NG, HP);
  } else {
    const dim3 grid((G + 63) / 64, (M + 63) / 64, D);
    hg_gemm_f32<<<grid, 256, 0, stream>>>(static_cast<const float*>(hp),
                                          static_cast<const float*>(w_h), wl, b_h, hg, M,
                                          B, D, H, NG, HP);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ persistent loop

constexpr int BW_WARPS = BW_THREADS / 32;  // column ranges of the carry product
constexpr int BW_PREFETCH = 3;  // k-steps of dhg a warp has in flight

// Column c of a row of the step's dhg buffer. f32 weights: the f32 value.
// bf16 weights: its bf16 hi = rn(v) and lo = rn(v - hi), stored so that
// the 8 bytes of columns (2i, 2i + 1) are {hi pair, lo pair}, and the 16
// bytes of lane tq's unit of a k-step (columns k0 .. k0 + 15) are the
// pairs of columns k0 + 2tq and k0 + 8 + 2tq: one 16-byte load gives a
// thread both B registers of an m16n8k16 product, of hi and of lo. Each
// value is split once, by the block that owns it, not by every reader.
__device__ __forceinline__ int dhg_pair(int i) {  // where pair i lies in its row
  const int j = i & 7;
  return (i & ~7) | ((j & 3) << 1) | (j >> 2);
}
template <typename T>
__device__ __forceinline__ void put_dhg(float* row, int c, float v) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(row) + dhg_pair(c >> 1) * 4 + (c & 1);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    p[0] = hi;
    p[2] = __float2bfloat16_rn(v - __bfloat162float(hi));
  } else {
    row[c] = v;
  }
}

// One warp's part of the carry product on the tensor cores (bf16 w_h):
// for the 16 units of the slice whose first block-local w_h row is r0
// (units k0 .. k0 + 15) and rows b0 .. b0 + 31 of dg_d (one direction's
// f32 dhg, (B, GP)), the sum over k-steps kb .. ke - 1 (16 columns each)
// of w_h[k, c] dhg[b, c], written to red[u * BW_ROWS + row]. A: the
// pinned rows (or L2 past L.pinned); B: dhg's bf16 hi and lo halves
// (put_dhg), read from L2 by __ldcg (ld.global.cg, 16 bytes a lane and
// k-step, BW_PREFETCH k-steps ahead), each multiplied into its own f32
// accumulators. PINNED: all 16 rows are in shared memory (the flagship
// case), so the loop has no L2 path to skip. wait: null, or the timer's
// sum of clock64 cycles spent waiting for each k-step's words before its
// product.
template <typename T, bool PINNED>
__device__ __forceinline__ void carry_mma(const T* w_s, const BwdLayout& L, int r0,
                                          const T* w_d, WLayout wl, int k0, int H, int G,
                                          const float* dg_d, int GP, int B, int b0, int kb,
                                          int ke, int gq, int tq, float* red,
                                          long long* wait) {
  const int ra = r0 + gq, rb = ra + 8;  // this lane's A rows: units gq, gq + 8
  const bool pa = PINNED || ra < L.pinned, pb = PINNED || rb < L.pinned;
  const T* wa = w_s + static_cast<size_t>(ra) * L.ws;
  const T* wb = w_s + static_cast<size_t>(rb) * L.ws;
  const float* rowp[4];  // this lane's B rows (b0 + nt * 8 + gq) at its unit
  bool rok[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int b = b0 + nt * 8 + gq;
    rok[nt] = b < B;
    rowp[nt] = dg_d + static_cast<size_t>(rok[nt] ? b : 0) * GP + tq * 4;
  }
  // bb[nt]: this lane's unit of k-step ks of row nt (put_dhg): {hi, lo} of
  // columns 2tq, 2tq + 1, then {hi, lo} of columns 2tq + 8, 2tq + 9
  auto load = [&](int ks, uint4 (&bb)[4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      bb[nt] = rok[nt] ? __ldcg(reinterpret_cast<const uint4*>(rowp[nt] + ks * 16))
                       : make_uint4(0u, 0u, 0u, 0u);
  };
  auto frag = [&](bool pinned, const T* wrow, int k, int c) -> uint32_t {
    if (PINNED || pinned) return *reinterpret_cast<const uint32_t*>(wrow + c);
    return pack_bf16(w_at(w_d, wl, k, c, H, G), w_at(w_d, wl, k, c + 1, H, G));
  };
  float acc_h[4][4], acc_l[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_h[nt][q] = acc_l[nt][q] = 0.0f;
  auto compute = [&](int ks, const uint4 (&bb)[4]) {
    const int c = ks * 16 + tq * 2;
    const uint32_t a0 = frag(pa, wa, k0 + gq, c), a1 = frag(pb, wb, k0 + gq + 8, c);
    const uint32_t a2 = frag(pa, wa, k0 + gq, c + 8), a3 = frag(pb, wb, k0 + gq + 8, c + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma_bf16(acc_h[nt], a0, a1, a2, a3, bb[nt].x, bb[nt].z);
      mma_bf16(acc_l[nt], a0, a1, a2, a3, bb[nt].y, bb[nt].w);
    }
  };
  // the timer's wait: the second clock read is predicated on every word of
  // the k-step, so it cannot issue before they have landed (where their
  // XOR happens to equal the constant, the k-step counts no wait)
  auto landed = [&](const uint4 (&bb)[4]) {
    const long long c0 = clock64();
    uint32_t sink = 0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) sink ^= bb[nt].x ^ bb[nt].y ^ bb[nt].z ^ bb[nt].w;
    long long c1;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.u32 p, %1, %3;\n\t"
        "@p mov.u64 %0, %%clock64;\n\t"
        "@!p mov.u64 %0, %2;\n\t}\n"
        : "=l"(c1)
        : "r"(sink), "l"(c0), "r"(0x9e3779b9u));
    *wait += c1 - c0;
  };
  uint4 buf[BW_PREFETCH][4];
#pragma unroll
  for (int s = 0; s < BW_PREFETCH; ++s)
    if (kb + s < ke) load(kb + s, buf[s]);
  for (int k = kb; k < ke; k += BW_PREFETCH) {
#pragma unroll
    for (int s = 0; s < BW_PREFETCH; ++s) {
      if (k + s < ke) {
        if (wait) landed(buf[s]);
        compute(k + s, buf[s]);
        if (k + s + BW_PREFETCH < ke) load(k + s + BW_PREFETCH, buf[s]);
      }
    }
  }
  // acc: (unit gq, rows nt*8 + tq*2 + e) and (unit gq + 8, the same rows)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[gq * BW_ROWS + nt * 8 + tq * 2 + e] = acc_h[nt][e] + acc_l[nt][e];
      red[(gq + 8) * BW_ROWS + nt * 8 + tq * 2 + e] = acc_h[nt][2 + e] + acc_l[nt][2 + e];
    }
  }
}

// carry_mma's sum in f32 on f32 FMAs (f32 w_h): lane u = lane % 16 takes
// rows lane / 16 + 2i, columns in order.
template <typename T>
__device__ __forceinline__ void carry_fma(const T* w_s, const BwdLayout& L, int r0,
                                          const T* w_d, WLayout wl, int k0, int H, int G,
                                          const float* dg_d, int GP, int B, int b0, int kb,
                                          int ke, int lane, float* red) {
  const int u = lane % BW_UNITS, half = lane / BW_UNITS;
  const int r = r0 + u;
  float acc[BW_ROWS / 2];
#pragma unroll
  for (int i = 0; i < BW_ROWS / 2; ++i) acc[i] = 0.0f;
  for (int c = kb * 16; c < ke * 16; ++c) {
    const float w = r < L.pinned ? to_f32(w_s[static_cast<size_t>(r) * L.ws + c])
                                 : to_f32(w_at(w_d, wl, k0 + u, c, H, G));
#pragma unroll
    for (int i = 0; i < BW_ROWS / 2; ++i) {
      const int b = b0 + half + 2 * i;
      const float x = b < B ? __ldcg(dg_d + static_cast<size_t>(b) * GP + c) : 0.0f;
      acc[i] = fmaf(x, w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < BW_ROWS / 2; ++i) red[u * BW_ROWS + half + 2 * i] = acc[i];
}

// The inputs of one (step, row, unit) of the gate math, read ahead of
// their use (they do not depend on the carry): xg's NG gates (not the
// vanilla RNN's), the GRU's h_{t-1}, the LSTM's c_t or the vanilla RNN's
// y_t (h), the LSTM's c_{t-1} (c), dy and m.
template <typename T, int NG>
struct GateIn {
  T x[NG];
  T h, c, dy;
  float m;
};

// The reverse time loop (header comment). NG = 3: GRU, the emitted
// gradient has gates [dr_pre, dz_pre, dn_pre, dhn]; NG = 4: LSTM, [di,
// df, dg, do]; NG = 1: vanilla RNN, d(pre). grid = L.n_blocks
// (cooperative), block = BW_THREADS, dynamic shared memory L.smem.
template <typename T, int NG>
__global__ void __launch_bounds__(BW_THREADS, 1)
rnn_bwd_loop(const BwdArgs<T> a, const BwdLayout L) {
  extern __shared__ __align__(16) unsigned char bw_smem[];
  float* carry = reinterpret_cast<float*>(bw_smem + L.off_carry);      // [sl][b][u]
  float* carry_c = reinterpret_cast<float*>(bw_smem + L.off_carry_c);  // LSTM
  float* direct = reinterpret_cast<float*>(bw_smem + L.off_direct);
  float* hg_s = reinterpret_cast<float*>(bw_smem + L.off_hg);  // [buf][sl][b][g][u]
  float* red = reinterpret_cast<float*>(bw_smem + L.off_red);  // [range][u][row]
  T* w_s = reinterpret_cast<T*>(bw_smem + L.off_w);            // [row][ws]

  const int B = a.B, H = a.H, HP = a.HP, GP = a.GP, D = a.D;
  const int G = NG * H;
  const int per_dir = HP / BW_UNITS;
  const int s0 = blockIdx.x * L.spb;
  const int nsl = min(L.spb, L.n_slices - s0);  // slices of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int state = nsl * B * BW_UNITS;
  const int hg_buf = L.spb * B * NG * BW_UNITS;
  const size_t dhg_buf = static_cast<size_t>(D) * B * GP;
  const bool timed = a.timer != nullptr;
  const long long t_begin = timed ? clock64() : 0;
  long long clk[BW_PARTS - 1] = {0, 0, 0, 0, 0};
  auto lap = [&](long long& c0, int part) {  // the timer: close a span of thread 0
    if (timed) {
      const long long c1 = clock64();
      clk[part] += c1 - c0;
      c0 = c1;
    }
  };

  // pin the block's rows of w_h[d] (K1's column order for every layout)
  for (int r = 0; r < L.pinned; ++r) {
    const int sl = r / BW_UNITS, s = s0 + sl;
    const int d = s / per_dir, k = (s % per_dir) * BW_UNITS + r % BW_UNITS;
    const T* w_d = a.w_h + static_cast<size_t>(d) * H * G;
    for (int c = tid; c < L.ws; c += BW_THREADS)
      w_s[static_cast<size_t>(r) * L.ws + c] =
          (sl < nsl) ? w_at(w_d, a.wl, k, c, H, G) : from_f32<T>(0.0f);
  }
  for (int p = tid; p < state; p += BW_THREADS) {
    carry[p] = direct[p] = 0.0f;
    if (NG == 4) carry_c[p] = 0.0f;
  }

  // HG[t] of the block's units into buffer buf: 4 x 16 bytes a (sl, b, g)
  auto prefetch_hg = [&](int t, int buf) {
    float* dst = hg_s + buf * hg_buf;
    for (int p = tid; p < nsl * B * NG * 4; p += BW_THREADS) {
      const int q = p % 4, rest = p / 4;
      const int g = rest % NG, b = (rest / NG) % B, sl = rest / (NG * B);
      const int s = s0 + sl, d = s / per_dir, j0 = (s % per_dir) * BW_UNITS;
      const float* src =
          a.hg + (((static_cast<size_t>(t) * D + d) * B + b) * NG + g) * HP + j0 + 4 * q;
      cp_async16(dst + ((sl * B + b) * NG + g) * BW_UNITS + 4 * q, src, true);
    }
    cp_async_commit();
  };

  // item p = (slice, row b, unit u) of step t: where it is, and its inputs
  auto where = [&](int p, int& sl, int& d, int& b, int& j) {
    const int u = p % BW_UNITS;
    b = (p / BW_UNITS) % B, sl = p / (BW_UNITS * B);
    const int s = s0 + sl;
    d = s / per_dir, j = (s % per_dir) * BW_UNITS + u;
  };
  auto load_in = [&](int t, int p, GateIn<T, NG>& in) {
    int sl, d, b, j;
    where(p, sl, d, b, j);
    if (j >= H) return;
    const size_t r = (static_cast<size_t>(t) * D + d) * B + b;  // (t, d, b)
    if constexpr (NG > 1) {
      const T* x =
          a.xg + static_cast<size_t>(t) * D * a.xs.sd + d * a.xs.sd + b * a.xs.sb + j;
#pragma unroll
      for (int g = 0; g < NG; ++g) in.x[g] = x[g * a.xs.sg];
    }
    in.h = NG == 4 ? a.cs[r * H + j] : a.hp[r * H + j];
    if (NG == 4) in.c = a.cp[r * H + j];
    in.dy = a.dy[r * H + j];
    in.m = a.mask[r];
  };

  // (a) for item p of step t
  auto gate = [&](int t, int p, const GateIn<T, NG>& in, const float* hgt, float* dhg_t) {
    int sl, d, b, j;
    where(p, sl, d, b, j);
    if (j >= H) return;
    const int u = p % BW_UNITS;
    const float* hgv = hgt + (sl * B + b) * NG * BW_UNITS + u;  // gate g at g*16
    const float m = in.m;
    const float dh = carry[p] + to_f32(in.dy);
    float* dg = dhg_t + (static_cast<size_t>(d) * B + b) * GP;  // the row
    T* o = a.out + static_cast<size_t>(t) * D * a.ps.sd + d * a.ps.sd + b * a.ps.sb + j;
    if constexpr (NG == 1) {
      const float y = to_f32(in.h);
      const float dpre = dh * (1.0f - y * y) * m;
      put_dhg<T>(dg, j, dpre);
      o[0] = from_f32<T>(dpre);
      direct[p] = (1.0f - m) * dh;
    } else if constexpr (NG == 3) {
      const float h = to_f32(in.h);
      const float rg = sigmoid_f32(to_f32(in.x[0]) + hgv[0]);
      const float zg = sigmoid_f32(to_f32(in.x[1]) + hgv[BW_UNITS]);
      const float ng = tanhf(to_f32(in.x[2]) + rg * hgv[2 * BW_UNITS]);
      const float dn = dh * (1.0f - zg);
      const float dz = dh * (h - ng);
      const float dh_direct = dh * zg;
      const float dn_pre = dn * (1.0f - ng * ng);
      const float dr = dn_pre * hgv[2 * BW_UNITS];
      const float dhn = dn_pre * rg;
      const float dz_pre = dz * zg * (1.0f - zg);
      const float dr_pre = dr * rg * (1.0f - rg);
      put_dhg<T>(dg, j, dr_pre * m);
      put_dhg<T>(dg, H + j, dz_pre * m);
      put_dhg<T>(dg, 2 * H + j, dhn * m);
      o[0] = from_f32<T>(dr_pre * m);
      o[a.ps.sg] = from_f32<T>(dz_pre * m);
      o[2 * a.ps.sg] = from_f32<T>(dn_pre * m);
      o[3 * a.ps.sg] = from_f32<T>(dhn * m);
      direct[p] = m * (dh_direct * m) + (1.0f - m) * dh;
    } else {
      const float ig = sigmoid_f32(to_f32(in.x[0]) + hgv[0]);
      const float fg = sigmoid_f32(to_f32(in.x[1]) + hgv[BW_UNITS]);
      const float gg = tanhf(to_f32(in.x[2]) + hgv[2 * BW_UNITS]);
      const float og = sigmoid_f32(to_f32(in.x[3]) + hgv[3 * BW_UNITS]);
      const float tc = tanhf(to_f32(in.h));
      const float dc_in = carry_c[p];
      const float do_ = dh * tc;
      const float dct = dc_in + dh * og * (1.0f - tc * tc);
      const float di = dct * gg;
      const float df = dct * to_f32(in.c);
      const float dgg = dct * ig;
      const float dc_prev = dct * fg;
      const float pre[4] = {di * ig * (1.0f - ig) * m, df * fg * (1.0f - fg) * m,
                            dgg * (1.0f - gg * gg) * m, do_ * og * (1.0f - og) * m};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        put_dhg<T>(dg, q * H + j, pre[q]);
        o[q * a.ps.sg] = from_f32<T>(pre[q]);
      }
      carry_c[p] = m * dc_prev + (1.0f - m) * dc_in;
      direct[p] = (1.0f - m) * dh;
    }
  };

  // the carry product's column range of this warp: a contiguous run of
  // k-steps (16 columns each), rotated by block so that the blocks do
  // not all stream the same lines of L2 at once; partial sums land in
  // red[range], so the sum over ranges has one order whatever the warp
  const int n_ks = GP / 16;
  const int kr = (warp + blockIdx.x) % BW_WARPS;
  const int kb = kr * L.warp_ksteps, ke = min(n_ks, kb + L.warp_ksteps);
  const int gq = lane / 4, tq = lane % 4;

  GateIn<T, NG> in0, in1;  // the first two items of this thread, a step ahead
  if (tid < state) load_in(a.T_len - 1, tid, in0);
  if (tid + BW_THREADS < state) load_in(a.T_len - 1, tid + BW_THREADS, in1);
  if constexpr (NG > 1) prefetch_hg(a.T_len - 1, (a.T_len - 1) & 1);
  for (int i = 0; i < a.T_len; ++i) {
    const int t = a.T_len - 1 - i;
    long long c0 = timed ? clock64() : 0;
    cp_async_wait<0>();  // HG[t] has landed
    __syncthreads();
    lap(c0, 0);
    if constexpr (NG > 1)
      if (t > 0) prefetch_hg(t - 1, (t - 1) & 1);
    const float* hgt = hg_s + (t & 1) * hg_buf;
    float* dhg_t = a.dhg + (t & 1) * dhg_buf;

    // (a) gate math of the block's units, every row
    if (tid < state) {
      gate(t, tid, in0, hgt, dhg_t);
      if (t > 0) load_in(t - 1, tid, in0);
    }
    if (tid + BW_THREADS < state) {
      gate(t, tid + BW_THREADS, in1, hgt, dhg_t);
      if (t > 0) load_in(t - 1, tid + BW_THREADS, in1);
    }
    for (int p = tid + 2 * BW_THREADS; p < state; p += BW_THREADS) {
      GateIn<T, NG> in;
      load_in(t, p, in);
      gate(t, p, in, hgt, dhg_t);
    }
    lap(c0, 1);
    if (t == 0) break;  // the carry into h_{-1} is not needed
    grid_barrier(a.bar, static_cast<unsigned int>(i + 1) * gridDim.x);
    lap(c0, 2);
    long long wait = 0;  // the timer's dhg wait of this step

    // (b) carry[b, k] = sum_c dhg_t[d, b, c] w_h[d, k, c] + direct[b, k]
    for (int sl = 0; sl < nsl; ++sl) {
      const int s = s0 + sl, d = s / per_dir, k0 = (s % per_dir) * BW_UNITS;
      const T* w_d = a.w_h + static_cast<size_t>(d) * H * G;
      const float* dg_d = dhg_t + static_cast<size_t>(d) * B * GP;
      for (int rt = 0; rt * BW_ROWS < B; ++rt) {
        if constexpr (sizeof(T) == 2) {
          float* red_r = red + kr * BW_UNITS * BW_ROWS;
          if ((sl + 1) * BW_UNITS <= L.pinned)
            carry_mma<T, true>(w_s, L, sl * BW_UNITS, w_d, a.wl, k0, H, G, dg_d, GP, B,
                               rt * BW_ROWS, kb, ke, gq, tq, red_r, timed ? &wait : nullptr);
          else
            carry_mma<T, false>(w_s, L, sl * BW_UNITS, w_d, a.wl, k0, H, G, dg_d, GP, B,
                                rt * BW_ROWS, kb, ke, gq, tq, red_r, timed ? &wait : nullptr);
        } else {
          carry_fma(w_s, L, sl * BW_UNITS, w_d, a.wl, k0, H, G, dg_d, GP, B, rt * BW_ROWS,
                    kb, ke, lane, red + kr * BW_UNITS * BW_ROWS);
        }
        __syncthreads();
        for (int p = tid; p < BW_UNITS * BW_ROWS; p += BW_THREADS) {
          const int row = p % BW_ROWS, u = p / BW_ROWS;
          const int b = rt * BW_ROWS + row;
          if (b >= B) continue;
          float sum = 0.0f;
#pragma unroll
          for (int r = 0; r < BW_WARPS; ++r) sum += red[(r * BW_UNITS + u) * BW_ROWS + row];
          const int q = (sl * B + b) * BW_UNITS + u;
          carry[q] = sum + direct[q];
        }
        __syncthreads();
      }
    }
    clk[3] += wait;  // the dhg wait is a part of its own, out of the product's span
    lap(c0, 4);
    clk[4] -= wait;
  }
  if (timed && tid == 0) {
    long long* out = a.timer + static_cast<size_t>(blockIdx.x) * BW_PARTS;
#pragma unroll
    for (int p = 0; p < BW_PARTS - 1; ++p) out[p] = clk[p];
    out[BW_PARTS - 1] = clock64() - t_begin;
  }
}

// The cooperative launch of rnn_bwd_loop; an error when the grid cannot
// be co-resident (never a hang, never a fallback).
template <typename T, int NG>
int launch_loop(const BwdArgs<T>& args, const BwdLayout& L, cudaStream_t stream) {
  BwdArgs<T> a = args;
  BwdLayout l = L;
  void* params[] = {&a, &l};
  return launch_cooperative(&rnn_bwd_loop<T, NG>, L.n_blocks, BW_THREADS, L.smem, params,
                            stream);
}

inline BwdLayout read_layout(const int* v) {
  return BwdLayout{v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6],  v[7],
                   v[8], v[9], v[10], v[11], v[12], v[13], v[14]};
}

// One call's loop for T = float (dtype 0) or __nv_bfloat16 (1): the
// arguments as the C entry points take them (layout: BwdPlan.as_ints()).
template <int NG>
int bwd_loop(const void* xg, GateStrides xs, const void* w_h, WLayout wl,
             const float* mask, const void* hp, const void* cp, const void* cs,
             const void* dy, const float* hg, void* out, GateStrides ps, float* dhg,
             unsigned int* bar, long long* timer, const int* layout, int T_len, int D,
             int B, int H, int dtype, cudaStream_t stream) {
  const BwdLayout L = read_layout(layout);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const BwdArgs<T> a{static_cast<const T*>(xg), xs, static_cast<const T*>(w_h), wl, mask,
                       static_cast<const T*>(hp), static_cast<const T*>(cp),
                       static_cast<const T*>(cs), static_cast<const T*>(dy), hg,
                       static_cast<T*>(out), ps, dhg, bar, timer, T_len, D, B, H, L.HP,
                       L.GP};
    return launch_loop<T, NG>(a, L, stream);
  };
  if (dtype == 0) return run(0.0f);
  if (dtype == 1) return run(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

// hg_gemm by dtype code.
inline int bwd_hg(const void* hp, const void* w_h, WLayout wl, const float* b_h, float* hg,
                  int T_len, int D, int B, int H, int NG, int HP, int dtype,
                  cudaStream_t stream) {
  if (dtype == 0) return hg_gemm<float>(hp, w_h, wl, b_h, hg, T_len, D, B, H, NG, HP, stream);
  if (dtype == 1)
    return hg_gemm<__nv_bfloat16>(hp, w_h, wl, b_h, hg, T_len, D, B, H, NG, HP, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tpuasr_rnn
