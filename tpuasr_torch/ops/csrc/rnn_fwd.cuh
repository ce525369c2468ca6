// The fused bidirectional RNN forward for NVIDIA Hopper (sm_90a), shared by
// the BiGRU (K1f in the [k, g*H + j] layout, K5f gate-major), the BiLSTM
// (K4f) and the vanilla tanh RNN (K6f, one gate): the whole time loop in ONE
// persistent, cooperative launch per call (rnn_plan.py decides its tiling
// and hands it over as a FwdLayout). K6f is the instance NG = 1, so a
// trace names it rnn_fwd_loop<T, 1, VEC>.
//
// A block owns slices of 16 hidden units of one direction (slice s is
// direction s / (HP / 16), units 16 * (s % (HP / 16)) on), for every batch
// row, and all their gates. For the whole call it keeps in shared memory
// its columns of w_h[d] as rows (row (sl, g, u) holds w_h[d, k, g, j] over
// k, whatever the global layout, so K5f pins what K1f pins), the f32 value
// of the rounded h_{t-1} of its units and, for the LSTM, their f32 c.
// Rows that do not fit (f32 weights, H=1760) are read from L2 by the same
// kernel. Each step t:
//   1. one grid barrier (t > 0): every block has written ys[t-1];
//   2. the product hg[b, g, u] = sum_k h_{t-1}[d, b, k] w_h[d, k, g, j],
//      walking the rows in tiles of 32. bf16: on the tensor cores,
//      mma.sync m16n8k16 with the pinned rows as A (16 units of one gate)
//      and h_{t-1} as B (8 rows), f32 accumulators; warp w takes an
//      eighth of k for all 32 rows of the tile, so one A fragment feeds
//      4 n-tiles and the block reads its weights from shared memory once
//      a step; it reads its part of ys[t-1] from L2 into registers with
//      ld.global.cg (L1 is not coherent across SMs), FW_PREFETCH chunks
//      of 32 columns ahead; the 8 warps' partial sums meet in shared
//      memory and are added in warp order. f32: f32 FMAs, a thread per
//      (row, unit), k in order;
//   3. the gate math, a thread per (row, unit), 2 a thread, with no
//      further exchange: hg + b_h, the gates from xg[t] (read a step
//      ahead), and h_t (and the LSTM's c_t) with masked frames carrying h
//      and c through;
//   4. h_t rounded to xg's dtype into ys[t] (the LSTM also writes cs[t] =
//      round(c_t)), and the rounded h_t's f32 value kept for the next step.
// ys[t-1] is never overwritten, so it is itself the exchange buffer and
// one barrier a step is enough. Both directions wait at one barrier: they
// advance in lockstep with equal work, and a counter per direction, which
// lets each wait only for its own 50 blocks, measured no faster on an
// H100 (PERF.md). No sum uses atomics and every sum has
// a fixed order, so a call is bit-identical to the next, and K5f to K1f
// on relaid-out weights.
//
// In the bf16 product the 32 columns of a chunk are taken in a fixed
// permutation: a lane reads 8 consecutive columns of its A and B rows with
// one 16-byte load and feeds columns {0,1}, {2,3} of them to the first
// k-step's (tq*2, tq*2+8) fragment slots and {4,5}, {6,7} to the second's.
// A and B use the same permutation, so the product is the same sum of the
// same exact bf16 x bf16 products.
//
// A per-part step timer (clock64 spans of thread 0, summed over steps:
// barrier wait, the first prefetch window of h landing, the rest of the
// product with its exchange, the gate math, and the whole loop) is written
// when the caller hands a buffer; on the main path it is null. While it
// runs, the first window of h is waited for before the product starts.

#pragma once

#include <type_traits>

#include "rnn.cuh"

namespace tpuasr_rnn {

constexpr int FW_UNITS = 16;     // units per slice (rnn_plan.UNITS)
constexpr int FW_ROWS = 32;      // rows per pass (rnn_plan.ROW_TILE): 4 n-tiles of 8
constexpr int FW_THREADS = 256;  // 8 warps, each an eighth of k for all 32 rows
constexpr int FW_WARPS = FW_THREADS / 32;
constexpr int FW_PREFETCH = 4;   // 32-column chunks of h (x 4 n-tiles) a warp has in flight
constexpr int FW_PARTS = 5;      // timer: barrier, h load, product, gate math, loop

// rnn_plan.FwdPlan.as_ints(), in order. Byte offsets into dynamic shared
// memory.
struct FwdLayout {
  int n_blocks, spb, n_slices, pinned;
  int ws;  // elements per pinned w_h row
  int off_h, off_c, off_red, off_w;
  int smem;
  int HP, KP;  // H rounded up to 16 (units) and to 32 (columns of a chunk)
};

// One call's tensors. cs is the LSTM's, else null.
template <typename T>
struct FwdArgs {
  const T* xg;
  GateStrides xs;
  const T* w_h;
  WLayout wl;
  const float* b_h;   // (D, NG*H) == (D, NG, H)
  const float* mask;  // (T, D, B)
  T* ys;              // (T, D, B, H)
  T* cs;              // (T, D, B, H)
  unsigned int* bar;  // grid barrier counter, zero at the call's start
  long long* timer;   // (n_blocks, FW_PARTS) clock64 sums, or null
  int T_len, D, B, H;
};

// The inputs of one (step, row, unit) of the gate math, read ahead of
// their use (they do not depend on h): xg's NG gates and m.
template <typename T, int NG>
struct FwdIn {
  T x[NG];
  float m;
};

// 8 consecutive values of row ``p`` from column k on (zero past H) as
// bf16 pairs, read through L2 only.
__device__ __forceinline__ uint4 load8_cg(const __nv_bfloat16* p, int k, int H, bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const uint4*>(p + k));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = k + 2 * i < H ? __ldcg(q + k + 2 * i) : 0u;
    const uint32_t hi = k + 2 * i + 1 < H ? __ldcg(q + k + 2 * i + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One warp's part of the bf16 product: for the slice whose first
// block-local w_h row is r0 (units j0 .. j0 + 15 of direction d), the
// sums over the chunks cb .. ce - 1 (32 columns each) of w_h[k, g, unit]
// h[row, k] for the tile's 32 rows, gate g and n-tile nt (rows 8 nt ..
// 8 nt + 7) added to acc[g][nt] (m16n8k16 C: units gq, gq + 8 x rows
// tq*2, tq*2 + 1 of the n-tile). hrow[nt]: this lane's B row of h_{t-1}
// in n-tile nt (null past B). One A fragment of pinned weights feeds all
// 4 n-tiles, so a block reads its weights from shared memory once a step.
// PINNED: the slice's NG*16 rows are all in shared memory; else rows past
// L.pinned come from L2. VEC: H % 8 == 0, so 16-byte loads of h.
template <int NG, bool PINNED, bool VEC>
__device__ __forceinline__ void fwd_mma(float (&acc)[NG][4][4], const __nv_bfloat16* w_s,
                                        const FwdLayout& L, int r0,
                                        const __nv_bfloat16* w_d, WLayout wl, int j0, int H,
                                        const __nv_bfloat16* const (&hrow)[4], int cb, int ce,
                                        int gq, int tq, bool timed, long long* t_landed) {
  auto load_h = [&](int c, uint4 (&v)[4]) {
    const int k = c * 32 + tq * 8;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      v[nt] = (hrow[nt] != nullptr && k < H) ? load8_cg(hrow[nt], k, H, VEC)
                                             : make_uint4(0u, 0u, 0u, 0u);
  };
  // 8 values of pinned row r (or of w_h[d, k.., g, j] from L2) from k on
  auto load_w = [&](int r, int g, int j, int c) -> uint4 {
    const int k = c * 32 + tq * 8;
    if (PINNED || r < L.pinned)
      return *reinterpret_cast<const uint4*>(w_s + static_cast<size_t>(r) * L.ws + k);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      const __nv_bfloat16 lo = j < H ? w_at(w_d, wl, k + 2 * i, g * H + j, H, NG * H) : zero;
      const __nv_bfloat16 hi = j < H ? w_at(w_d, wl, k + 2 * i + 1, g * H + j, H, NG * H) : zero;
      w[i] = pack_bf16(lo, hi);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  };
  auto compute = [&](int c, const uint4 (&vh)[4]) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int ra = r0 + g * FW_UNITS + gq;
      const uint4 va = load_w(ra, g, j0 + gq, c), vb = load_w(ra + 8, g, j0 + gq + 8, c);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(acc[g][nt], va.x, vb.x, va.y, vb.y, vh[nt].x, vh[nt].y);
        mma_bf16(acc[g][nt], va.z, vb.z, va.w, vb.w, vh[nt].z, vh[nt].w);
      }
    }
  };
  uint4 buf[FW_PREFETCH][4];
#pragma unroll
  for (int s = 0; s < FW_PREFETCH; ++s) {
    if (cb + s < ce) {
      load_h(cb + s, buf[s]);
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) buf[s][nt] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (timed) {  // the timer's h-load span ends when the first window has landed
    uint32_t x = 0u;
#pragma unroll
    for (int s = 0; s < FW_PREFETCH; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) x ^= buf[s][nt].x ^ buf[s][nt].w;
    asm volatile("" ::"r"(x));
    *t_landed = clock64();
  }
  for (int c = cb; c < ce; c += FW_PREFETCH) {
#pragma unroll
    for (int s = 0; s < FW_PREFETCH; ++s) {
      if (c + s < ce) {
        compute(c + s, buf[s]);
        if (c + s + FW_PREFETCH < ce) load_h(c + s + FW_PREFETCH, buf[s]);
      }
    }
  }
}

// The f32 product of one (row, unit): hg[g] = sum_k h[row, k] w_h[k, g, j]
// in k order on f32 FMAs; row r0 + g*16 + u of the pinned block (or L2).
template <int NG>
__device__ __forceinline__ void fwd_fma(float (&hg)[NG], const float* w_s, const FwdLayout& L,
                                        int r0, int u, const float* w_d, WLayout wl, int j,
                                        int H, const float* hrow) {
  for (int k = 0; k < H; ++k) {
    const float hv = __ldcg(hrow + k);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int r = r0 + g * FW_UNITS + u;
      const float w = r < L.pinned ? w_s[static_cast<size_t>(r) * L.ws + k]
                                   : w_at(w_d, wl, k, g * H + j, H, NG * H);
      hg[g] = fmaf(hv, w, hg[g]);
    }
  }
}

// The forward time loop (header comment). NG = 3: GRU, gates [r, z, n];
// NG = 4: LSTM, gates [i, f, g, o]; NG = 1: vanilla tanh RNN. VEC: bf16
// with H % 8 == 0. grid = L.n_blocks (cooperative), block = FW_THREADS,
// dynamic shared memory L.smem.
template <typename T, int NG, bool VEC>
__global__ void __launch_bounds__(FW_THREADS, 1)
rnn_fwd_loop(const FwdArgs<T> a, const FwdLayout L) {
  extern __shared__ __align__(16) unsigned char fw_smem[];
  float* h_s = reinterpret_cast<float*>(fw_smem + L.off_h);  // [sl][b][u]: h_{t-1}
  float* c_s = reinterpret_cast<float*>(fw_smem + L.off_c);  // [sl][b][u]: LSTM c_{t-1}
  float* red = reinterpret_cast<float*>(fw_smem + L.off_red);  // [warp][g][row][u]
  T* w_s = reinterpret_cast<T*>(fw_smem + L.off_w);            // [row][ws]

  const int B = a.B, H = a.H, D = a.D;
  const int G = NG * H;
  const int per_dir = L.HP / FW_UNITS;
  const int s0 = blockIdx.x * L.spb;
  const int nsl = min(L.spb, L.n_slices - s0);  // slices of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (B + FW_ROWS - 1) / FW_ROWS;
  const bool timed = a.timer != nullptr;
  const long long t_begin = timed ? clock64() : 0;
  long long clk[FW_PARTS - 1] = {0, 0, 0, 0};

  // pin the block's columns of w_h[d] as rows: row r = (sl*NG + g)*16 + u
  // holds w_h[d, k, g, j] over k (zero past H and for padding units)
  for (int i = tid; i < L.pinned * L.ws; i += FW_THREADS) {
    const int k = i / L.pinned, r = i % L.pinned;
    const int sl = r / (NG * FW_UNITS), g = (r / FW_UNITS) % NG, u = r % FW_UNITS;
    const int s = s0 + sl, d = s / per_dir, j = (s % per_dir) * FW_UNITS + u;
    const T* w_d = a.w_h + static_cast<size_t>(d) * H * G;
    w_s[static_cast<size_t>(r) * L.ws + k] =
        (sl < nsl && j < H) ? w_at(w_d, a.wl, k, g * H + j, H, G) : from_f32<T>(0.0f);
  }
  for (int p = tid; p < nsl * B * FW_UNITS; p += FW_THREADS) {
    h_s[p] = 0.0f;  // h_0 = c_0 = 0
    if (NG == 4) c_s[p] = 0.0f;
  }
  __syncthreads();

  // this thread's 2 gate-math items of a row tile: items tid and tid +
  // 256 of the tile's 32 x 16 (row, unit) pairs
  const int gq = lane / 4, tq = lane % 4;
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int N_ITEMS = 2;
  auto item = [&](int e, int& row, int& u) {
    const int p = tid + e * FW_THREADS;
    row = p / FW_UNITS, u = p % FW_UNITS;
  };
  auto load_in = [&](int t, int sl, int b, int u, FwdIn<T, NG>& in) {
    const int s = s0 + sl, d = s / per_dir, j = (s % per_dir) * FW_UNITS + u;
    if (b >= B || j >= H) return;
    const T* x = a.xg + static_cast<size_t>(t) * D * a.xs.sd + d * a.xs.sd + b * a.xs.sb + j;
#pragma unroll
    for (int g = 0; g < NG; ++g) in.x[g] = x[g * a.xs.sg];
    in.m = a.mask[(static_cast<size_t>(t) * D + d) * B + b];
  };
  auto load_items = [&](int t, int sl, int rt, FwdIn<T, NG> (&in)[N_ITEMS]) {
    if (sl >= nsl) return;
#pragma unroll
    for (int e = 0; e < N_ITEMS; ++e) {
      int row, u;
      item(e, row, u);
      load_in(t, sl, rt * FW_ROWS + row, u, in[e]);
    }
  };

  // step 3 and 4 for item (sl, b, u) of step t; hg without b_h
  auto gate = [&](int t, int sl, int b, int u, const float (&hg)[NG], const FwdIn<T, NG>& in) {
    const int s = s0 + sl, d = s / per_dir, j = (s % per_dir) * FW_UNITS + u;
    if (b >= B || j >= H) return;
    const float* bh = a.b_h + static_cast<size_t>(d) * G;
    const int q = (sl * B + b) * FW_UNITS + u;
    const float h = h_s[q], m = in.m;
    const size_t o = ((static_cast<size_t>(t) * D + d) * B + b) * H + j;
    float h_t;
    if constexpr (NG == 1) {
      const float h_new = tanhf(to_f32(in.x[0]) + (hg[0] + bh[j]));
      h_t = m * h_new + (1.0f - m) * h;
    } else if constexpr (NG == 3) {
      const float rg = sigmoid_f32(to_f32(in.x[0]) + (hg[0] + bh[j]));
      const float zg = sigmoid_f32(to_f32(in.x[1]) + (hg[1] + bh[H + j]));
      const float ng = tanhf(to_f32(in.x[2]) + rg * (hg[2] + bh[2 * H + j]));
      const float h_new = (1.0f - zg) * ng + zg * h;
      h_t = m * h_new + (1.0f - m) * h;
    } else {
      const float cp = c_s[q];
      const float ig = sigmoid_f32(to_f32(in.x[0]) + (hg[0] + bh[j]));
      const float fg = sigmoid_f32(to_f32(in.x[1]) + (hg[1] + bh[H + j]));
      const float gg = tanhf(to_f32(in.x[2]) + (hg[2] + bh[2 * H + j]));
      const float og = sigmoid_f32(to_f32(in.x[3]) + (hg[3] + bh[3 * H + j]));
      const float c_new = fg * cp + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float c_t = m * c_new + (1.0f - m) * cp;
      h_t = m * h_new + (1.0f - m) * h;
      a.cs[o] = from_f32<T>(c_t);
      c_s[q] = c_t;
    }
    const T hr = from_f32<T>(h_t);  // the carried h is the rounded one
    a.ys[o] = hr;
    h_s[q] = to_f32(hr);
  };

  const int n_chunks = L.KP / 32;  // this warp's eighth of them
  const int cb = warp * n_chunks / FW_WARPS, ce = (warp + 1) * n_chunks / FW_WARPS;

  FwdIn<T, NG> pre[N_ITEMS];  // the inputs of (slice 0, tile 0), a step ahead
  load_items(0, 0, 0, pre);
  for (int t = 0; t < a.T_len; ++t) {
    long long c0 = timed ? clock64() : 0;
    if (t > 0) grid_barrier(a.bar, static_cast<unsigned int>(t) * gridDim.x);
    if (timed) {
      const long long c1 = clock64();
      clk[0] += c1 - c0;
      c0 = c1;
    }
    for (int sl = 0; sl < nsl; ++sl) {
      const int s = s0 + sl, d = s / per_dir, j0 = (s % per_dir) * FW_UNITS;
      const int r0 = sl * NG * FW_UNITS;
      const T* w_d = a.w_h + static_cast<size_t>(d) * H * G;
      const T* hp_d =  // h_{t-1} of direction d: ys[t-1, d]
          t > 0 ? a.ys + (static_cast<size_t>(t - 1) * D + d) * B * H : a.ys;
      for (int rt = 0; rt < n_tiles; ++rt) {
        FwdIn<T, NG> in[N_ITEMS];
        if (sl == 0 && rt == 0) {
#pragma unroll
          for (int e = 0; e < N_ITEMS; ++e) in[e] = pre[e];
        } else {
          load_items(t, sl, rt, in);
        }
        float hg[N_ITEMS][NG];
#pragma unroll
        for (int e = 0; e < N_ITEMS; ++e)
#pragma unroll
          for (int g = 0; g < NG; ++g) hg[e][g] = 0.0f;
        long long c_landed = c0;
        if constexpr (MMA) {
          if (t > 0) {
            float acc[NG][4][4];
#pragma unroll
            for (int g = 0; g < NG; ++g)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[g][nt][q] = 0.0f;
            const T* hrow[4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int row = rt * FW_ROWS + nt * 8 + gq;
              hrow[nt] = row < B ? hp_d + static_cast<size_t>(row) * H : nullptr;
            }
            if ((sl + 1) * NG * FW_UNITS <= L.pinned)
              fwd_mma<NG, true, VEC>(acc, w_s, L, r0, w_d, a.wl, j0, H, hrow, cb, ce, gq, tq,
                                     timed, &c_landed);
            else
              fwd_mma<NG, false, VEC>(acc, w_s, L, r0, w_d, a.wl, j0, H, hrow, cb, ce, gq, tq,
                                      timed, &c_landed);
            // the 8 warps' partial sums meet in shared memory and are added
            // in warp order
#pragma unroll
            for (int g = 0; g < NG; ++g)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int rw = nt * 8 + tq * 2 + (q & 1), u = gq + 8 * (q >> 1);
                  red[((warp * NG + g) * FW_ROWS + rw) * FW_UNITS + u] = acc[g][nt][q];
                }
            __syncthreads();
#pragma unroll
            for (int e = 0; e < N_ITEMS; ++e) {
              int rw, u;
              item(e, rw, u);
#pragma unroll
              for (int g = 0; g < NG; ++g) {
                float sum = 0.0f;
#pragma unroll
                for (int w = 0; w < FW_WARPS; ++w)
                  sum += red[((w * NG + g) * FW_ROWS + rw) * FW_UNITS + u];
                hg[e][g] = sum;
              }
            }
          }
        } else {
          if (t > 0) {
#pragma unroll
            for (int e = 0; e < N_ITEMS; ++e) {
              int rw, u;
              item(e, rw, u);
              const int b = rt * FW_ROWS + rw;
              if (b < B && j0 + u < H)
                fwd_fma<NG>(hg[e], reinterpret_cast<const float*>(w_s), L, r0, u,
                            reinterpret_cast<const float*>(w_d), a.wl, j0 + u, H,
                            reinterpret_cast<const float*>(hp_d) + static_cast<size_t>(b) * H);
            }
          }
        }
        if (timed) {
          const long long c2 = clock64();
          clk[1] += c_landed - c0;
          clk[2] += c2 - c_landed;
          c0 = c2;
        }
#pragma unroll
        for (int e = 0; e < N_ITEMS; ++e) {
          int rw, u;
          item(e, rw, u);
          gate(t, sl, rt * FW_ROWS + rw, u, hg[e], in[e]);
        }
        if (sl == 0 && rt == 0 && t + 1 < a.T_len) load_items(t + 1, 0, 0, pre);
        if (nsl * n_tiles > 1) __syncthreads();  // red is rewritten by the next pass
        if (timed) {
          const long long c3 = clock64();
          clk[3] += c3 - c0;
          c0 = c3;
        }
      }
    }
  }
  if (timed && tid == 0) {
    long long* out = a.timer + static_cast<size_t>(blockIdx.x) * FW_PARTS;
#pragma unroll
    for (int i = 0; i < FW_PARTS - 1; ++i) out[i] = clk[i];
    out[FW_PARTS - 1] = clock64() - t_begin;
  }
}

inline FwdLayout read_fwd_layout(const int* v) {
  return FwdLayout{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11]};
}

// One call's forward for T = float (dtype 0) or __nv_bfloat16 (1): the
// arguments as the C entry points take them (layout: FwdPlan.as_ints()).
// cs is null for the GRU and the vanilla RNN.
template <int NG>
int fwd_loop(const void* xg, GateStrides xs, const void* w_h, WLayout wl, const float* b_h,
             const float* mask, void* ys, void* cs, unsigned int* bar, long long* timer,
             const int* layout, int T_len, int D, int B, int H, int dtype,
             cudaStream_t stream) {
  const FwdLayout L = read_fwd_layout(layout);
  auto run = [&](auto zero, auto vec) {
    using T = decltype(zero);
    FwdArgs<T> a{static_cast<const T*>(xg), xs, static_cast<const T*>(w_h), wl, b_h, mask,
                 static_cast<T*>(ys), static_cast<T*>(cs), bar, timer, T_len, D, B, H};
    FwdLayout l = L;
    void* params[] = {&a, &l};
    return launch_cooperative(&rnn_fwd_loop<T, NG, decltype(vec)::value>, L.n_blocks,
                              FW_THREADS, L.smem, params, stream);
  };
  if (dtype == 0) return run(0.0f, std::false_type());
  if (dtype == 1) {
    if (H % 8 == 0) return run(__nv_bfloat16(), std::true_type());
    return run(__nv_bfloat16(), std::false_type());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tpuasr_rnn
