// K3: fused CTC prefix beam search with cutoff pruning, exact stay<->extend
// dedup, top-W selection and char/word n-gram fusion, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/beam.py:_beam_kernel (launched by
// beam_scan_pallas at beam.py:889) and computes its function: the plain
// PyTorch version is tpuasr_torch/ops/beam.py:beam_scan_reference, which
// holds the same arithmetic in the same order. Per frame of one utterance:
//   1. keep[c] = rank(c) < top_n (rank = #classes with a strictly better
//      (lp, index)); with cutoff_prob < 1 also the exclusive better-ranked
//      probability mass < cutoff_prob; lp > prune_logp unless c is blank.
//   2. stays: pb' = keep[blank] ? lse(pb, pnb) + lp[blank] : NEG;
//      pnb' = last >= 0 && keep[last] ? pnb + lp[last] : NEG.
//   3. extends e = j*C + c (parent-major): (last_j == c ? pb_j : ptot_j)
//      + lp[c], NEG for the blank and pruned classes; hashes
//      mix32(h_j, c); LM: lm_j + alpha * P_char(c | ctx_j) (+ beta on the
//      space), or lm_j + (c == space ? word bonus_j : 0).
//   4. absorption: a stay whose prefix hashes equal an extend's absorbs its
//      mass into pnb (log-sum-exp against the frame's largest extend) and
//      takes its (parent, char) when the extend outweighs the stay (lowest
//      flat index among equal maxima); absorbed extends leave the pool.
//   5. pool = W stays then W*C extends; top-W by W rounds of (max, lowest
//      index, mask to -3e38).
//   6. the survivors' state (word LM: the parent's word state, then the
//      space/grow transitions); backpointers out.
// Frames at or past the utterance's length keep the state and emit
// identity backpointers. End: scores = lse(pb, pnb) + lm, plus the word
// LM's close of the final partial word. lse(a, b) = max(m' + log1p(e^(min
// - m')), NEG), m' = max(max(a, b), NEG), NEG = -1e30.
//
// LM lookups probe the packed HashedTables in global memory as the XLA
// path's _probe does: n_probes consecutive slots from the home slot
// (h1 & (cap-1), or fmix32(h1 ^ salt) & (cap-1)); a hit needs both keys
// equal and the slot non-empty. The char LM runs the _char_lm_scores
// recursion with the context packed 6 bits a class (newest lowest) in 64
// bits, so char orders up to 11 fuse; the word LM _word_lm_score with the
// partial-word hash, the completed-word ring and the partial length.
// Products by alpha use __fmul_rn/__fadd_rn so that nvcc does not contract
// them into an FMA the plain version lacks.
//
// Limits: W <= 254 and C <= 126 (the one-copy output packing), char-LM
// orders <= 11 with C <= 64, word-LM orders <= 8, and the shared memory of
// (W, C, ring) within the card's opt-in limit (tpuasr_beam_smem). The
// decoder runs the plain version on the device past them, and says so.
//
// Layouts: lp (B, T, C) f32; lengths (B) int32; parents, chars (B, T, W)
// int8 or int32; scores (B, W) f32; state (n_fields, B, W) int32 bit
// patterns in the order pb, pnb, h1, h2, last, [lm], [ctx lo, ctx hi],
// [wh1, wh2, wlen, wc1_0.., wc2_0..]; tables all orders concatenated, meta
// (order, 3) = offset, cap, salt.
//
// Bound. At B=32, T'=251, W=10, C=44 the work is ~20 k f32 operations a
// frame and utterance (the C*C rank compares, the 450-candidate pool's
// log-adds, 10 max passes over it), 161 M operations: 2.4 us at 67 TFLOP/s;
// the bytes (1.4 MB of log-probs in, 0.16 MB of int8 backpointers out) take
// 0.5 us. The real floor is the chain of T dependent frames, each a few
// block-wide barriers.
//
// Design (simple first; speed is later work). One thread block per
// utterance runs the whole time loop, so a decode is one launch with no grid
// barrier; the lp row, the beam state (double-buffered: the survivors read
// their parents' state while writing the next), the extend scores and the
// pool live in shared memory (dynamic, sized from W, C and the LM). Classes
// and beams map to threads from opposite ends of the block so that rank and
// per-beam LM work overlap; one warp per stay scans the extends for
// absorption; warp 0 alone runs the W selection rounds with warp shuffles,
// each lane owning a strided slice of the pool. Templated on the LM mode.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG = -1e30f;
constexpr float PICKED = -3.0e38f;
constexpr float OOV_LOGP = -20.0f;
constexpr float WORD_OOV_NAT = static_cast<float>(-99.0 * 2.302585092994046);
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_W = 254;  // the one-copy output packing's limit (decode/beam.py)
constexpr int MAX_C = 126;  // int8 backpointers and the output packing
constexpr int MAX_WORD_ORDER = 8;
constexpr int MAX_RING = MAX_WORD_ORDER - 1;
constexpr int MAX_CHAR_ORDER = 11;  // a context of 10 chars fills 60 of 64 bits
constexpr int MAX_ORDER = MAX_CHAR_ORDER;
constexpr int CTX_SHIFT = 6;
constexpr uint32_t M1 = 0x9E3779B1u;
constexpr uint32_t M2 = 0x85EBCA77u;
constexpr uint32_t BOS1 = 0x7F4A7C15u, BOS2 = 0x3C6EF372u;
constexpr uint32_t UNK1 = 0x9E3779B9u, UNK2 = 0x85EBCA6Bu;
constexpr uint32_t PAD1 = 0x50AD50ADu, PAD2 = 0xDEFACED1u;

enum { LM_NONE = 0, LM_CHAR = 1, LM_WORD = 2 };

struct Tables {
  const uint32_t* k1;
  const uint32_t* k2;
  const float* lp;
  const float* bo;
  int order, n_probes;
  int off[MAX_ORDER];
  int cap[MAX_ORDER];
  uint32_t salt[MAX_ORDER];
};

struct Params {
  const float* lp;
  const int* lengths;
  int B, T, C, W, blank, top_n;
  float cutoff_prob, prune_logp, alpha, beta;
  int space, has_beta, ring, ctx_len;
  Tables tb;
  const int* state_in;
  int* state_out;
  void* parents;
  void* chars;
  float* scores;
  int out8;
};

// Shared memory carve-out, the same on the host (base = nullptr, for the
// size) and in the kernel.
struct Smem {
  float *lp, *pb, *pnb, *lm, *ptot, *spb, *spnb, *bonus, *cbo, *ext, *extlm,
      *score, *wmax;
  int *keep, *last, *wlen, *spar, *snew, *sel;
  uint64_t* ctx;
  uint32_t *h1, *h2, *wh1, *wh2, *wc1, *wc2, *weff1, *weff2, *ch1, *ch2;
  unsigned char* flag;
};

__host__ __device__ inline size_t carve(unsigned char* base, int W, int C,
                                        int ring, Smem* s) {
  const size_t E = static_cast<size_t>(W) * C, P = W + E;
  size_t off = 0;
  auto take = [&](size_t n) {  // n 4-byte words
    unsigned char* p = base ? base + off : nullptr;
    off += 4 * n;
    return p;
  };
  // the 8-byte char contexts first, at offset 0: [2][W]
  s->ctx = reinterpret_cast<uint64_t*>(take(4 * static_cast<size_t>(W)));
  s->lp = reinterpret_cast<float*>(take(C));
  s->keep = reinterpret_cast<int*>(take(C));
  // double-buffered beam state: [2][W] (rings [2][ring][W])
  s->pb = reinterpret_cast<float*>(take(2 * W));
  s->pnb = reinterpret_cast<float*>(take(2 * W));
  s->lm = reinterpret_cast<float*>(take(2 * W));
  s->h1 = reinterpret_cast<uint32_t*>(take(2 * W));
  s->h2 = reinterpret_cast<uint32_t*>(take(2 * W));
  s->last = reinterpret_cast<int*>(take(2 * W));
  s->wh1 = reinterpret_cast<uint32_t*>(take(2 * W));
  s->wh2 = reinterpret_cast<uint32_t*>(take(2 * W));
  s->wlen = reinterpret_cast<int*>(take(2 * W));
  s->wc1 = reinterpret_cast<uint32_t*>(take(2 * static_cast<size_t>(ring) * W));
  s->wc2 = reinterpret_cast<uint32_t*>(take(2 * static_cast<size_t>(ring) * W));
  // per-frame scratch
  s->ptot = reinterpret_cast<float*>(take(W));
  s->spb = reinterpret_cast<float*>(take(W));
  s->spnb = reinterpret_cast<float*>(take(W));
  s->bonus = reinterpret_cast<float*>(take(W));
  s->spar = reinterpret_cast<int*>(take(W));
  s->snew = reinterpret_cast<int*>(take(W));
  s->sel = reinterpret_cast<int*>(take(W));
  s->weff1 = reinterpret_cast<uint32_t*>(take(W));
  s->weff2 = reinterpret_cast<uint32_t*>(take(W));
  s->ch1 = reinterpret_cast<uint32_t*>(take(static_cast<size_t>(W) * MAX_ORDER));
  s->ch2 = reinterpret_cast<uint32_t*>(take(static_cast<size_t>(W) * MAX_ORDER));
  s->cbo = reinterpret_cast<float*>(take(static_cast<size_t>(W) * MAX_ORDER));
  s->wmax = reinterpret_cast<float*>(take(NWARPS));
  s->ext = reinterpret_cast<float*>(take(E));
  s->extlm = reinterpret_cast<float*>(take(E));
  s->score = reinterpret_cast<float*>(take(P));
  s->flag = base ? base + off : nullptr;
  off += E;
  return off;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t x, uint32_t m) {
  h = (h ^ x) * m;
  return h ^ (h >> 15);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float lse(float a, float b) {
  const float ms = fmaxf(fmaxf(a, b), NEG);
  return fmaxf(ms + log1pf(expf(fminf(a, b) - ms)), NEG);
}

// Order-k lookup: found, logp (NEG when absent), backoff.
__device__ void probe(const Tables& tb, int k, uint32_t q1, uint32_t q2,
                      bool* found, float* val, float* bo) {
  const uint32_t mask = static_cast<uint32_t>(tb.cap[k] - 1);
  const uint32_t salt = tb.salt[k];
  const uint32_t slot = (salt ? fmix32(q1 ^ salt) : q1) & mask;
  bool f = false;
  float v = 0.0f, b = 0.0f;
  for (int p = 0; p < tb.n_probes; ++p) {
    const int s = tb.off[k] + static_cast<int>((slot + p) & mask);
    const uint32_t a1 = tb.k1[s], a2 = tb.k2[s];
    if (a1 == q1 && a2 == q2 && (a1 | a2) != 0u) {
      f = true;
      v += tb.lp[s];
      b += tb.bo[s];
    }
  }
  *found = f;
  *val = f ? v : NEG;
  *bo = b;
}

// Word LM: natural-log P(word | ring context) with Katz backoff, and the
// effective token (the word, or <unk> when it is not a unigram).
__device__ float word_score(const Tables& tb, int ring, uint32_t wh1,
                            uint32_t wh2, const uint32_t* c1,
                            const uint32_t* c2, uint32_t* eff1,
                            uint32_t* eff2) {
  bool f;
  float v, bo;
  probe(tb, 0, mix32(0u, wh1, M1), mix32(0u, wh2, M2), &f, &v, &bo);
  const uint32_t e1 = f ? wh1 : UNK1, e2 = f ? wh2 : UNK2;
  float score = 0.0f, bo_acc = 0.0f;
  bool resolved = false;
  const int top = min(tb.order - 1, ring);
  for (int m = top; m >= 0; --m) {
    uint32_t k1 = 0u, k2 = 0u;
    for (int i = 0; i < m; ++i) {
      k1 = mix32(k1, c1[ring - m + i], M1);
      k2 = mix32(k2, c2[ring - m + i], M2);
    }
    probe(tb, m, mix32(k1, e1, M1), mix32(k2, e2, M2), &f, &v, &bo);
    if (f && !resolved) score = bo_acc + v;
    resolved = resolved || f;
    if (m > 0) {
      bool bf;
      float bv, bbo;
      probe(tb, m - 1, k1, k2, &bf, &bv, &bbo);
      if (!resolved) bo_acc = bo_acc + (bf ? bbo : 0.0f);
    }
  }
  if (!resolved) score = bo_acc + WORD_OOV_NAT;
  *eff1 = e1;
  *eff2 = e2;
  return score;
}

// Char LM: natural-log P(c | context) from a beam's context chains
// ch[m] (hash of its last m chars) and step backoffs cbo[m].
__device__ float char_score(const Tables& tb, const uint32_t* ch1,
                            const uint32_t* ch2, const float* cbo, int c) {
  float score = NEG, bo_acc = 0.0f;
  bool resolved = false;
  for (int m = tb.order - 1; m >= 0; --m) {
    bool f;
    float v, bo;
    probe(tb, m, mix32(ch1[m], c, M1), mix32(ch2[m], c, M2), &f, &v, &bo);
    if (f && !resolved) score = bo_acc + v;
    resolved = resolved || f;
    if (m > 0 && !resolved) bo_acc = bo_acc + cbo[m];
  }
  return resolved ? score : OOV_LOGP;
}

__device__ __forceinline__ bool better(float v, int i, float ov, int oi) {
  return ov > v || (ov == v && oi < i);
}

__device__ __forceinline__ void store_bp(void* out, int out8, size_t i, int v) {
  if (out8)
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(v);
  else
    static_cast<int*>(out)[i] = v;
}

template <int LM>
__global__ void __launch_bounds__(THREADS) beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  carve(smem_raw, p.W, p.C, p.ring, &s);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rt = THREADS - 1 - tid;  // beams count from the block's end
  const int W = p.W, C = p.C, E = W * C, P = W + E, ring = p.ring;
  const int T = p.T;
  const int len = min(max(p.lengths[b], 0), T);
  const uint64_t ctx_mask = (1ull << (CTX_SHIFT * p.ctx_len)) - 1ull;

  // ---- initial state (buffer 0) ----
  for (int j = tid; j < W; j += THREADS) {
    if (p.state_in) {
      auto f = [&](int k) { return p.state_in[(static_cast<size_t>(k) * p.B + b) * W + j]; };
      int k = 0;
      s.pb[j] = __int_as_float(f(k++));
      s.pnb[j] = __int_as_float(f(k++));
      s.h1[j] = static_cast<uint32_t>(f(k++));
      s.h2[j] = static_cast<uint32_t>(f(k++));
      s.last[j] = f(k++);
      if (LM != LM_NONE) s.lm[j] = __int_as_float(f(k++));
      if (LM == LM_CHAR) {  // two fields: the low and the high 32 bits
        const uint32_t lo = static_cast<uint32_t>(f(k++));
        s.ctx[j] = static_cast<uint64_t>(lo) | (static_cast<uint64_t>(static_cast<uint32_t>(f(k++))) << 32);
      }
      if (LM == LM_WORD) {
        s.wh1[j] = static_cast<uint32_t>(f(k++));
        s.wh2[j] = static_cast<uint32_t>(f(k++));
        s.wlen[j] = f(k++);
        for (int r = 0; r < ring; ++r) s.wc1[r * W + j] = static_cast<uint32_t>(f(k++));
        for (int r = 0; r < ring; ++r) s.wc2[r * W + j] = static_cast<uint32_t>(f(k++));
      }
    } else {
      s.pb[j] = j == 0 ? 0.0f : NEG;
      s.pnb[j] = NEG;
      s.h1[j] = s.h2[j] = j == 0 ? 0u : static_cast<uint32_t>(j + 1);
      s.last[j] = -1;
      s.lm[j] = 0.0f;
      s.ctx[j] = 0ull;
      s.wh1[j] = s.wh2[j] = 0u;
      s.wlen[j] = 0;
      for (int r = 0; r < ring; ++r) {
        s.wc1[r * W + j] = r == ring - 1 ? BOS1 : PAD1;
        s.wc2[r * W + j] = r == ring - 1 ? BOS2 : PAD2;
      }
    }
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < len; ++t) {
    const int co = cur * W, no = (cur ^ 1) * W;  // state buffer offsets
    const float* lprow = p.lp + (static_cast<size_t>(b) * T + t) * C;
    for (int c = tid; c < C; c += THREADS) s.lp[c] = lprow[c];
    __syncthreads();

    // ---- 1. pruning (thread per class); per-beam sums and LM state ----
    for (int c = tid; c < C; c += THREADS) {
      const float lc = s.lp[c];
      int rank = 0;
      float excl = 0.0f;
      for (int j = 0; j < C; ++j) {
        const float lj = s.lp[j];
        if (lj > lc || (lj == lc && j < c)) {
          ++rank;
          if (p.cutoff_prob < 1.0f) excl += expf(lj);
        }
      }
      bool k = rank < p.top_n;
      if (p.cutoff_prob < 1.0f) k = k && excl < p.cutoff_prob;
      s.keep[c] = k && (lc > p.prune_logp || c == p.blank);
    }
    for (int j = rt; j < W; j += THREADS) {
      s.ptot[j] = lse(s.pb[co + j], s.pnb[co + j]);
      if (LM == LM_WORD) {
        uint32_t c1[MAX_RING], c2[MAX_RING];
        for (int r = 0; r < ring; ++r) {
          c1[r] = s.wc1[cur * ring * W + r * W + j];
          c2[r] = s.wc2[cur * ring * W + r * W + j];
        }
        uint32_t e1, e2;
        const float ws = word_score(p.tb, ring, s.wh1[co + j], s.wh2[co + j], c1, c2, &e1, &e2);
        s.weff1[j] = e1;
        s.weff2[j] = e2;
        s.bonus[j] = s.wlen[co + j] > 0 ? __fadd_rn(__fmul_rn(p.alpha, ws), p.beta) : 0.0f;
      }
      if (LM == LM_CHAR) {
        const uint64_t ctx = s.ctx[co + j];
        for (int m = 0; m < p.tb.order; ++m) {
          uint32_t a1 = 0u, a2 = 0u;
          for (int i = p.ctx_len - m; i < p.ctx_len; ++i) {
            const uint32_t x = static_cast<uint32_t>(ctx >> (CTX_SHIFT * (p.ctx_len - 1 - i))) & 63u;
            a1 = mix32(a1, x, M1);
            a2 = mix32(a2, x, M2);
          }
          s.ch1[j * MAX_ORDER + m] = a1;
          s.ch2[j * MAX_ORDER + m] = a2;
          float step = 0.0f;
          if (m > 0) {
            bool bf;
            float bv, bbo;
            probe(p.tb, m - 1, a1, a2, &bf, &bv, &bbo);
            step = bf ? bbo : 0.0f;
          }
          s.cbo[j * MAX_ORDER + m] = step;
        }
      }
    }
    __syncthreads();

    // ---- 2. stays (thread per beam) and extends (thread per (j, c)) ----
    for (int j = tid; j < W; j += THREADS) {
      s.spb[j] = s.keep[p.blank] ? s.ptot[j] + s.lp[p.blank] : NEG;
      const int l = s.last[co + j];
      s.spnb[j] = l >= 0 && s.keep[l] ? s.pnb[co + j] + s.lp[l] : NEG;
    }
    float lmax = PICKED;  // below every extend score (>= NEG)
    for (int e = tid; e < E; e += THREADS) {
      const int j = e / C, c = e - j * C;
      const float base = s.last[co + j] == c ? s.pb[co + j] : s.ptot[j];
      const float v = (c == p.blank || !s.keep[c]) ? NEG : base + s.lp[c];
      s.ext[e] = v;
      lmax = fmaxf(lmax, v);
      const uint32_t e1 = mix32(s.h1[co + j], c, M1), e2 = mix32(s.h2[co + j], c, M2);
      bool m = false;
      for (int i = 0; i < W; ++i) m = m || (s.h1[co + i] == e1 && s.h2[co + i] == e2);
      s.flag[e] = m;
      if (LM == LM_CHAR) {
        const float sc = char_score(p.tb, s.ch1 + j * MAX_ORDER, s.ch2 + j * MAX_ORDER,
                                    s.cbo + j * MAX_ORDER, c);
        float add = __fmul_rn(p.alpha, sc);
        if (p.has_beta) add = __fadd_rn(add, c == p.space ? p.beta : 0.0f);
        s.extlm[e] = __fadd_rn(s.lm[co + j], add);
      }
      if (LM == LM_WORD) s.extlm[e] = s.lm[co + j] + (c == p.space ? s.bonus[j] : 0.0f);
    }
    for (int o = 16; o > 0; o >>= 1) lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    if (lane == 0) s.wmax[warp] = lmax;
    __syncthreads();

    // ---- 3. absorption: one warp per stay scans the extends ----
    float kmax = s.wmax[0];
    for (int w = 1; w < NWARPS; ++w) kmax = fmaxf(kmax, s.wmax[w]);
    kmax = fmaxf(kmax, -1e20f);
    for (int i = warp; i < W; i += NWARPS) {
      const uint32_t a1 = s.h1[co + i], a2 = s.h2[co + i];
      float acc = 0.0f, bv = NEG;
      int bi = 0;
      for (int e = lane; e < E; e += 32) {
        const int j = e / C, c = e - j * C;
        if (mix32(s.h1[co + j], c, M1) == a1 && mix32(s.h2[co + j], c, M2) == a2) {
          const float v = s.ext[e];
          if (v > NEG / 2) acc += expf(v - kmax);
          if (better(bv, bi, v, e)) {
            bv = v;
            bi = e;
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(bv, bi, ov, oi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const float alog = acc > 0.0f ? logf(acc) + kmax : NEG;
        const float pre = lse(s.spb[i], s.spnb[i]);
        s.spnb[i] = lse(s.spnb[i], alog);
        const bool take = bv > pre;
        s.spar[i] = take ? bi / C : i;
        s.snew[i] = take ? bi % C : -1;
      }
    }
    __syncthreads();

    // ---- 4. pool scores ----
    for (int q = tid; q < P; q += THREADS) {
      float sc;
      if (q < W) {
        sc = lse(s.spb[q], s.spnb[q]);
        if (LM != LM_NONE) sc = sc + s.lm[co + q];
      } else {
        const int e = q - W;
        sc = lse(NEG, s.flag[e] ? NEG : s.ext[e]);
        if (LM != LM_NONE) sc = sc + s.extlm[e];
      }
      s.score[q] = sc;
    }
    __syncthreads();

    // ---- 5. top-W: warp 0, each lane owning pool entries lane + 32 k ----
    if (warp == 0) {
      float lv = PICKED;
      int li = P;
      for (int q = lane; q < P; q += 32)
        if (better(lv, li, s.score[q], q)) {
          lv = s.score[q];
          li = q;
        }
      for (int k = 0; k < W; ++k) {
        float v = lv;
        int i = li;
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = __shfl_xor_sync(0xffffffffu, i, o);
          if (better(v, i, ov, oi)) {
            v = ov;
            i = oi;
          }
        }
        if (lane == 0) s.sel[k] = i;
        if (i < P && (i & 31) == lane) {  // the owner masks it and rescans
          s.score[i] = PICKED;
          lv = PICKED;
          li = P;
          for (int q = lane; q < P; q += 32)
            if (s.score[q] > PICKED && better(lv, li, s.score[q], q)) {
              lv = s.score[q];
              li = q;
            }
        }
      }
    }
    __syncthreads();

    // ---- 6. survivors -> next state; backpointers out ----
    const size_t out0 = (static_cast<size_t>(b) * T + t) * W;
    for (int k = tid; k < W; k += THREADS) {
      const int q = s.sel[k];
      int par, nc;
      if (q < W) {
        s.pb[no + k] = s.spb[q];
        s.pnb[no + k] = s.spnb[q];
        s.h1[no + k] = s.h1[co + q];
        s.h2[no + k] = s.h2[co + q];
        s.last[no + k] = s.last[co + q];
        if (LM != LM_NONE) s.lm[no + k] = s.lm[co + q];
        if (LM == LM_CHAR) s.ctx[no + k] = s.ctx[co + q];
        par = s.spar[q];
        nc = s.snew[q];
      } else {
        const int e = q - W, j = e / C, c = e - j * C;
        s.pb[no + k] = NEG;
        s.pnb[no + k] = s.flag[e] ? NEG : s.ext[e];
        s.h1[no + k] = mix32(s.h1[co + j], c, M1);
        s.h2[no + k] = mix32(s.h2[co + j], c, M2);
        s.last[no + k] = c;
        if (LM != LM_NONE) s.lm[no + k] = s.extlm[e];
        if (LM == LM_CHAR)
          s.ctx[no + k] = ((s.ctx[co + j] << CTX_SHIFT) | static_cast<uint64_t>(c)) & ctx_mask;
        par = j;
        nc = c;
      }
      if (LM == LM_WORD) {
        // the word state follows the selected parent, then the space /
        // grow transitions of an extended beam
        const int pw = s.wlen[co + par];
        const bool ext = nc >= 0, is_space = ext && nc == p.space;
        const bool closes = is_space && pw > 0, grows = ext && nc != p.space;
        for (int r = 0; r < ring; ++r) {
          const int src = cur * ring * W + r * W + par, dst = (cur ^ 1) * ring * W + r * W + k;
          const bool newest = r + 1 == ring;
          s.wc1[dst] = closes ? (newest ? s.weff1[par] : s.wc1[src + W]) : s.wc1[src];
          s.wc2[dst] = closes ? (newest ? s.weff2[par] : s.wc2[src + W]) : s.wc2[src];
        }
        const uint32_t u = static_cast<uint32_t>(nc > 0 ? nc : 0);
        const uint32_t p1 = s.wh1[co + par], p2 = s.wh2[co + par];
        s.wh1[no + k] = is_space ? 0u : (grows ? mix32(p1, u, M1) : p1);
        s.wh2[no + k] = is_space ? 0u : (grows ? mix32(p2, u, M2) : p2);
        s.wlen[no + k] = is_space ? 0 : (grows ? pw + 1 : pw);
      }
      store_bp(p.parents, p.out8, out0 + k, par);
      store_bp(p.chars, p.out8, out0 + k, nc);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- frozen frames: identity backpointers ----
  for (size_t i = static_cast<size_t>(len) * W + tid; i < static_cast<size_t>(T) * W;
       i += THREADS) {
    const size_t o = static_cast<size_t>(b) * T * W + i;
    store_bp(p.parents, p.out8, o, static_cast<int>(i % W));
    store_bp(p.chars, p.out8, o, -1);
  }

  // ---- end: state out (before the close), scores ----
  const int co = cur * W;
  for (int j = tid; j < W; j += THREADS) {
    if (p.state_out) {
      auto put = [&](int k, int v) {
        p.state_out[(static_cast<size_t>(k) * p.B + b) * W + j] = v;
      };
      int k = 0;
      put(k++, __float_as_int(s.pb[co + j]));
      put(k++, __float_as_int(s.pnb[co + j]));
      put(k++, static_cast<int>(s.h1[co + j]));
      put(k++, static_cast<int>(s.h2[co + j]));
      put(k++, s.last[co + j]);
      if (LM != LM_NONE) put(k++, __float_as_int(s.lm[co + j]));
      if (LM == LM_CHAR) {
        put(k++, static_cast<int>(static_cast<uint32_t>(s.ctx[co + j])));
        put(k++, static_cast<int>(static_cast<uint32_t>(s.ctx[co + j] >> 32)));
      }
      if (LM == LM_WORD) {
        put(k++, static_cast<int>(s.wh1[co + j]));
        put(k++, static_cast<int>(s.wh2[co + j]));
        put(k++, s.wlen[co + j]);
        for (int r = 0; r < ring; ++r) put(k++, static_cast<int>(s.wc1[cur * ring * W + r * W + j]));
        for (int r = 0; r < ring; ++r) put(k++, static_cast<int>(s.wc2[cur * ring * W + r * W + j]));
      }
    }
    float sc = lse(s.pb[co + j], s.pnb[co + j]);
    if (LM != LM_NONE) sc = sc + s.lm[co + j];
    if (LM == LM_WORD) {
      uint32_t c1[MAX_RING], c2[MAX_RING], e1, e2;
      for (int r = 0; r < ring; ++r) {
        c1[r] = s.wc1[cur * ring * W + r * W + j];
        c2[r] = s.wc2[cur * ring * W + r * W + j];
      }
      const float ws = word_score(p.tb, ring, s.wh1[co + j], s.wh2[co + j], c1, c2, &e1, &e2);
      sc = sc + (s.wlen[co + j] > 0 ? __fadd_rn(__fmul_rn(p.alpha, ws), p.beta) : 0.0f);
    }
    p.scores[static_cast<size_t>(b) * W + j] = sc;
  }
}

template <int LM>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<LM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel<LM><<<p.B, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for shapes or LM settings K3 does not take.
int tpuasr_beam_scan(const float* lp, const int* lengths, int B, int T, int C,
                     int W, int blank, int top_n, float cutoff_prob,
                     float prune_logp, int lm_mode, const uint32_t* k1,
                     const uint32_t* k2, const float* tlp, const float* tbo,
                     const int* meta, int order, int n_probes, float alpha,
                     float beta, int space, int has_beta, int ring,
                     const int* state_in, int* state_out, void* parents,
                     void* chars, float* scores, int out8, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (W < 1 || W > MAX_W || C < 1 || C > MAX_C || B < 0 || T < 0) return invalid;
  if (blank < 0 || blank >= C || lm_mode < LM_NONE || lm_mode > LM_WORD) return invalid;
  Params p{};
  p.lp = lp;
  p.lengths = lengths;
  p.B = B;
  p.T = T;
  p.C = C;
  p.W = W;
  p.blank = blank;
  p.top_n = top_n;
  p.cutoff_prob = cutoff_prob;
  p.prune_logp = prune_logp;
  p.alpha = alpha;
  p.beta = beta;
  p.space = space;
  p.has_beta = has_beta;
  p.ring = lm_mode == LM_WORD ? ring : 0;
  p.state_in = state_in;
  p.state_out = state_out;
  p.parents = parents;
  p.chars = chars;
  p.scores = scores;
  p.out8 = out8;
  if (lm_mode != LM_NONE) {
    if (order < 1 || order > MAX_ORDER || n_probes < 1 || meta == nullptr) return invalid;
    if (lm_mode == LM_CHAR && (order > MAX_CHAR_ORDER || C > (1 << CTX_SHIFT))) return invalid;
    if (lm_mode == LM_WORD && order > MAX_WORD_ORDER) return invalid;
    if (lm_mode == LM_WORD && (ring < 1 || ring > MAX_RING || space < 0 || space >= C))
      return invalid;
    p.tb.k1 = k1;
    p.tb.k2 = k2;
    p.tb.lp = tlp;
    p.tb.bo = tbo;
    p.tb.order = order;
    p.tb.n_probes = n_probes;
    for (int k = 0; k < order; ++k) {
      p.tb.off[k] = meta[3 * k];
      p.tb.cap[k] = meta[3 * k + 1];
      p.tb.salt[k] = static_cast<uint32_t>(meta[3 * k + 2]);
      const int cap = p.tb.cap[k];
      if (cap < n_probes || (cap & (cap - 1)) != 0) return invalid;
    }
    p.ctx_len = lm_mode == LM_CHAR ? (order > 2 ? order - 1 : 1) : 0;
  }
  if (B == 0) return 0;
  Smem s;
  const size_t smem = carve(nullptr, W, C, p.ring, &s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lm_mode) {
    case LM_CHAR:
      return launch<LM_CHAR>(p, smem, st);
    case LM_WORD:
      return launch<LM_WORD>(p, smem, st);
    default:
      return launch<LM_NONE>(p, smem, st);
  }
}

// K3's dynamic shared memory for (W, C, ring) in *bytes and this card's
// opt-in limit a block in *optin: K3 takes the shape when bytes <= optin
// (ops/beam.py asks before it launches). Returns a CUDA error code.
int tpuasr_beam_smem(int W, int C, int ring, int* bytes, int* optin) {
  Smem s;
  *bytes = static_cast<int>(carve(nullptr, W, C, ring, &s));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
