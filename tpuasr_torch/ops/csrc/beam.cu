// K3: fused CTC prefix beam search with cutoff pruning, exact stay<->extend
// dedup, top-W selection and char/word n-gram fusion, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/beam.py:_beam_kernel (launched by
// beam_scan_pallas at beam.py:889) and computes its function, and that of
// the XLA search it falls back to (tpuasr/decode/beam.py), for any beam
// width, class count and LM order: the plain PyTorch version is
// tpuasr_torch/ops/beam.py:beam_scan_reference, which holds the same
// arithmetic in the same order. Per frame of one utterance:
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
//   5. pool = W stays then W*C extends; the W best by (score, then lowest
//      index), in that order.
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
// equal and the slot non-empty. The per-order (offset, cap, salt) rows are
// a small device array, copied to shared memory at the start. The char LM
// runs the _char_lm_scores recursion over each beam's context, its last
// k_ctx = max(1, order - 1) class ids (oldest first, as the XLA search's
// ctx); the word LM _word_lm_score with the partial-word hash, the
// completed-word ring (order - 1 tokens, read in shared memory) and the
// partial length. Products by alpha use __fmul_rn/__fadd_rn so that nvcc
// does not contract them into an FMA the plain version lacks.
//
// No limit on W, C or the LM order: backpointers are int8 when W <= 127 and
// C <= 126, else int32; the arrays that grow with W*C (the pool: scores,
// extend masses, extend LM scores) live in shared memory when they fit
// beside the beam state, else in a global workspace the wrapper allocates,
// one slice a block; the beam state too when it does not fit
// (tpuasr_beam_plan chooses; the code path is the same, the base pointers
// differ).
//
// Layouts: lp (B, T, C) f32; lengths (B) int32; parents, chars (B, T, W)
// int8 or int32; scores (B, W) f32; state (n_fields, B, W) int32 bit
// patterns in the order pb, pnb, h1, h2, last, [lm], [ctx_0 .. ctx_{k-1}],
// [wh1, wh2, wlen, wc1_0.., wc2_0..]; tables all orders concatenated, meta
// (order, 3) = offset, cap, salt.
//
// Bound. At B=32, T'=251, W=10, C=42 the work is ~20 k f32 operations a
// frame and utterance (the C*C rank compares, the 430-candidate pool's
// log-adds and selection passes), 161 M operations: 2.4 us at 67 TFLOP/s;
// the bytes (1.4 MB of log-probs in, 0.16 MB of int8 backpointers out) take
// 0.5 us. The real floor is the chain of T dependent frames, each ~9
// block-wide barriers and a few L2 round trips (the LM probes).
//
// Design. One thread block of 512 threads per utterance runs the whole
// time loop, so a decode is one launch with no grid barrier (16 warps: the
// frame's phases are latency chains, and more warps hide more of them).
// Per frame (the phases and the clock64 frame timer: ops/beam.py
// K3_PARTS, chip_smoke beam_split):
//   * the next frame's lp row is copied into a shared double buffer with
//     cp.async (4-byte words: a row of C floats is not 16-byte aligned at
//     every (b, t)) while this frame runs;
//   * rank pruning on all warps (a warp per class, ballots over 32 others
//     at a time); per-beam work on threads counted from the block's end,
//     so both overlap: each word-LM probe of each beam on a thread of its
//     own (word_item; the extend on the space combines them, word_combine),
//     the char context chains a thread per (beam, order);
//   * stay<->extend matching by prefix: a stay's hash is mix32(parent
//     hash, last char), and mix32 is invertible in the hash, so each stay
//     unmixes its own hash and looks its parent up in an open-addressed
//     table of the beams' hashes in shared memory (filled by the previous
//     frame's survivors): W lookups a frame in place of W*C hash compares.
//     A match marks the parent's extend by that char in a bitmask, which
//     the extend pass reads; the extend pass also writes the extends' pool
//     scores and the first radix histogram, and probes the char LM only
//     for extends above NEG (one at NEG is never selected: the dead stays,
//     first in the pool, win that tie);
//   * each stay then absorbs its one matching extend. The plain version
//     matches by hash equality; the two differ only where two different
//     prefixes share both 32-bit hashes (a 64-bit collision);
//   * top-W is a block-wide radix select: scores map to order-preserving
//     32-bit keys, 8-bit digits, one shared histogram a pass (the lanes
//     that share lane 0's digit add once), warp 0 finds the digit that
//     holds the W-th key; a pass whose bin is taken whole ends the search.
//     The W survivors (keys above the threshold, then the lowest indices
//     of those equal to it) are compacted in pool-index order by one block
//     scan, and each takes the slot of its rank among them, which
//     reproduces W rounds of (max, lowest index) exactly.
// An LM probe reads its 8-slot window's first keys in three 16-byte loads
// and the rest only where a first key matches: the probes were bound by
// L1 requests (16 scattered 4-byte loads each) and, in the word score, by
// a chain of dependent probes, which the per-item threads break.
// Templated on the LM mode and on a clock64 frame timer (off on the main
// path).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG = -1e30f;
constexpr float OOV_LOGP = -20.0f;
constexpr float WORD_OOV_NAT = static_cast<float>(-99.0 * 2.302585092994046);
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int RADIX = 256;       // 8-bit digits: 4 passes over a 32-bit key
constexpr int PROBE_UNROLL = 8;  // the packers' n_probes (vector loads); others run a loop
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t M1 = 0x9E3779B1u;
constexpr uint32_t M2 = 0x85EBCA77u;
constexpr uint32_t M1_INV = 0x0E8B2F51u;  // M * M_INV = 1 mod 2^32
constexpr uint32_t M2_INV = 0xB6C92F47u;
constexpr uint32_t BOS1 = 0x7F4A7C15u, BOS2 = 0x3C6EF372u;
constexpr uint32_t UNK1 = 0x9E3779B9u, UNK2 = 0x85EBCA6Bu;
constexpr uint32_t PAD1 = 0x50AD50ADu, PAD2 = 0xDEFACED1u;

enum { LM_NONE = 0, LM_CHAR = 1, LM_WORD = 2 };
// Where the arrays live: all in shared memory; the pool in the workspace;
// the beam state and the pool in the workspace.
enum { PLACE_SHARED = 0, PLACE_POOL = 1, PLACE_ALL = 2 };

// The frame timer's columns (ops/beam.py K3_PARTS): clock64 spans of
// thread 0 summed over the live frames: the wait for the prefetched lp
// row and the frame's last barrier, pruning + per-beam LM state + the
// stays' table, extends (+ flags, their pool scores and first histogram),
// absorption (+ the stays' pool scores), top-W, survivors + backpointers;
// then the whole loop, the barriers passed and the frames.
enum { SP_ROW, SP_PRUNE, SP_EXTEND, SP_ABSORB, SP_TOPW, SP_SURVIVE, SP_LOOP, SP_BARRIERS,
       SP_FRAMES, K3_PARTS };

struct Tables {
  const uint32_t* k1;
  const uint32_t* k2;
  const float* lp;
  const float* bo;
  const int* meta;  // (order, 3) offset, cap, salt, in device memory
  int order, n_probes;
};

struct Params {
  const float* lp;
  const int* lengths;
  int B, T, C, W, blank, top_n;
  float cutoff_prob, prune_logp, alpha, beta;
  int space, has_beta, ring, k_ctx;
  Tables tb;
  const int* state_in;
  int* state_out;
  void* parents;
  void* chars;
  float* scores;
  int out8;
  int place;
  unsigned char* work;  // workspace, work_stride bytes a block, or null
  size_t work_stride;
  long long* timer;  // (B, K3_PARTS) clock64 sums of thread 0, or null
};

// The beam state and per-frame scratch that grow with W (and the LM's
// order and ring), and the pool that grows with W*C. The same carve-out
// runs on the host (base = nullptr, for the sizes) and in the kernel.
struct State {
  float *lpb, *pb, *pnb, *lm, *ptot, *spb, *spnb, *cbo, *wv, *wb;
  int *meta, *keep, *last, *wlen, *ctx, *spar, *snew, *mext, *ht, *surv, *wf;
  uint32_t *h1, *h2, *wh1, *wh2, *wc1, *wc2, *ch1, *ch2, *survk, *amask;
};

struct Pool {
  float *score, *extv, *extlm;
};

// The word LM's probe items a beam and frame (word_item), top = min(order
// - 1, ring).
__host__ __device__ inline int word_items(int top) { return 3 * top + 3; }

__host__ __device__ inline int ht_size(int W) {  // a power of two >= 2W
  int n = 32;
  while (n < 2 * W) n *= 2;
  return n;
}

struct Carver {
  unsigned char* base;
  size_t off;
  template <typename Ptr>
  __host__ __device__ Ptr take(size_t words) {  // 4-byte words, each array 16-byte aligned
    unsigned char* p = base ? base + off : nullptr;
    off += (4 * words + 15) & ~static_cast<size_t>(15);
    return reinterpret_cast<Ptr>(p);
  }
};

__host__ __device__ inline size_t carve_state(unsigned char* base, int W, int C, int ring,
                                              int k_ctx, int order, State* s) {
  Carver cv{base, 0};
  const size_t w = W, w2 = 2 * static_cast<size_t>(W);
  s->lpb = cv.take<float*>(2 * static_cast<size_t>(C));  // [2][C], the prefetch ring
  s->keep = cv.take<int*>(C);
  s->meta = cv.take<int*>(3 * static_cast<size_t>(order));
  // double-buffered beam state: [2][W] (rings [2][ring][W], ctx [2][k_ctx][W])
  s->pb = cv.take<float*>(w2);
  s->pnb = cv.take<float*>(w2);
  s->lm = cv.take<float*>(w2);
  s->h1 = cv.take<uint32_t*>(w2);
  s->h2 = cv.take<uint32_t*>(w2);
  s->last = cv.take<int*>(w2);
  s->wh1 = cv.take<uint32_t*>(w2);
  s->wh2 = cv.take<uint32_t*>(w2);
  s->wlen = cv.take<int*>(w2);
  s->wc1 = cv.take<uint32_t*>(w2 * ring);
  s->wc2 = cv.take<uint32_t*>(w2 * ring);
  s->ctx = cv.take<int*>(w2 * k_ctx);
  // per-frame scratch
  s->ptot = cv.take<float*>(w);
  s->spb = cv.take<float*>(w);
  s->spnb = cv.take<float*>(w);
  s->spar = cv.take<int*>(w);
  s->snew = cv.take<int*>(w);
  s->mext = cv.take<int*>(w);
  s->surv = cv.take<int*>(w);
  s->survk = cv.take<uint32_t*>(w);
  s->ht = cv.take<int*>(2 * static_cast<size_t>(ht_size(W)));  // [2][HT], a frame each
  s->amask = cv.take<uint32_t*>(w * ((C + 31) / 32));  // [W][C / 32] absorbed extends
  s->ch1 = cv.take<uint32_t*>(w * order);  // [order][W]
  s->ch2 = cv.take<uint32_t*>(w * order);
  s->cbo = cv.take<float*>(w * order);
  // the word LM's probe items (ring > 0 only with a word LM)
  const size_t wi = ring > 0 ? w * word_items(order - 1 < ring ? order - 1 : ring) : 0;
  s->wf = cv.take<int*>(wi);
  s->wv = cv.take<float*>(wi);
  s->wb = cv.take<float*>(wi);
  return cv.off;
}

__host__ __device__ inline size_t carve_pool(unsigned char* base, int W, int C, bool lm,
                                             Pool* q) {
  Carver cv{base, 0};
  const size_t E = static_cast<size_t>(W) * C;
  q->score = cv.take<float*>(W + E);
  q->extv = cv.take<float*>(E);
  q->extlm = lm ? cv.take<float*>(E) : nullptr;
  return cv.off;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t x, uint32_t m) {
  h = (h ^ x) * m;
  return h ^ (h >> 15);
}

// mix32's inverse in h: the parent hash of a prefix hash and its last char.
__device__ __forceinline__ uint32_t unmix32(uint32_t h, uint32_t x, uint32_t m_inv) {
  h ^= (h >> 15) ^ (h >> 30);
  return (h * m_inv) ^ x;
}

// The home slot of a prefix hash in the beams' table (HT a power of two).
__device__ __forceinline__ int ht_home(uint32_t h1, int HT) {
  return static_cast<int>((h1 * M1) >> (33 - __ffs(HT)));
}

// Puts beam j's hash in a table: open addressing, linear probing.
__device__ __forceinline__ void ht_insert(int* ht, int HT, uint32_t h1, int j) {
  for (int k = ht_home(h1, HT);; k = (k + 1) & (HT - 1))
    if (atomicCAS(&ht[k], -1, j) == -1) return;
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

// An order-preserving 32-bit key of a score (-0 as +0, so that equal
// scores have equal keys).
__device__ __forceinline__ uint32_t score_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of one lp row into the ring: cp.async into shared
// memory, or plain copies into a buffer in the workspace.
__device__ __forceinline__ void load_row(float* dst, const float* src, int C) {
  if (__isShared(dst)) {
    for (int c = threadIdx.x; c < C; c += THREADS) cp_async4(dst + c, src + c);
    cp_async_commit();
  } else {
    for (int c = threadIdx.x; c < C; c += THREADS) dst[c] = src[c];
  }
}

// Order-k lookup: found, logp (NEG when absent), backoff. With the
// packers' 8 slots the window's first keys come in three aligned 16-byte
// loads (caps and offsets are multiples of 8 slots): one round trip and 3
// L1 requests in place of 16; the second key and the values are loaded
// only where the first key matches, and hits add in slot order.
__device__ __forceinline__ void probe(const Tables& tb, const int* meta, int k, uint32_t q1,
                                      uint32_t q2, bool* found, float* val, float* bo) {
  const int off = meta[3 * k];
  const uint32_t mask = static_cast<uint32_t>(meta[3 * k + 1] - 1);
  const uint32_t salt = static_cast<uint32_t>(meta[3 * k + 2]);
  const uint32_t slot = (salt ? fmix32(q1 ^ salt) : q1) & mask;
  bool f = false;
  float v = 0.0f, b = 0.0f;
  if (tb.n_probes == PROBE_UNROLL) {
    const uint32_t g0 = slot & ~3u;
    uint32_t hits = 0u;  // bit i: the first key at slot g0 + i equals q1
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(tb.k1 + off + ((g0 + 4 * g) & mask)));
      hits |= (static_cast<uint32_t>(x.x == q1) | static_cast<uint32_t>(x.y == q1) << 1 |
               static_cast<uint32_t>(x.z == q1) << 2 | static_cast<uint32_t>(x.w == q1) << 3)
              << (4 * g);
    }
    hits = (hits >> (slot & 3u)) & 0xFFu;  // the window, in slot order
    while (hits) {
      const int s = off + static_cast<int>((slot + (__ffs(hits) - 1)) & mask);
      hits &= hits - 1u;
      const uint32_t a2 = __ldg(tb.k2 + s);
      const float lv = __ldg(tb.lp + s), bv = __ldg(tb.bo + s);
      if (a2 == q2 && (q1 | a2) != 0u) {
        f = true;
        v += lv;
        b += bv;
      }
    }
  } else {
    for (int p = 0; p < tb.n_probes; ++p) {
      const int s = off + static_cast<int>((slot + p) & mask);
      const uint32_t a1 = __ldg(tb.k1 + s), a2 = __ldg(tb.k2 + s);
      if (a1 == q1 && a2 == q2 && (a1 | a2) != 0u) {
        f = true;
        v += __ldg(tb.lp + s);
        b += __ldg(tb.bo + s);
      }
    }
  }
  *found = f;
  *val = f ? v : NEG;
  *bo = b;
}

// The word LM (the XLA path's _word_lm_score): natural-log P(word | ring
// context) with Katz backoff, where the word is <unk> when it is not a
// unigram. Its probes of one frame are spread over threads (word_items):
// for beam j, item 0 is the unigram of its partial word; items 1 + 2i and
// 2 + 2i (i = 0..top) the order top - i lookup with the word and with
// <unk>; items 3 + 2 top + i (i < top) the backoff of order top - i - 1.
// Item it of beam j sits at it * W + j; the ring is c1[r * stride],
// c2[r * stride], oldest first.
__device__ void word_item(const Tables& tb, const int* meta, int ring, int top, int it,
                          uint32_t wh1, uint32_t wh2, const uint32_t* c1, const uint32_t* c2,
                          int stride, bool* f, float* v, float* bo) {
  if (it == 0) {
    probe(tb, meta, 0, mix32(0u, wh1, M1), mix32(0u, wh2, M2), f, v, bo);
    return;
  }
  const bool backoff = it >= 3 + 2 * top;
  const int m = backoff ? top - (it - 3 - 2 * top) : top - (it - 1) / 2;  // context words
  uint32_t k1 = 0u, k2 = 0u;
  for (int i = 0; i < m; ++i) {
    k1 = mix32(k1, c1[(ring - m + i) * stride], M1);
    k2 = mix32(k2, c2[(ring - m + i) * stride], M2);
  }
  if (backoff) {
    probe(tb, meta, m - 1, k1, k2, f, v, bo);
  } else {
    const bool unk = ((it - 1) & 1) != 0;
    probe(tb, meta, m, mix32(k1, unk ? UNK1 : wh1, M1), mix32(k2, unk ? UNK2 : wh2, M2), f, v,
          bo);
  }
}

// The word's score from the items' (found, logp, backoff) at
// wf/wv/wb[it * W + j]: the Katz recursion, highest order first.
__device__ float word_combine(const int* wf, const float* wv, const float* wb, int W, int top,
                              int j) {
  const int unk = wf[j] ? 0 : 1;
  float bo_acc = 0.0f;
  for (int i = 0; i <= top; ++i) {
    const int it = (1 + 2 * i + unk) * W + j;
    if (wf[it]) return bo_acc + wv[it];  // resolved: the lower orders change nothing
    if (i < top) {
      const int bt = (3 + 2 * top + i) * W + j;
      bo_acc = bo_acc + (wf[bt] ? wb[bt] : 0.0f);
    }
  }
  return bo_acc + WORD_OOV_NAT;
}

// Char LM: natural-log P(c | context) from a beam's context chains
// ch[m * W] (hash of its last m chars) and step backoffs cbo[m * W].
__device__ float char_score(const Tables& tb, const int* meta, const uint32_t* ch1,
                            const uint32_t* ch2, const float* cbo, int W, int c) {
  float bo_acc = 0.0f;
  for (int m = tb.order - 1; m >= 0; --m) {
    bool f;
    float v, bo;
    probe(tb, meta, m, mix32(ch1[m * W], c, M1), mix32(ch2[m * W], c, M2), &f, &v, &bo);
    if (f) return bo_acc + v;  // resolved: the lower orders change nothing
    if (m > 0) bo_acc = bo_acc + cbo[m * W];
  }
  return OOV_LOGP;
}

__device__ __forceinline__ void store_bp(void* out, int out8, size_t i, int v) {
  if (out8)
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(v);
  else
    static_cast<int*>(out)[i] = v;
}

// One count for `digit` (< 0: none) from every lane of the warp; the lanes
// that share lane 0's digit add once, through the lowest of them. All 32
// lanes call it.
__device__ __forceinline__ void hist_add(int* hist, int digit, int lane) {
  const int d0 = __shfl_sync(FULL, digit, 0);
  const unsigned same = __ballot_sync(FULL, digit == d0);
  if (digit < 0) return;
  if (digit != d0)
    atomicAdd(&hist[digit], 1);
  else if (lane == __ffs(same) - 1)
    atomicAdd(&hist[digit], __popc(same));
}

// Ends a phase: the block barrier, and with the timer on thread 0's span.
template <bool TIMED>
__device__ __forceinline__ void phase_end(long long* acc, long long* t_prev, int span) {
  __syncthreads();
  if (TIMED && threadIdx.x == 0) {
    const long long now = clock64();
    acc[span] += now - *t_prev;
    *t_prev = now;
    acc[SP_BARRIERS] += 1;
  }
}

// Ends a span without a barrier (thread 0's own work).
template <bool TIMED>
__device__ __forceinline__ void span_end(long long* acc, long long* t_prev, int span) {
  if (TIMED && threadIdx.x == 0) {
    const long long now = clock64();
    acc[span] += now - *t_prev;
    *t_prev = now;
  }
}

template <int LM, bool TIMED>
__global__ void __launch_bounds__(THREADS) beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int hist[RADIX];
  __shared__ float wmax[NWARPS];
  __shared__ unsigned long long wsum[NWARPS];
  __shared__ int pick[3];  // the radix digit, the count still needed, the bin taken whole

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rt = THREADS - 1 - tid;  // per-beam work counts from the block's end
  const int W = p.W, C = p.C, E = W * C, P = W + E, ring = p.ring, k_ctx = p.k_ctx;
  const int order = LM == LM_NONE ? 0 : p.tb.order;
  const int T = p.T;
  const int len = min(max(p.lengths[b], 0), T);
  const int HT = ht_size(W);
  const int NW = (C + 31) / 32;  // words of an absorbed-extend mask a beam
  const int wtop = LM == LM_WORD ? min(order - 1, ring) : 0;
  const int step_j = THREADS / C, step_c = THREADS - step_j * C;

  unsigned char* work = p.work ? p.work + static_cast<size_t>(b) * p.work_stride : nullptr;
  State s;
  Pool q;
  const size_t state_bytes = carve_state(p.place == PLACE_ALL ? work : smem_raw, W, C, ring,
                                         k_ctx, order, &s);
  unsigned char* pool_base = p.place == PLACE_SHARED ? smem_raw + state_bytes
                             : p.place == PLACE_POOL ? work
                                                     : work + state_bytes;
  carve_pool(pool_base, W, C, LM != LM_NONE, &q);
  const float* lp0 = p.lp + static_cast<size_t>(b) * T * C;

  // ---- initial state (buffer 0), LM metadata, the first lp row ----
  if (len > 0) load_row(s.lpb, lp0, C);
  for (int k = tid; k < 3 * order; k += THREADS) s.meta[k] = p.tb.meta[k];
  for (int k = tid; k < 2 * HT; k += THREADS) s.ht[k] = -1;
  for (int k = tid; k < W * NW; k += THREADS) s.amask[k] = 0u;
  for (int k = tid; k < RADIX; k += THREADS) hist[k] = 0;
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
      if (LM == LM_CHAR)
        for (int i = 0; i < k_ctx; ++i) s.ctx[i * W + j] = f(k++);
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
      for (int i = 0; i < k_ctx; ++i) s.ctx[i * W + j] = 0;
      s.wh1[j] = s.wh2[j] = 0u;
      s.wlen[j] = 0;
      for (int r = 0; r < ring; ++r) {
        s.wc1[r * W + j] = r == ring - 1 ? BOS1 : PAD1;
        s.wc2[r * W + j] = r == ring - 1 ? BOS2 : PAD2;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < W; j += THREADS) ht_insert(s.ht, HT, s.h1[j], j);  // frame 0's beams
  cp_async_wait_all();
  __syncthreads();

  long long acc[K3_PARTS] = {};
  long long t_prev = TIMED ? clock64() : 0;
  const long long t_begin = t_prev;
  int cur = 0;
  for (int t = 0; t < len; ++t) {
    const int co = cur * W, no = (cur ^ 1) * W;  // state buffer offsets
    const float* lp = s.lpb + (t & 1) * C;
    if (t + 1 < len) load_row(s.lpb + ((t + 1) & 1) * C, lp0 + static_cast<size_t>(t + 1) * C, C);

    // ---- 1. pruning (a warp per class); per-beam sums, LM state, the
    // stays' hash table (threads from the block's end) ----
    for (int c = warp; c < C; c += NWARPS) {
      const float lc = lp[c];
      int rank = 0;
      float excl = 0.0f;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        const float lj = j < C ? lp[j] : 0.0f;
        const bool bt = j < C && (lj > lc || (lj == lc && j < c));
        rank += __popc(__ballot_sync(FULL, bt));
        if (p.cutoff_prob < 1.0f && bt) excl += expf(lj);
      }
      if (p.cutoff_prob < 1.0f)
        for (int o = 16; o > 0; o >>= 1) excl += __shfl_xor_sync(FULL, excl, o);
      if (lane == 0) {
        bool k = rank < p.top_n;
        if (p.cutoff_prob < 1.0f) k = k && excl < p.cutoff_prob;
        s.keep[c] = k && (lc > p.prune_logp || c == p.blank);
      }
    }
    // each stay's one matching extend: its parent prefix (its hash
    // unmixed by its last char) among the beams, then that parent's
    // extend by the last char
    const int* ht = s.ht + (t & 1) * HT;
    for (int i = rt; i < W; i += THREADS) {
      s.ptot[i] = lse(s.pb[co + i], s.pnb[co + i]);
      const int l = s.last[co + i];
      int me = -1;
      if (l >= 0) {
        const uint32_t a1 = unmix32(s.h1[co + i], l, M1_INV);
        const uint32_t a2 = unmix32(s.h2[co + i], l, M2_INV);
        for (int k = ht_home(a1, HT); ht[k] >= 0; k = (k + 1) & (HT - 1)) {
          const int j = ht[k];
          if (s.h1[co + j] == a1 && s.h2[co + j] == a2) {
            me = j * C + l;
            atomicOr(&s.amask[j * NW + (l >> 5)], 1u << (l & 31));
          }
        }
      }
      s.mext[i] = me;
    }
    if (LM == LM_WORD) {  // the word LM's probes: a thread per (beam, item)
      for (int u = rt; u < W * word_items(wtop); u += THREADS) {
        const int it = u / W, j = u - it * W;
        bool f;
        float v, bo;
        word_item(p.tb, s.meta, ring, wtop, it, s.wh1[co + j], s.wh2[co + j],
                  s.wc1 + cur * ring * W + j, s.wc2 + cur * ring * W + j, W, &f, &v, &bo);
        s.wf[u] = f;
        s.wv[u] = v;
        s.wb[u] = bo;
      }
    }
    if (LM == LM_CHAR) {  // context chains: a thread per (beam, order)
      const int* ctx = s.ctx + cur * k_ctx * W;
      for (int u = rt; u < W * order; u += THREADS) {
        const int m = u / W, j = u - m * W;
        uint32_t a1 = 0u, a2 = 0u;
        for (int i = k_ctx - m; i < k_ctx; ++i) {
          const uint32_t x = static_cast<uint32_t>(ctx[i * W + j]);
          a1 = mix32(a1, x, M1);
          a2 = mix32(a2, x, M2);
        }
        s.ch1[m * W + j] = a1;
        s.ch2[m * W + j] = a2;
        float step = 0.0f;
        if (m > 0) {
          bool bf;
          float bv, bbo;
          probe(p.tb, s.meta, m - 1, a1, a2, &bf, &bv, &bbo);
          step = bf ? bbo : 0.0f;
        }
        s.cbo[m * W + j] = step;
      }
    }
    phase_end<TIMED>(acc, &t_prev, SP_PRUNE);

    // ---- 2. stays; extends, each probing the stays' table once, with
    // their pool scores and the first radix histogram ----
    for (int j = rt; j < W; j += THREADS) {
      s.spb[j] = s.keep[p.blank] ? s.ptot[j] + lp[p.blank] : NEG;
      const int l = s.last[co + j];
      s.spnb[j] = l >= 0 && s.keep[l] ? s.pnb[co + j] + lp[l] : NEG;
    }
    float lmax = -3.0e38f;  // below every extend score (>= NEG)
    int j = tid / C, c = tid - j * C;  // e = j * C + c, stepped by THREADS
    for (int e0 = 0; e0 < E; e0 += THREADS, j += step_j, c += step_c) {
      if (c >= C) {
        c -= C;
        ++j;
      }
      const int e = e0 + tid;
      int digit = -1;
      if (e < E) {
        const float base = s.last[co + j] == c ? s.pb[co + j] : s.ptot[j];
        const float v = (c == p.blank || !s.keep[c]) ? NEG : base + lp[c];
        lmax = fmaxf(lmax, v);
        const bool m = (s.amask[j * NW + (c >> 5)] >> (c & 31)) & 1u;  // absorbed
        const float ev = m ? NEG : v;
        q.extv[e] = ev;
        float sc = fmaxf(ev, NEG);  // lse(NEG, ev), exactly, in f32
        if (LM == LM_CHAR) {
          // an extend at NEG scores NEG whatever its LM term and is never
          // selected (the dead stays, first in the pool, win that tie), so
          // its probes are skipped
          float el = s.lm[co + j];
          if (ev > NEG) {
            const float csc = char_score(p.tb, s.meta, s.ch1 + j, s.ch2 + j, s.cbo + j, W, c);
            float add = __fmul_rn(p.alpha, csc);
            if (p.has_beta) add = __fadd_rn(add, c == p.space ? p.beta : 0.0f);
            el = __fadd_rn(s.lm[co + j], add);
          }
          q.extlm[e] = el;
          sc = sc + el;
        }
        if (LM == LM_WORD) {
          float bonus = 0.0f;  // the word's close, on the space extend only
          if (c == p.space && s.wlen[co + j] > 0)
            bonus = __fadd_rn(__fmul_rn(p.alpha, word_combine(s.wf, s.wv, s.wb, W, wtop, j)),
                              p.beta);
          const float el = s.lm[co + j] + bonus;
          q.extlm[e] = el;
          sc = sc + el;
        }
        q.score[W + e] = sc;
        digit = static_cast<int>(score_key(sc) >> 24);
      }
      hist_add(hist, digit, lane);
    }
    for (int o = 16; o > 0; o >>= 1) lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, o));
    if (lane == 0) wmax[warp] = lmax;
    phase_end<TIMED>(acc, &t_prev, SP_EXTEND);

    // ---- 3. absorption: each stay takes its matching extends; its pool
    // score; the stays' table emptied for the next frame ----
    float kmax = wmax[0];
    for (int w = 1; w < NWARPS; ++w) kmax = fmaxf(kmax, wmax[w]);
    kmax = fmaxf(kmax, -1e20f);
    for (int k = tid; k < HT; k += THREADS) s.ht[(t & 1) * HT + k] = -1;
    for (int k = tid; k < W * NW; k += THREADS) s.amask[k] = 0u;
    for (int i0 = 0; i0 < W; i0 += THREADS) {
      const int i = i0 + tid;
      int digit = -1;
      if (i < W) {
        const int e = s.mext[i];
        float acc_e = 0.0f, bv = NEG;
        int bi = 0;
        if (e >= 0) {  // extend e, unmasked, as the extend pass made it
          const int j = e / C, c = e - j * C;
          const float base = s.last[co + j] == c ? s.pb[co + j] : s.ptot[j];
          const float v = (c == p.blank || !s.keep[c]) ? NEG : base + lp[c];
          if (v > NEG / 2) acc_e = expf(v - kmax);
          if (v > NEG) {  // better(NEG, 0, v, e)
            bv = v;
            bi = e;
          }
        }
        const float alog = acc_e > 0.0f ? logf(acc_e) + kmax : NEG;
        const float pre = lse(s.spb[i], s.spnb[i]);
        const float spnb = lse(s.spnb[i], alog);
        s.spnb[i] = spnb;
        const bool take = bv > pre;
        s.spar[i] = take ? bi / C : i;
        s.snew[i] = take ? bi % C : -1;
        float sc = lse(s.spb[i], spnb);
        if (LM != LM_NONE) sc = sc + s.lm[co + i];
        q.score[i] = sc;
        digit = static_cast<int>(score_key(sc) >> 24);
      }
      hist_add(hist, digit, lane);
    }
    phase_end<TIMED>(acc, &t_prev, SP_ABSORB);

    // ---- 4. top-W: radix select of the W-th key, 8 bits a pass ----
    uint32_t prefix = 0u, pmask = 0u;
    int need = W;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      if (pass > 0) {
        for (int q0 = 0; q0 < P; q0 += THREADS) {
          const int qi = q0 + tid;
          int digit = -1;
          if (qi < P) {
            const uint32_t key = score_key(q.score[qi]);
            if ((key & pmask) == prefix) digit = static_cast<int>((key >> shift) & 255u);
          }
          hist_add(hist, digit, lane);
        }
        phase_end<TIMED>(acc, &t_prev, SP_TOPW);
      }
      if (warp == 0) {  // lane l holds bins 255 - 8l down to 248 - 8l
        int cnt[8], sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          cnt[i] = hist[255 - 8 * lane - i];
          hist[255 - 8 * lane - i] = 0;
          sum += cnt[i];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int n = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += n;
        }
        int run = incl - sum;
        if (run < need && incl >= need) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (run < need && run + cnt[i] >= need) {
              pick[0] = 255 - 8 * lane - i;
              pick[1] = need - run;
              pick[2] = cnt[i] == need - run;
            }
            run += cnt[i];
          }
        }
      }
      phase_end<TIMED>(acc, &t_prev, SP_TOPW);
      prefix |= static_cast<uint32_t>(pick[0]) << shift;
      pmask |= 255u << shift;
      need = pick[1];
      if (pick[2]) break;  // the bin is taken whole
    }
    // survivors in pool-index order: the keys above the threshold, then
    // the first `need` equal to it; one block scan of (above, equal)
    {
      const int chunk = (P + THREADS - 1) / THREADS;
      const int q0 = min(P, tid * chunk), q1 = min(P, q0 + chunk);
      unsigned long long mine = 0ull;  // above << 32 | equal
      for (int qi = q0; qi < q1; ++qi) {
        const uint32_t km = score_key(q.score[qi]) & pmask;
        mine += km > prefix ? (1ull << 32) : (km == prefix ? 1ull : 0ull);
      }
      unsigned long long incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long n = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += n;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      unsigned long long before = incl - mine;
      for (int w = 0; w < warp; ++w) before += wsum[w];
      int pos = static_cast<int>(before >> 32);
      int eq = static_cast<int>(before & 0xffffffffull);
      pos += min(eq, need);
      for (int qi = q0; qi < q1; ++qi) {
        const uint32_t key = score_key(q.score[qi]);
        const uint32_t km = key & pmask;
        bool in = km > prefix;
        if (km == prefix) in = eq++ < need;
        if (in) {
          s.surv[pos] = qi;
          s.survk[pos] = key;
          ++pos;
        }
      }
    }
    phase_end<TIMED>(acc, &t_prev, SP_TOPW);
    if (TIMED && tid == 0) acc[SP_BARRIERS] += 1;  // the scan's barrier

    // ---- 5. survivors: each takes the slot of its rank; next state;
    // backpointers out ----
    const size_t out0 = (static_cast<size_t>(b) * T + t) * W;
    for (int k = tid; k < W; k += THREADS) {
      const uint32_t kk = s.survk[k];
      int r = 0;
      for (int j = 0; j < W; ++j) {
        const uint32_t kj = s.survk[j];
        r += kj > kk || (kj == kk && j < k);
      }
      const int qi = s.surv[k];
      int par, nc;
      if (qi < W) {
        s.pb[no + r] = s.spb[qi];
        s.pnb[no + r] = s.spnb[qi];
        s.h1[no + r] = s.h1[co + qi];
        s.h2[no + r] = s.h2[co + qi];
        s.last[no + r] = s.last[co + qi];
        if (LM != LM_NONE) s.lm[no + r] = s.lm[co + qi];
        if (LM == LM_CHAR)
          for (int i = 0; i < k_ctx; ++i)
            s.ctx[((cur ^ 1) * k_ctx + i) * W + r] = s.ctx[(cur * k_ctx + i) * W + qi];
        par = s.spar[qi];
        nc = s.snew[qi];
      } else {
        const int e = qi - W, j = e / C, c = e - j * C;
        s.pb[no + r] = NEG;
        s.pnb[no + r] = q.extv[e];
        s.h1[no + r] = mix32(s.h1[co + j], c, M1);
        s.h2[no + r] = mix32(s.h2[co + j], c, M2);
        s.last[no + r] = c;
        if (LM != LM_NONE) s.lm[no + r] = q.extlm[e];
        if (LM == LM_CHAR)
          for (int i = 0; i < k_ctx; ++i)
            s.ctx[((cur ^ 1) * k_ctx + i) * W + r] =
                i + 1 < k_ctx ? s.ctx[(cur * k_ctx + i + 1) * W + j] : c;
        par = j;
        nc = c;
      }
      if (LM == LM_WORD) {
        // the word state follows the selected parent, then the space /
        // grow transitions of an extended beam
        const int pw = s.wlen[co + par];
        const bool ext = nc >= 0, is_space = ext && nc == p.space;
        const bool closes = is_space && pw > 0, grows = ext && nc != p.space;
        for (int rr = 0; rr < ring; ++rr) {
          const int src = cur * ring * W + rr * W + par, dst = (cur ^ 1) * ring * W + rr * W + r;
          const bool newest = rr + 1 == ring;
          // the token that enters the ring: the word, or <unk> when it is
          // not a unigram
          const uint32_t e1 = s.wf[par] ? s.wh1[co + par] : UNK1;
          const uint32_t e2 = s.wf[par] ? s.wh2[co + par] : UNK2;
          s.wc1[dst] = closes ? (newest ? e1 : s.wc1[src + W]) : s.wc1[src];
          s.wc2[dst] = closes ? (newest ? e2 : s.wc2[src + W]) : s.wc2[src];
        }
        const uint32_t u = static_cast<uint32_t>(nc > 0 ? nc : 0);
        const uint32_t p1 = s.wh1[co + par], p2 = s.wh2[co + par];
        s.wh1[no + r] = is_space ? 0u : (grows ? mix32(p1, u, M1) : p1);
        s.wh2[no + r] = is_space ? 0u : (grows ? mix32(p2, u, M2) : p2);
        s.wlen[no + r] = is_space ? 0 : (grows ? pw + 1 : pw);
      }
      ht_insert(s.ht + ((t + 1) & 1) * HT, HT, s.h1[no + r], r);  // the next frame's beams
      store_bp(p.parents, p.out8, out0 + r, par);
      store_bp(p.chars, p.out8, out0 + r, nc);
    }
    span_end<TIMED>(acc, &t_prev, SP_SURVIVE);
    cp_async_wait_all();  // the next frame's row
    phase_end<TIMED>(acc, &t_prev, SP_ROW);
    cur ^= 1;
  }
  if (TIMED && tid == 0) {
    acc[SP_LOOP] = clock64() - t_begin;
    acc[SP_FRAMES] = len;
    for (int k = 0; k < K3_PARTS; ++k) p.timer[static_cast<size_t>(b) * K3_PARTS + k] = acc[k];
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
  if (LM == LM_WORD) {  // the close of each final partial word
    for (int u = tid; u < W * word_items(wtop); u += THREADS) {
      const int it = u / W, j = u - it * W;
      bool f;
      float v, bo;
      word_item(p.tb, s.meta, ring, wtop, it, s.wh1[co + j], s.wh2[co + j],
                s.wc1 + cur * ring * W + j, s.wc2 + cur * ring * W + j, W, &f, &v, &bo);
      s.wf[u] = f;
      s.wv[u] = v;
      s.wb[u] = bo;
    }
    __syncthreads();
  }
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
      if (LM == LM_CHAR)
        for (int i = 0; i < k_ctx; ++i) put(k++, s.ctx[(cur * k_ctx + i) * W + j]);
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
    if (LM == LM_WORD)
      sc = sc + (s.wlen[co + j] > 0
                     ? __fadd_rn(__fmul_rn(p.alpha, word_combine(s.wf, s.wv, s.wb, W, wtop, j)),
                                 p.beta)
                     : 0.0f);
    p.scores[static_cast<size_t>(b) * W + j] = sc;
  }
}

template <int LM, bool TIMED>
int launch_as(const Params& p, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<LM, TIMED>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel<LM, TIMED><<<p.B, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int LM>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  return p.timer ? launch_as<LM, true>(p, smem, stream) : launch_as<LM, false>(p, smem, stream);
}

// Sizes of the two regions and where they go: the state and the pool in
// shared memory when both fit beside the kernel's static shared memory,
// else the pool in the workspace, else both; never below `min_place`.
int plan(int W, int C, int ring, int k_ctx, int order, int lm_mode, int min_place, int* place,
         size_t* dyn_smem, size_t* work_bytes) {
  State s;
  Pool q;
  const size_t state = carve_state(nullptr, W, C, ring, k_ctx, order, &s);
  const size_t pool = carve_pool(nullptr, W, C, lm_mode != LM_NONE, &q);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, beam_kernel<LM_WORD, true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t avail = static_cast<size_t>(optin) > fa.sharedSizeBytes
                           ? static_cast<size_t>(optin) - fa.sharedSizeBytes : 0;
  int pl = state + pool <= avail ? PLACE_SHARED : state <= avail ? PLACE_POOL : PLACE_ALL;
  pl = pl > min_place ? pl : min_place;
  *place = pl;
  *dyn_smem = pl == PLACE_SHARED ? state + pool : pl == PLACE_POOL ? state : 0;
  const size_t work = pl == PLACE_SHARED ? 0 : pl == PLACE_POOL ? pool : state + pool;
  *work_bytes = (work + 255) & ~static_cast<size_t>(255);
  return 0;
}

}  // namespace

extern "C" {

// Where K3 puts its arrays for this configuration (*place: 0 all in shared
// memory, 1 the pool in the workspace, 2 the state too; never below
// min_place) and the workspace it needs a block, in bytes (the wrapper
// allocates B times that). Returns a CUDA error code.
int tpuasr_beam_plan(int W, int C, int ring, int k_ctx, int order, int lm_mode, int min_place,
                     int* place, long long* work_bytes) {
  size_t dyn = 0, work = 0;
  const int err = plan(W, C, ring, k_ctx, order, lm_mode, min_place, place, &dyn, &work);
  *work_bytes = static_cast<long long>(work);
  return err;
}

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments K3 does not take (a bad shape, class
// id or LM setting, or a workspace smaller than tpuasr_beam_plan's).
int tpuasr_beam_scan(const float* lp, const int* lengths, int B, int T, int C, int W,
                     int blank, int top_n, float cutoff_prob, float prune_logp, int lm_mode,
                     const uint32_t* k1, const uint32_t* k2, const float* tlp,
                     const float* tbo, const int* meta, int order, int n_probes, float alpha,
                     float beta, int space, int has_beta, int ring, int k_ctx,
                     const int* state_in, int* state_out, void* parents, void* chars,
                     float* scores, int out8, int min_place, void* work, long long work_stride,
                     long long* timer, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (W < 1 || C < 1 || B < 0 || T < 0) return invalid;
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
  p.k_ctx = lm_mode == LM_CHAR ? k_ctx : 0;
  p.state_in = state_in;
  p.state_out = state_out;
  p.parents = parents;
  p.chars = chars;
  p.scores = scores;
  p.out8 = out8;
  p.timer = timer;
  if (lm_mode != LM_NONE) {
    if (order < 1 || n_probes < 1 || meta == nullptr) return invalid;
    if (lm_mode == LM_WORD && (ring < 1 || space < 0 || space >= C)) return invalid;
    if (lm_mode == LM_CHAR && k_ctx < 1) return invalid;
    p.tb.k1 = k1;
    p.tb.k2 = k2;
    p.tb.lp = tlp;
    p.tb.bo = tbo;
    p.tb.meta = meta;
    p.tb.order = order;
    p.tb.n_probes = n_probes;
  }
  size_t dyn = 0, need = 0;
  const int err = plan(W, C, p.ring, p.k_ctx, lm_mode == LM_NONE ? 0 : order, lm_mode,
                       min_place, &p.place, &dyn, &need);
  if (err != 0 || B == 0) return err;
  if (need > 0 && (work == nullptr || static_cast<size_t>(work_stride) < need)) return invalid;
  p.work = static_cast<unsigned char*>(work);
  p.work_stride = static_cast<size_t>(work_stride);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lm_mode) {
    case LM_CHAR:
      return launch<LM_CHAR>(p, dyn, st);
    case LM_WORD:
      return launch<LM_WORD>(p, dyn, st);
    default:
      return launch<LM_NONE>(p, dyn, st);
  }
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
