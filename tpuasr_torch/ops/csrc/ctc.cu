// CTC forward-backward recursions in log space, for NVIDIA Hopper (sm_90a).
//
// Replace the TPU kernels tpuasr/ops/ctc.py:_alpha_kernel (launched by
// _run_alpha at ctc.py:128) and tpuasr/ops/ctc.py:_beta_kernel
// (launched by _bwd at ctc.py:195), with the same arithmetic:
//   lse3(a, b, c) = max(m' + log(e^(a-m') + e^(b-m') + e^(c-m')), LOG_EPS),
//                   m' = max(max(a, b, c), LOG_EPS)
//   alpha: alphas[0] = alpha0; for t >= 1, where frame t is valid,
//     alpha_t(s) = max(valid_s(s) ? lse3(a(s), a(s-1), skip(s) ? a(s-2)
//                  : LOG_EPS) + emit_t(s) : LOG_EPS, LOG_EPS),
//     and alpha passes through invalid frames.
//   beta (reverse time; beta_T = end_mask ? 0 : LOG_EPS):
//     e(s) = max(beta_{t+1}(s) + emit_{t+1}(s), LOG_EPS),
//     beta_t(s) = frame t+1 valid ? lse3(e(s), e(s+1), skip(s+2) ? e(s+2)
//                 : LOG_EPS) : beta_{t+1}(s)  (frame T is never valid),
//     out_t(s) = -exp(min(alphas_t(s) + beta_t(s) - logp, 0))
//                * frame_valid_t * dloss.
// The beta kernel reads the unshifted emit, frame_valid and allow_skip and
// folds in what the JAX package's _bwd does around its kernel (the one-frame
// shift, beta's start from end_mask, the frame mask and the cotangent), so
// it writes the finished dL/demit. LOG_EPS = -1e30 is a finite log-zero,
// never -inf; out-of-range neighbours (s-1 < 0, s+1 >= S) read LOG_EPS.
// Both kernels compute every cell with the plain version's operations in its
// order (libm's expf and logf), so they agree with it bit for bit: at T'=826
// the alphas reach ~-2000, where an f32 ulp is 1.2e-4, and a sum taken in
// another order (or the SFU's ex2/lg2) moves dL/demit past its 2e-4
// tolerance.
//
// Layouts (all contiguous, f32): emit, alphas, out (T, B, S); allow_skip,
// valid_s, alpha0, end_mask (B, S); frame_valid (T, B); logp, dloss (B).
//
// Bound. At the train shape (B=32, T=251, S=261) the alpha kernel moves
// 16.8 MB (5.0 us at 3.35 TB/s) and the beta kernel 25.2 MB (7.5 us); their
// exp/log work is ~2 us of SFU time. Neither bounds them: the chain does.
// T steps, each waiting on the previous step's whole row, are each a barrier,
// two neighbour reads from shared memory and one lse3 (~0.2 us with libm's
// expf and logf), so ~50 us at T=251.
//
// Design. A block per utterance holds the whole time loop. Thread i owns the
// J slots s = i + j * blockDim (J a template argument; J = 1 up to S = 1024):
// its values, masks and prefetched inputs live in registers. A step reads
// the neighbours from a double-buffered row in shared memory and meets the
// others at one barrier (__syncwarp when the block is one warp). Nothing
// from global memory is on the chain: each thread loads its slots of a
// coming frame's emit (and, in the beta kernel, alphas) into registers
// d_alpha(J) or d_beta(J) steps ahead, unconditionally (a slot past S loads
// slot S - 1), so nothing waits for a load before its step; the frame mask
// is a bit mask in shared memory, read once. A warp whose lse3 inputs are all log-zero (cells not
// yet reached, or past the transcript) takes lse3's exact result, LOG_EPS,
// without computing it, and a warp whose pending gradients all underflow
// writes the -0 that expf gives, so the live cells' warps have the
// sub-partitions to themselves. The beta kernel's gradient is deferred to
// the next step, after its barrier, in the shadow of the neighbour reads.
//
// Shared memory: two rows of S floats and the frame mask (T bits); they
// must fit a block: S up to ~29,000 on an H100 (227 KB); past that the plan
// refuses, and the wrapper raises before any launch.
//
// A step timer (clock64 spans of thread 0 summed over steps: the wait on
// the step's inputs, the lse3 math, the stores, the barrier with the
// neighbours' reads, the whole loop) is compiled in when TIMED; a timed
// build waits for each span's loads before closing it (a shared store of a
// loaded value stalls until it lands). The main path builds without it.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr float EXP_ZERO = -110.0f;  // expf(x) is +0 below ~-103.97
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int PARTS = 5;  // timer: inputs, lse3, store, exchange, loop
constexpr int DEFAULT_SLOTS = 1;
constexpr int SLOT_SET[] = {1, 2, 3, 4, 8, 16, 32};  // the instantiated J

// Steps ahead that a thread loads its inputs (D * J registers an input;
// J = 8 and up spill at 1024 threads, and are taken only past S = 4096).
// The depths at J = 1 are the fastest measured (PERF.md: alpha 1, 2 or 4
// steps ahead, beta 2, 4 or 8).
__host__ __device__ constexpr int d_alpha(int J) { return J <= 4 ? 2 : 1; }
__host__ __device__ constexpr int d_beta(int J) { return J == 1 ? 8 : J <= 4 ? 2 : 1; }

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float ms = fmaxf(fmaxf(fmaxf(a, b), c), LOG_EPS);
  return fmaxf(ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms)), LOG_EPS);
}

__device__ __forceinline__ void step_barrier(bool one_warp) {
  if (one_warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ long long span(long long* acc, long long c0) {
  const long long c = clock64();
  *acc += c - c0;
  return c;
}

__device__ __forceinline__ bool bit(const unsigned* bits, int t) {
  return (bits[t >> 5] >> (t & 31)) & 1u;
}

// The frame mask of utterance b as T bits in shared memory.
__device__ void load_frame_bits(const float* __restrict__ frame_valid, unsigned* bits,
                                int T, int B, int b) {
  for (int w = threadIdx.x; w < (T + 31) / 32; w += blockDim.x) {
    unsigned v = 0;
    for (int k = 0; k < 32 && w * 32 + k < T; ++k)
      v |= (frame_valid[static_cast<size_t>(w * 32 + k) * B + b] > 0.5f ? 1u : 0u) << k;
    bits[w] = v;
  }
}

// This thread's J slots of one frame's row. A slot past S loads slot S - 1
// (its value is never used): the loads are unconditional, so nothing waits
// for them until their step uses them.
template <int J>
__device__ __forceinline__ void load_row(float (&v)[J], const float* __restrict__ row, int S) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    v[j] = __ldg(row + (s < S ? s : S - 1));
  }
}

// grid = B, block = plan's threads, dynamic shared memory: two rows of S
// floats, the frame bits, a sink word for the timer.
template <int J, bool TIMED>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ allow_skip,
                     const float* __restrict__ valid_s, const float* __restrict__ frame_valid,
                     const float* __restrict__ alpha0, float* __restrict__ alphas,
                     long long* __restrict__ timer, int T, int B, int S) {
  constexpr int D = d_alpha(J);
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + S;
  unsigned* fbits = reinterpret_cast<unsigned*>(smem + 2 * S);
  volatile float* sink = reinterpret_cast<float*>(fbits + (T + 31) / 32);
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const bool one_warp = nth == 32;
  const size_t bs = static_cast<size_t>(b) * S, frame = static_cast<size_t>(B) * S;
  const float* em = emit + bs;  // frame t's row at em + t * frame
  float* out = alphas + bs;
  const long long t_begin = TIMED ? clock64() : 0;
  long long clk[PARTS - 1] = {0, 0, 0, 0};

  load_frame_bits(frame_valid, fbits, T, B, b);
  unsigned skip = 0, valid = 0;
  float a[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = tid + j * nth;
    a[j] = LOG_EPS;
    if (s < S) {
      skip |= (s >= 2 && allow_skip[bs + s] > 0.5f ? 1u : 0u) << j;
      valid |= (valid_s[bs + s] > 0.5f ? 1u : 0u) << j;
      a[j] = alpha0[bs + s];
      cur[s] = a[j];
      out[s] = a[j];  // t = 0 keeps alpha0 whatever frame_valid says
    }
  }
  float e[D][J];  // e[d]: the emissions of frame t0 + d, loaded D steps ahead
#pragma unroll
  for (int d = 0; d < D; ++d) load_row(e[d], em + (1 + d < T ? 1 + d : 0) * frame, S);
  __syncthreads();

  long long c0 = TIMED ? clock64() : 0;
  for (int t0 = 1; t0 < T; t0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = t0 + d;
      if (t >= T) break;
      float a1[J], a2[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = tid + j * nth;
        a1[j] = s >= 1 && s < S ? cur[s - 1] : LOG_EPS;
        a2[j] = (skip >> j) & 1u ? cur[s - 2] : LOG_EPS;
      }
      if (TIMED) {  // the barrier (at the end of the last step) and these reads
        if (tid == 0) *sink = a1[0] + a2[0];
        c0 = span(&clk[3], c0);
        if (tid == 0) *sink = e[d][0];  // this step's emissions, loaded D steps ago
        c0 = span(&clk[0], c0);
      }
      if (bit(fbits, t)) {
        bool zero = true;  // every input of this thread's lse3s log-zero
#pragma unroll
        for (int j = 0; j < J; ++j)
          zero &= a[j] == LOG_EPS && a1[j] == LOG_EPS && a2[j] == LOG_EPS;
        if (__all_sync(FULL, zero)) {  // lse3 would give LOG_EPS
#pragma unroll
          for (int j = 0; j < J; ++j)
            a[j] = (valid >> j) & 1u ? fmaxf(LOG_EPS + e[d][j], LOG_EPS) : LOG_EPS;
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float nw = lse3(a[j], a1[j], a2[j]) + e[d][j];
            a[j] = (valid >> j) & 1u ? fmaxf(nw, LOG_EPS) : LOG_EPS;
          }
        }
      }
      if (TIMED) {
        if (tid == 0) *sink = a[0];
        c0 = span(&clk[1], c0);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = tid + j * nth;
        if (s < S) {
          nxt[s] = a[j];
          out[t * frame + s] = a[j];
        }
      }
      if (t + D < T) load_row(e[d], em + (t + D) * frame, S);  // e[d] is used
      if (TIMED) c0 = span(&clk[2], c0);
      step_barrier(one_warp);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  if (TIMED && tid == 0) {
    clk[3] += clock64() - c0;
    long long* o = timer + static_cast<size_t>(b) * PARTS;
    for (int i = 0; i < PARTS - 1; ++i) o[i] = clk[i];
    o[PARTS - 1] = clock64() - t_begin;
  }
}

// This thread's pending gradients, -exp(min(g, 0)) * fv * dl, to `row`; a
// warp whose g all underflow writes expf's +0, negated, without calling it.
template <int J>
__device__ __forceinline__ void store_grad(float* __restrict__ row, const float (&g)[J], float fv,
                                           float dl, int S) {
  bool tiny = true;
#pragma unroll
  for (int j = 0; j < J; ++j) tiny &= g[j] < EXP_ZERO;
  const bool all_tiny = __all_sync(FULL, tiny);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    if (s < S) row[s] = (all_tiny ? -0.0f : -expf(fminf(g[j], 0.0f))) * fv * dl;
  }
}

// grid = B, block = plan's threads, shared memory as the alpha kernel's.
// Step k runs t = T - 1 - k.
template <int J, bool TIMED>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ allow_skip,
                    const float* __restrict__ frame_valid, const float* __restrict__ end_mask,
                    const float* __restrict__ alphas, const float* __restrict__ logp,
                    const float* __restrict__ dloss, float* __restrict__ out,
                    long long* __restrict__ timer, int T, int B, int S) {
  constexpr int D = d_beta(J);
  extern __shared__ float smem[];
  unsigned* fbits = reinterpret_cast<unsigned*>(smem + 2 * S);
  volatile float* sink = reinterpret_cast<float*>(fbits + (T + 31) / 32);
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const bool one_warp = nth == 32;
  const size_t bs = static_cast<size_t>(b) * S, frame = static_cast<size_t>(B) * S;
  const float* em = emit + bs;
  const float* al_g = alphas + bs;
  float* dm = out + bs;
  const float lp = logp[b], dl = dloss[b];
  const long long t_begin = TIMED ? clock64() : 0;
  long long clk[PARTS - 1] = {0, 0, 0, 0};

  load_frame_bits(frame_valid, fbits, T, B, b);
  unsigned skip2 = 0;
  float beta[J], g[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = tid + j * nth;
    beta[j] = LOG_EPS;
    g[j] = 0.0f;
    if (s < S) {
      skip2 |= (s + 2 < S && allow_skip[bs + s + 2] > 0.5f ? 1u : 0u) << j;
      beta[j] = end_mask[bs + s] > 0.5f ? 0.0f : LOG_EPS;
    }
  }
  // en[d], al[d]: step k0 + d's emit[t + 1] (LOG_EPS past the last frame)
  // and alphas[t], loaded D steps ahead
  float en[D][J], al[D][J];
  auto load_step = [&](float (&en_k)[J], float (&al_k)[J], int k) {
    const int t = T - 1 - k;
    if (t + 1 < T) {
      load_row(en_k, em + (t + 1) * frame, S);
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) en_k[j] = LOG_EPS;
    }
    load_row(al_k, al_g + t * frame, S);
  };
#pragma unroll
  for (int d = 0; d < D; ++d) load_step(en[d], al[d], d < T ? d : 0);
  __syncthreads();

  float fv_prev = 0.0f;  // frame_valid of the step whose gradient is pending
  long long c0 = TIMED ? clock64() : 0;
  for (int k0 = 0; k0 < T; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = k0 + d, t = T - 1 - k;
      if (k >= T) break;
      float* row = smem + (k & 1) * S;
      if (TIMED) {
        if (tid == 0) *sink = en[d][0] + al[d][0];
        c0 = span(&clk[0], c0);
      }
      float x[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = tid + j * nth;
        x[j] = s < S ? fmaxf(beta[j] + en[d][j], LOG_EPS) : LOG_EPS;
        if (s < S) row[s] = x[j];
      }
      if (TIMED) c0 = span(&clk[2], c0);
      step_barrier(one_warp);
      float x1[J], x2[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = tid + j * nth;
        x1[j] = s + 1 < S ? row[s + 1] : LOG_EPS;
        x2[j] = (skip2 >> j) & 1u ? row[s + 2] : LOG_EPS;
      }
      if (TIMED) {
        if (tid == 0) *sink = x1[0] + x2[0];
        c0 = span(&clk[3], c0);
      }
      if (k > 0) {  // the previous step's gradient, off the chain
        store_grad(dm + (t + 1) * frame, g, fv_prev, dl, S);
        if (TIMED) c0 = span(&clk[2], c0);
      }
      if (t + 1 < T && bit(fbits, t + 1)) {
        bool zero = true;  // every input of this thread's lse3s log-zero
#pragma unroll
        for (int j = 0; j < J; ++j)
          zero &= x[j] == LOG_EPS && x1[j] == LOG_EPS && x2[j] == LOG_EPS;
        if (__all_sync(FULL, zero)) {  // lse3 would give LOG_EPS
#pragma unroll
          for (int j = 0; j < J; ++j) beta[j] = LOG_EPS;
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) beta[j] = lse3(x[j], x1[j], x2[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) g[j] = (tid + j * nth < S ? al[d][j] : LOG_EPS) + beta[j] - lp;
      fv_prev = bit(fbits, t) ? 1.0f : 0.0f;
      if (TIMED) {
        if (tid == 0) *sink = g[0];
        c0 = span(&clk[1], c0);
      }
      if (k + D < T) load_step(en[d], al[d], k + D);  // en[d] and al[d] are used
    }
  }
  store_grad(dm, g, fv_prev, dl, S);  // frame 0's gradient
  if (TIMED && tid == 0) {
    clk[2] += clock64() - c0;
    long long* o = timer + static_cast<size_t>(b) * PARTS;
    for (int i = 0; i < PARTS - 1; ++i) o[i] = clk[i];
    o[PARTS - 1] = clock64() - t_begin;
  }
}

struct Plan {
  int J, threads;
  size_t smem;
  int optin;
};

// Slots a thread, threads and shared memory at (T, S). J: the smallest
// instantiated value >= slots (DEFAULT_SLOTS when <= 0) whose block, a
// thread for every J slots, has at most 1024 threads. J = 0 when S > 32 x
// 1024 or the two rows and the frame mask do not fit the card's shared
// memory.
int plan(int T, int S, int slots, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int want = slots > 0 ? slots : DEFAULT_SLOTS;
  p->J = 0;
  p->threads = 0;
  for (int j : SLOT_SET) {
    const int threads = ((S + j - 1) / j + 31) / 32 * 32;
    if (j >= want && threads <= MAX_THREADS) {
      p->J = j;
      p->threads = threads;
      break;
    }
  }
  p->smem = sizeof(float) * (2 * static_cast<size_t>(S) + (T + 31) / 32 + 1);
  p->optin = optin;
  if (p->smem > static_cast<size_t>(optin)) p->J = 0;
  return 0;
}

template <typename K>
int set_smem(K kernel, const Plan& p) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem)));
}

template <int J, bool TIMED>
int alpha_as(const Plan& p, const float* emit, const float* allow_skip, const float* valid_s,
             const float* frame_valid, const float* alpha0, float* alphas, long long* timer,
             int T, int B, int S, cudaStream_t st) {
  const int err = set_smem(ctc_alpha_kernel<J, TIMED>, p);
  if (err != 0) return err;
  ctc_alpha_kernel<J, TIMED><<<B, p.threads, p.smem, st>>>(emit, allow_skip, valid_s,
                                                           frame_valid, alpha0, alphas, timer,
                                                           T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int J, bool TIMED>
int beta_as(const Plan& p, const float* emit, const float* allow_skip, const float* frame_valid,
            const float* end_mask, const float* alphas, const float* logp, const float* dloss,
            float* out, long long* timer, int T, int B, int S, cudaStream_t st) {
  const int err = set_smem(ctc_beta_kernel<J, TIMED>, p);
  if (err != 0) return err;
  ctc_beta_kernel<J, TIMED><<<B, p.threads, p.smem, st>>>(
      emit, allow_skip, frame_valid, end_mask, alphas, logp, dloss, out, timer, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

#define CTC_SLOT_CASES(CASE) CASE(1) CASE(2) CASE(3) CASE(4) CASE(8) CASE(16) CASE(32)

template <bool TIMED>
int alpha_by_slots(const Plan& p, const float* emit, const float* allow_skip,
                   const float* valid_s, const float* frame_valid, const float* alpha0,
                   float* alphas, long long* timer, int T, int B, int S, cudaStream_t st) {
  switch (p.J) {
#define CASE(J)                                                                               \
  case J:                                                                                     \
    return alpha_as<J, TIMED>(p, emit, allow_skip, valid_s, frame_valid, alpha0, alphas, timer, \
                              T, B, S, st);
    CTC_SLOT_CASES(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool TIMED>
int beta_by_slots(const Plan& p, const float* emit, const float* allow_skip,
                  const float* frame_valid, const float* end_mask, const float* alphas,
                  const float* logp, const float* dloss, float* out, long long* timer, int T,
                  int B, int S, cudaStream_t st) {
  switch (p.J) {
#define CASE(J)                                                                                \
  case J:                                                                                      \
    return beta_as<J, TIMED>(p, emit, allow_skip, frame_valid, end_mask, alphas, logp, dloss, \
                             out, timer, T, B, S, st);
    CTC_SLOT_CASES(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The launch plan at (T, S) with `slots` slots a thread (<= 0: the
// default): out = {J, threads, shared memory bytes, the card's opt-in
// shared memory a block}; J = 0 when S does not fit. Launches nothing.
// Returns a CUDA error code.
int tpuasr_ctc_plan(int T, int S, int slots, long long* out) {
  Plan p{};
  const int err = plan(T, S, slots, &p);
  out[0] = p.J;
  out[1] = p.threads;
  out[2] = static_cast<long long>(p.smem);
  out[3] = p.optin;
  return err;
}

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue when S does not fit (the wrapper checks first).
int tpuasr_ctc_alpha(const float* emit, const float* allow_skip, const float* valid_s,
                     const float* frame_valid, const float* alpha0, float* alphas,
                     long long* timer, int T, int B, int S, int slots, void* stream) {
  Plan p{};
  const int err = plan(T, S, slots, &p);
  if (err != 0) return err;
  if (p.J == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return timer ? alpha_by_slots<true>(p, emit, allow_skip, valid_s, frame_valid, alpha0, alphas,
                                      timer, T, B, S, st)
               : alpha_by_slots<false>(p, emit, allow_skip, valid_s, frame_valid, alpha0, alphas,
                                       timer, T, B, S, st);
}

int tpuasr_ctc_beta(const float* emit, const float* allow_skip, const float* frame_valid,
                    const float* end_mask, const float* alphas, const float* logp,
                    const float* dloss, float* out, long long* timer, int T, int B, int S,
                    int slots, void* stream) {
  Plan p{};
  const int err = plan(T, S, slots, &p);
  if (err != 0) return err;
  if (p.J == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return timer ? beta_by_slots<true>(p, emit, allow_skip, frame_valid, end_mask, alphas, logp,
                                     dloss, out, timer, T, B, S, st)
               : beta_by_slots<false>(p, emit, allow_skip, frame_valid, end_mask, alphas, logp,
                                      dloss, out, timer, T, B, S, st);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
