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
//   beta (reverse time, inputs pre-shifted by one frame: emit_next[t] =
//     emit[t+1], fv_next[t] = frame_valid[t+1], skip2(s) = skip(s+2)):
//     e(s) = max(beta(s) + emit_next_t(s), LOG_EPS),
//     beta_t(s) = fv_next_t ? lse3(e(s), e(s+1), skip2(s) ? e(s+2) :
//                 LOG_EPS) : beta(s),
//     demit_t(s) = -exp(min(alphas_t(s) + beta_t(s) - logp, 0)).
// LOG_EPS = -1e30 is a finite log-zero, never -inf. Out-of-range
// neighbours (s-1 < 0, s+1 >= S) read LOG_EPS, as the TPU kernels'
// shifts fill them.
//
// Layouts (all contiguous, f32): emit, emit_next, alphas, demit
// (T, B, S); allow_skip, valid_s, skip2, alpha0, beta_init (B, S);
// frame_valid, fv_next (T, B); logp (B).
//
// Bound. At the train shape (B=32, T=251, S=261) the alpha kernel moves
// 16.8 MB (emit in, alphas out: 5.0 us at 3.35 TB/s) and the beta kernel
// 25.2 MB (7.5 us); their exp/log work is ~2 us of SFU time. The real
// floor is the dependency chain: T steps, each waiting on the previous
// step's whole row.
//
// Design. One launch per recursion holds the whole time loop: a block
// per utterance, a thread per extended-label slot s (threads loop when
// S > 1024), the row held in shared memory, double-buffered so that one
// __syncthreads per step separates a step's reads from the next step's
// writes. The per-utterance masks are read once into registers.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr int SLOTS = 4;  // slots a thread holds masks for (S <= 4096)

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, LOG_EPS);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return fmaxf(out, LOG_EPS);
}

// grid = B, block = threads(S), dynamic shared memory 2 * S floats.
__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const float* __restrict__ allow_skip,
                                 const float* __restrict__ valid_s,
                                 const float* __restrict__ frame_valid,
                                 const float* __restrict__ alpha0,
                                 float* __restrict__ alphas, int T, int B,
                                 int S) {
  extern __shared__ float row[];
  float* cur = row;
  float* nxt = row + S;
  const int b = blockIdx.x;
  const size_t bs = static_cast<size_t>(b) * S;
  bool skip[SLOTS], valid[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    skip[i] = s < S && allow_skip[bs + s] > 0.5f;
    valid[i] = s < S && valid_s[bs + s] > 0.5f;
    if (s < S) {
      const float a0 = alpha0[bs + s];
      cur[s] = a0;
      alphas[bs + s] = a0;  // t = 0 keeps alpha0 whatever frame_valid says
    }
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const bool keep = frame_valid[static_cast<size_t>(t) * B + b] > 0.5f;
    const size_t off = (static_cast<size_t>(t) * B + b) * S;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s >= S) break;
      const float a = cur[s];
      float nw = a;
      if (keep) {
        const float a1 = s >= 1 ? cur[s - 1] : LOG_EPS;
        const float a2 = skip[i] && s >= 2 ? cur[s - 2] : LOG_EPS;
        nw = valid[i] ? lse3(a, a1, a2) + emit[off + s] : LOG_EPS;
        nw = fmaxf(nw, LOG_EPS);
      }
      nxt[s] = nw;
      alphas[off + s] = nw;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// grid = B, block = threads(S), dynamic shared memory 2 * S floats.
__global__ void ctc_beta_kernel(const float* __restrict__ emit_next,
                                const float* __restrict__ skip2,
                                const float* __restrict__ fv_next,
                                const float* __restrict__ beta_init,
                                const float* __restrict__ alphas,
                                const float* __restrict__ logp,
                                float* __restrict__ demit, int T, int B,
                                int S) {
  extern __shared__ float row[];
  float* cur = row;
  float* nxt = row + S;
  const int b = blockIdx.x;
  const size_t bs = static_cast<size_t>(b) * S;
  const float lp = logp[b];
  bool skip[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    skip[i] = s < S && skip2[bs + s] > 0.5f;
    if (s < S) cur[s] = beta_init[bs + s];
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const bool keep = fv_next[static_cast<size_t>(t) * B + b] > 0.5f;
    const size_t off = (static_cast<size_t>(t) * B + b) * S;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s >= S) break;
      const float beta = cur[s];
      float nw = beta;
      if (keep) {
        const float e0 = fmaxf(beta + emit_next[off + s], LOG_EPS);
        const float e1 =
            s + 1 < S ? fmaxf(cur[s + 1] + emit_next[off + s + 1], LOG_EPS)
                      : LOG_EPS;
        const float e2 =
            skip[i] && s + 2 < S
                ? fmaxf(cur[s + 2] + emit_next[off + s + 2], LOG_EPS)
                : LOG_EPS;
        nw = lse3(e0, e1, e2);
      }
      nxt[s] = nw;
      demit[off + s] = -expf(fminf(alphas[off + s] + nw - lp, 0.0f));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

int threads_for(int S) {
  int n = (S + 31) / 32 * 32;
  if (n > MAX_THREADS) n = MAX_THREADS;
  return n < 32 ? 32 : n;
}

int prepare(const void* kernel, int S, size_t* smem) {
  *smem = 2 * sizeof(float) * static_cast<size_t>(S);
  if (S > SLOTS * MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).
int tpuasr_ctc_alpha(const float* emit, const float* allow_skip,
                     const float* valid_s, const float* frame_valid,
                     const float* alpha0, float* alphas, int T, int B, int S,
                     void* stream) {
  size_t smem = 0;
  const int err = prepare(reinterpret_cast<const void*>(ctc_alpha_kernel), S,
                          &smem);
  if (err != 0) return err;
  ctc_alpha_kernel<<<B, threads_for(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      emit, allow_skip, valid_s, frame_valid, alpha0, alphas, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

int tpuasr_ctc_beta(const float* emit_next, const float* skip2,
                    const float* fv_next, const float* beta_init,
                    const float* alphas, const float* logp, float* demit,
                    int T, int B, int S, void* stream) {
  size_t smem = 0;
  const int err = prepare(reinterpret_cast<const void*>(ctc_beta_kernel), S,
                          &smem);
  if (err != 0) return err;
  ctc_beta_kernel<<<B, threads_for(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      emit_next, skip2, fv_next, beta_init, alphas, logp, demit, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
