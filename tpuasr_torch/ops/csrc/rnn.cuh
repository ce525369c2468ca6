// Device code shared by the fused bidirectional RNN time loops for NVIDIA
// Hopper (sm_90a): the BiGRU (K1 in the [k, g*H + j] layout, K5 in the
// gate-major layout) and the BiLSTM (K4). The forward loop is in
// rnn_fwd.cuh, the backward in rnn_bwd.cuh; both are persistent,
// cooperative launches, and this header holds what they share: the
// weight and gate layouts, the bf16 tensor-core product (mma.sync), the
// grid barrier and the cooperative launch with its co-residency check.
//
// The weight layout is a pair of strides (WLayout): element (k, g, j) of
// w_h[d] lies at k * wk + g * wg + j. The input projections and the packed
// gradients of the GRU are addressed the same way (GateStrides), so K1 and
// K5 run one compiled body and agree bit for bit on the same weights.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tpuasr_rnn {

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

// w_h[d] at row k, flat column c = g*H + j, zero past H rows and NG*H
// columns.
template <typename T>
__device__ __forceinline__ T w_at(const T* w_d, WLayout wl, int k, int c, int H, int G) {
  if (k >= H || c >= G) return from_f32<T>(0.0f);
  const int g = c / H;
  return w_d[static_cast<size_t>(k) * wl.wk + static_cast<size_t>(g) * wl.wg + (c - g * H)];
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo, v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------- persistent launches

// Every block at the barrier of step i (0, 1, ...) before any goes on.
// The counter only grows: the target of step i is (i + 1) * gridDim.x.
// Writes before it (to global memory) are visible after it to loads
// that bypass L1 (ld.global.cg, cp.async.cg): L1 is not coherent across
// SMs.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(bar), "r"(1u)
                 : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// One cooperative launch of n_blocks x threads, after a check that the
// grid is co-resident on this card (so that grid_barrier cannot hang):
// cudaErrorCooperativeLaunchTooLarge when it is not, never a hang and
// never a fallback. params as for cudaLaunchCooperativeKernel.
template <typename K>
int launch_cooperative(K kernel, int n_blocks, int threads, size_t smem, void** params,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sms < n_blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(n_blocks), dim3(threads), params,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The card's SM count and opt-in shared memory per block.
inline int device_limits(int* n_sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

}  // namespace tpuasr_rnn
