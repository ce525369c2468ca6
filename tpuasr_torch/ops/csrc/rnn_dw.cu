// The recurrent weight gradients of every bf16 RNN backward (K1b, K4b,
// K5b and K6b): dw_gemm_bf16 of rnn_bwd.cuh, in a library of its own, so
// that the caller (ops.gru.rnn_weight_grads) needs no backward's name.
//
// dw[d][k, q*H + j] = sum over steps t and rows b of h_{t-1}[t, d, b, k]
// g_q[t, d, b, j], and db[d][q*H + j] = sum of g_q, where g_q is gate
// gate[q] of the emitted gate gradients; both operands bf16, read in
// place; dw and db f32. No atomics: the same bits on every call.

#include "rnn_bwd.cuh"

extern "C" {

// dims (int64): T, D, B, H, G, shift, blocks, per (k-steps a block), the
// strides ht, hd, hb, gt, gd, gb, gq, wd, wk, wg (DwArgs), and the four
// entries of the gate map (rnn_plan.rnn_dw_plan gives blocks and per).
// part: (blocks, 2, 128 * 128) f32 scratch; arrive: (tiles) int32, zeroed.
// Returns cudaGetLastError() after the launch.
int tpuasr_rnn_dw(const void* h, const void* g, float* dw, float* db, float* part,
                  unsigned int* arrive, const long long* dims, void* stream) {
  using namespace tpuasr_rnn;
  DwArgs a{static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(g), dw, db,
           part, arrive};
  const long long* v = dims;
  a.T = v[0], a.D = v[1], a.B = v[2], a.H = v[3], a.G = v[4], a.shift = v[5], a.per = v[7];
  a.ht = v[8], a.hd = v[9], a.hb = v[10], a.gt = v[11], a.gd = v[12], a.gb = v[13];
  a.gq = v[14], a.wd = v[15], a.wk = v[16], a.wg = v[17];
  for (int q = 0; q < 4; ++q) a.gate[q] = v[18 + q];
  return dw_gemm(a, static_cast<int>(v[6]), static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
