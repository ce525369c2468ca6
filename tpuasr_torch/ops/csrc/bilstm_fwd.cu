// Fused bidirectional LSTM time loop, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuasr/ops/lstm.py:_fwd_kernel (launched by
// _bilstm_fwd at lstm.py:179) and computes exactly what it computes, for
// every direction d, row b and unit j:
//   hg  = h_{t-1} @ w_h[d] + b_h[d]          (products and sum in f32)
//   i = sigmoid(xi + hi), f = sigmoid(xf + hf), g = tanh(xg + hg_g),
//   o = sigmoid(xo + ho)                     (gate order [i, f, g, o])
//   c'  = f c_{t-1} + i g,  h' = o tanh(c')
//   h_t = round_to_T(m h' + (1 - m) h_{t-1}),  c_t = m c' + (1 - m) c_{t-1}
//   ys_t = h_t,  cs_t = round_to_T(c_t)
// The two carries differ, as in the TPU kernel: h is carried rounded to
// xg's dtype (its scratch is xg.dtype), while c is carried in f32 (its
// scratch is f32). cs, the backward's input, is the rounded copy.
//
// Layouts (all contiguous): xg (T, D, B, 4H), w_h (D, H, 4H), b_h (D, 4H)
// f32, mask (T, D, B) f32 -> ys, cs (T, D, B, H). D in {1, 2}, any T, B,
// H. T is float or __nv_bfloat16.
//
// Bound. Per step D (B x H) @ (H x 4H) products: at T=251, B=32, H=800,
// D=2 82.3 GFLOP, 83 us on the bf16 tensor cores, against 165 MB of
// xg/ys/cs/w_h/mask traffic (49 us at 3.35 TB/s): operations bound it.
// As in K1f, the loop is strictly sequential and a step is far too small
// to fill the card.
//
// Design. K1f's persistent loop (rnn_fwd.cuh) with four gates: a block
// pins its 4 x 16 columns of w_h (102.4 KB at H=800 bf16) and keeps the
// f32 c of its units in shared memory for the whole call; the thread
// that owns (row, unit) updates it in place, since the c update is
// elementwise.

#include "rnn_fwd.cuh"

extern "C" {

// As tpuasr_bigru_fwd, plus cs (T, D, B, H) in xg's dtype.
int tpuasr_bilstm_fwd(const void* xg, const void* w_h, const float* b_h, const float* mask,
                      void* ys, void* cs, unsigned int* bar, long long* timer,
                      const int* layout, int T_len, int D, int B, int H, int dtype,
                      void* stream) {
  using namespace tpuasr_rnn;
  const size_t h = H;
  return fwd_loop<4>(xg, GateStrides{B * 4 * h, 4 * h, h}, w_h, WLayout{4 * H, H}, b_h, mask,
                     ys, cs, bar, timer, layout, T_len, D, B, H, dtype,
                     static_cast<cudaStream_t>(stream));
}

int tpuasr_rnn_device_limits(int* n_sms, int* smem_optin) {
  return tpuasr_rnn::device_limits(n_sms, smem_optin);
}

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
