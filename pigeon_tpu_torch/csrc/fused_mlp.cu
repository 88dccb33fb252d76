// LayerNorm + quick-GELU MLP + residual forward, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/fused_mlp.py::_fused_ln_mlp_kernel (launcher
// `_fused_ln_mlp_forward`, reached through `fused_ln_mlp` on the
// `flash_fused_mlp` and `flash_fused_block` routes: the MLP half of every
// CLIP encoder layer). For x (M = B*S rows, D), the Linear-layout weights
// W1 (I, D) and W2 (D, I) and biases b1 (I,), b2 (D,), it computes, at
// the TPU kernel's rounding points (fused_mlp.py:67-96):
//
//     xn  = bf16(LN_f32(x))       Flax's fast variance, f32 ln_scale/bias
//     h   = bf16(quick_gelu_f32(xn W1^T + b1))           (f32 accumulate)
//     out = bf16(x + b2 + h W2^T)                        (f32 accumulate)
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// D=1024, I=4096) the two products are ~310 GFLOP of bf16 tensor-core
// work over ~92 MB of x, weights and out: ~3,400 FLOP per byte, far above
// the card's ~295, so the tensor cores bound it (~0.31 ms). The design is
// three launches on the caller's stream, the two products on the card's
// own paths (TMA, wgmma):
//
//   1. LN2: ln_row.cuh's `layer_norm_kernel` writes xn (M, D) bf16 to a
//      workspace, one warp a row (K5's LN1, under this kernel's tag);
//   2. fc1: h = bf16(quick_gelu(xn W1^T + b1)) into an (M, I) bf16
//      workspace by gemm_sm90.cuh's persistent wgmma GEMM, the bias and
//      quick-GELU in its f32 epilogue;
//   3. fc2: out = bf16((x + b2) + h W2^T) by the same GEMM over h, K = I
//      in one segment, the bias and the residual x in its f32 epilogue.
//
// The TPU kernel keeps h in VMEM by sweeping I in chunks into an f32
// accumulator; here h makes one round trip through device memory (151 MB
// at the training shape, ~0.09 ms at 3.35 TB/s) and xn another (38 MB).
// Keeping h on chip (fc2's partial sums over I chunks beside fc1's tile)
// is later work, worth it only if the two GEMMs alone do not come near
// the bound. Each stage's kernel carries a tag of this kernel's
// (K9LayerNorm, K9Fc1, K9Fc2), so a profile tells them apart.
//
// Constraints (checked by the Python wrapper): D and I multiples of 128;
// x, weights, biases and out bf16, ln_scale and ln_bias f32, all
// contiguous and 16-byte aligned; the workspaces xn (M, D) and h (M, I)
// bf16. Rows past M are read as zeros and never written.

#include "gemm_sm90.cuh"
#include "ln_row.cuh"

namespace {

// This kernel's instances of the LayerNorm and the two GEMMs.
struct K9LayerNorm {};
struct K9Fc1 {};
struct K9Fc2 {};

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, D) bf16; ln_scale/ln_bias (D,) f32; w1 (I, D), b1 (I,), w2 (D, I),
// b2 (D,) bf16; workspaces xn (M, D) and h (M, I) bf16; out (M, D) bf16.
// Launches the three stages on `stream` and returns the first failing
// call's cudaError_t (0 on success).
int pigeon_fused_ln_mlp(const void* x, const void* ln_scale,
                        const void* ln_bias, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* xn_ws,
                        void* h_ws, void* out, int rows, int dim, int inter,
                        float eps, void* stream) {
  if (rows < 1 || dim < 128 || dim % 128 || inter < 128 || inter % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  // 1. xn = bf16(LN2(x)).
  cudaError_t err = launch_layer_norm<K9LayerNorm>(x, ln_scale, ln_bias,
                                                   xn_ws, rows, dim, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. h = bf16(quick_gelu(xn W1^T + b1)).
  const bf16* const xn[1] = {static_cast<const bf16*>(xn_ws)};
  const bf16* const fc1_w[1] = {static_cast<const bf16*>(w1)};
  const bf16* const fc1_b[1] = {static_cast<const bf16*>(b1)};
  bf16* const h[1] = {static_cast<bf16*>(h_ws)};
  err = gemm_sm90<K9Fc1, true, EpilogueBiasQuickGelu>(
      xn, fc1_w, fc1_b, h, rows, inter, dim, dim, inter, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. out = bf16((x + b2) + h W2^T).
  const bf16* const hs[1] = {static_cast<const bf16*>(h_ws)};
  const bf16* const fc2_w[1] = {static_cast<const bf16*>(w2)};
  const bf16* const fc2_b[1] = {static_cast<const bf16*>(b2)};
  bf16* const outs[1] = {static_cast<bf16*>(out)};
  const bf16* const residual[1] = {static_cast<const bf16*>(x)};
  return static_cast<int>(gemm_sm90<K9Fc2, true, EpilogueResidualBiasAcc>(
      hs, fc2_w, fc2_b, outs, rows, dim, inter, inter, dim, st, residual));
}

}  // extern "C"
