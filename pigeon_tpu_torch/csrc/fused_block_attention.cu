// The attention half of a transformer block in one call, for Hopper
// (sm_90a): LayerNorm + fused QKV projection + softmax attention + output
// projection + residual.
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_block_attn_kernel
// (launcher `_fused_block_attn_forward`, reached through
// `fused_block_attention` on the `flash_fused_block` route). For x (B, S,
// D) raw (before LN1), it computes
//
//     xn  = bf16(LN_f32(x))       Flax's fast variance, f32 ln_scale/bias
//     ao  = K1(xn)                q/k/v = bf16(xn W*^T + b*), bf16 softmax
//                                 attention per head, heads concatenated
//     out = bf16(x + (ao Wo^T + bo))                     (f32 accumulate)
//
// with one rounding of the f32 sum, as `_fused_block_reference`. The TPU
// kernel also rounds each head group's attention output to bf16 before
// its out-projection (oall_ref), so nothing changes numerically; it sums
// per-group partials (FUSED_GROUPS = 4) into its f32 accumulator, where
// this kernel runs one f32 accumulator over all of D: only the summation
// order differs.
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// D=1024, H=16) K1's ~160 GFLOP plus the out-projection's 38.7 GFLOP of
// bf16 tensor-core work over ~82 MB of x, weights and out: far above the
// card's ridge, so the tensor cores bound it (0.201 ms; 0.025 at the
// serving shape, 4 views). The design is K5's stages and one more GEMM,
// four launches on the caller's stream:
//
//   1. LN1: ln_row.cuh's `layer_norm_kernel` writes xn (B, S, D) bf16 to a
//      workspace, one warp a row;
//   2. projection: q|k|v = bf16(xn [Wq; Wk; Wv]^T + b), the wgmma GEMM of
//      gemm_sm90.cuh, into three (B, S, D) workspaces, and
//   3. attention: K3's streaming forward (flash_fwd_sm90.cuh) on them into
//      the ao (B, S, D) workspace: K1's two stages (qkv_forward_sm90.cuh);
//   4. out-projection: out = bf16(x + (ao Wo^T + bo)) by the same GEMM,
//      the bias and the residual x in its f32 epilogue.
//
// The TPU kernel keeps x resident per batch element and streams the
// weights; here xn, q/k/v and ao make one round trip each through device
// memory (~190 MB at 32 views) so that each stage runs as its own grid
// over all rows and the out-projection, a reduction over all heads, needs
// no cross-block sum. The attention rounds p against K3's running max
// over 128-key chunks, not the exact row max: K5's deviation. Each
// stage's kernel carries a tag of this kernel's (K6LayerNorm,
// K6Projection, K6Attention, K6OutProjection), so a profile tells them
// from K1's and K5's.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// H * 64 = D, D a multiple of 128, any S >= 1; x, weights and biases
// bf16, ln_scale and ln_bias f32, all contiguous and 16-byte aligned; the
// workspaces xn, q/k/v and ao (B, S, D) bf16.

#include "ln_row.cuh"
#include "qkv_forward_sm90.cuh"

namespace {

// This kernel's instances of the LayerNorm, the GEMMs and the attention.
struct K6LayerNorm {};
struct K6Projection {};
struct K6Attention {};
struct K6OutProjection {};

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D) bf16 raw; ln_scale/ln_bias (D,) f32; wq/wk/wv/wo (D, D) in
// torch Linear layout and bq/bk/bv/bo (D,), bf16; out (B, S, D) bf16; the
// workspaces xn, q_ws/k_ws/v_ws and ao (B, S, D) bf16. D = heads * 64.
// Launches the four stages on `stream` and returns the first failing
// call's cudaError_t (0 on success).
int pigeon_fused_block_attention(const void* x, const void* ln_scale,
                                 const void* ln_bias, const void* wq,
                                 const void* wk, const void* wv,
                                 const void* bq, const void* bk,
                                 const void* bv, const void* wo,
                                 const void* bo, void* out, void* xn_ws,
                                 void* q_ws, void* k_ws, void* v_ws,
                                 void* ao_ws, int batch, int seq, int dim,
                                 int heads, float eps, void* stream) {
  if (heads * HD != dim || !qkv_forward_shape_ok(batch, seq, dim, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = batch * seq;

  // 1. xn = bf16(LN1(x)).
  cudaError_t err = launch_layer_norm<K6LayerNorm>(x, ln_scale, ln_bias,
                                                   xn_ws, M, dim, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2 and 3. ao = K1(xn): the projection GEMM, then K3's streaming forward.
  err = launch_qkv_attention_forward<K6Projection, K6Attention>(
      xn_ws, wq, wk, wv, bq, bk, bv, ao_ws, q_ws, k_ws, v_ws, batch, seq, dim,
      heads, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 4. out = bf16(x + (ao Wo^T + bo)).
  const bf16* const ao[1] = {static_cast<const bf16*>(ao_ws)};
  const bf16* const w[1] = {static_cast<const bf16*>(wo)};
  const bf16* const bias[1] = {static_cast<const bf16*>(bo)};
  bf16* const outs[1] = {static_cast<bf16*>(out)};
  const bf16* const residual[1] = {static_cast<const bf16*>(x)};
  return static_cast<int>(
      gemm_sm90<K6OutProjection, true, EpilogueResidualAccBias>(
          ao, w, bias, outs, M, dim, dim, dim, dim, st, residual));
}

}  // extern "C"
