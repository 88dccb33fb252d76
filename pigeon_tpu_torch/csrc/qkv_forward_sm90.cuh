// K1's two stages, which K1 (fused_qkv_attention.cu) runs on x, K5
// (fused_ln_qkv_attention.cu) and K6 (fused_block_attention.cu) on their
// LayerNorm's xn, and the int8 routes' K8 (fused_qkv_attention_int8.cu)
// and K7 (fused_block_attention_int8.cu) on int8 x, each under tags of
// their own so that a profile tells them apart:
//
//   1. projection: q|k|v = bf16(epilogue(x [Wq; Wk; Wv]^T)) into three
//      (B, S, P) workspaces by gemm_sm90.cuh's persistent wgmma GEMM
//      (N = 3P in three segments, one rounding): bf16 operands with the
//      bias (EpilogueBias), or int8 operands with the per-channel dequant
//      scale and the bias (EpilogueDequantBias);
//   2. attention: K3's streaming forward (flash_fwd_sm90.cuh) on them,
//      whose (B, S, P) layout is K3's (B, S, H, 64), writing out in bf16
//      or, for K7, requantized to int8 (AttnOutQuantized).

#pragma once

#include "gemm_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

// The shapes both stages take: head_dim 64, D and P = heads * 64 multiples
// of the GEMM's 128-wide tiles, any S >= 1.
inline bool qkv_forward_shape_ok(int batch, int seq, int dim, int heads) {
  return batch >= 1 && seq >= 1 && heads >= 1 && dim % 128 == 0 &&
         (heads * HD) % 128 == 0;
}

// x (B, S, D) and wq/wk/wv (P, D) in torch Linear layout, of the
// projection policy's operand type; bq/bk/bv (P,) of its Bias type; for
// the int8 policy `scales` the three (P,) f32 dequant scales; the
// workspaces q_ws/k_ws/v_ws (B, S, P) bf16; out (B, S, P) of the attention
// policy's type, `out_scale` its device scale where it needs one.
// Launches the two stages on `stream` and returns the first failing
// call's error.
template <class ProjectionTag, class AttentionTag,
          class Projection = EpilogueBias, class Attention = AttnOutBf16>
inline cudaError_t launch_qkv_attention_forward(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* bq, const void* bk, const void* bv, void* out, void* q_ws,
    void* k_ws, void* v_ws, int batch, int seq, int dim, int heads,
    cudaStream_t stream, const float* const* scales = nullptr,
    const float* out_scale = nullptr) {
  typedef GemmIn<Projection> T;
  typedef GemmBias<Projection> Bias;
  if (!qkv_forward_shape_ok(batch, seq, dim, heads)) {
    return cudaErrorInvalidValue;
  }
  const int P = heads * HD;
  const T* const xs[1] = {static_cast<const T*>(x)};
  const T* const w[3] = {static_cast<const T*>(wq), static_cast<const T*>(wk),
                         static_cast<const T*>(wv)};
  const Bias* const bias[3] = {static_cast<const Bias*>(bq),
                               static_cast<const Bias*>(bk),
                               static_cast<const Bias*>(bv)};
  bf16* const qkv[3] = {static_cast<bf16*>(q_ws), static_cast<bf16*>(k_ws),
                        static_cast<bf16*>(v_ws)};
  const cudaError_t err = gemm_sm90<ProjectionTag, true, Projection>(
      xs, w, bias, qkv, batch * seq, 3 * P, dim, dim, P, stream, nullptr,
      scales);
  if (err != cudaSuccess) return err;
  return launch_flash_forward<AttentionTag, Attention>(
      q_ws, k_ws, v_ws, out, batch, seq, heads, stream, out_scale);
}

}  // namespace
