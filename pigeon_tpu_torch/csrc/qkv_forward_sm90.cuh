// K1's two stages, which K1 (fused_qkv_attention.cu) runs on x and K5
// (fused_ln_qkv_attention.cu) on its LayerNorm's xn, each under tags of its
// own so that a profile tells the two apart:
//
//   1. projection: q|k|v = bf16(x [Wq; Wk; Wv]^T + b) into three (B, S, P)
//      workspaces by gemm_sm90.cuh's persistent wgmma GEMM (N = 3P in three
//      segments, f32 sums and bias, one rounding);
//   2. attention: K3's streaming forward (flash_fwd_sm90.cuh) on them,
//      whose (B, S, P) layout is K3's (B, S, H, 64).

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

// x (B, S, D); wq/wk/wv (P, D) in torch Linear layout; bq/bk/bv (P,); out
// and the workspaces q_ws/k_ws/v_ws (B, S, P); all bf16. Launches the two
// stages on `stream` and returns the first failing call's error.
template <class ProjectionTag, class AttentionTag>
inline cudaError_t launch_qkv_attention_forward(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* bq, const void* bk, const void* bv, void* out, void* q_ws,
    void* k_ws, void* v_ws, int batch, int seq, int dim, int heads,
    cudaStream_t stream) {
  if (!qkv_forward_shape_ok(batch, seq, dim, heads)) {
    return cudaErrorInvalidValue;
  }
  const int P = heads * HD;
  const bf16* const xs[1] = {static_cast<const bf16*>(x)};
  const bf16* const w[3] = {static_cast<const bf16*>(wq),
                            static_cast<const bf16*>(wk),
                            static_cast<const bf16*>(wv)};
  const bf16* const bias[3] = {static_cast<const bf16*>(bq),
                               static_cast<const bf16*>(bk),
                               static_cast<const bf16*>(bv)};
  bf16* const qkv[3] = {static_cast<bf16*>(q_ws), static_cast<bf16*>(k_ws),
                        static_cast<bf16*>(v_ws)};
  const cudaError_t err = gemm_sm90<ProjectionTag, true>(
      xs, w, bias, qkv, batch * seq, 3 * P, dim, dim, P, stream);
  if (err != cudaSuccess) return err;
  return launch_flash_forward<AttentionTag>(q_ws, k_ws, v_ws, out, batch,
                                            seq, heads, stream);
}

}  // namespace
