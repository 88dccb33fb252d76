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
// What bounds it on the H100: at the serving shape (B=4 views, S=577,
// D=1024, H=16) K1's ~20 GFLOP plus the out-projection's 4.8 GFLOP of
// bf16 tensor-core work over ~19 MB of x, weights and out: far above the
// card's ridge, so the tensor cores bound it (~0.025 ms). The design is
// two launches behind one entry point:
//
//   1. the LN-folded block (ln_qkv_attention_tile.cuh: `ln_row_stats`, then
//      `fused_qkv_attention_block` staging x through `stage_ln_tile`), one
//      block per (head, batch), writing the bf16 attention output to an
//      (M = B*S, D) workspace (4.7 MB at the serving shape);
//   2. the tiled GEMM of gemm_tile.cuh (K9's fc2: 128 x 128 tiles, A and
//      Wo tiles double-buffered by cp.async) with an f32 epilogue adding bo
//      and the residual x, rounded once to bf16.
//
// The TPU kernel keeps x resident per batch element and streams the
// weights; here the attention output makes one round trip through device
// memory (L2 at these sizes) so that the out-projection, a reduction over
// all heads, runs as its own grid. Keeping it on chip (a cluster of a
// batch's head blocks, distributed shared memory) is later work.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// H * 64 = D, D a multiple of 128, S <= pigeon_fused_block_attention_max_seq();
// x, weights and biases bf16, ln_scale and ln_bias f32, all contiguous and
// 16-byte aligned.

#include "gemm_tile.cuh"
#include "ln_qkv_attention_tile.cuh"

namespace {

// out[m, n] = bf16(x[m, n] + (sum_k ao[m, k] wo[n, k] + bo[n])), f32.
__global__ void __launch_bounds__(gemm::THREADS)
out_proj_kernel(const bf16* __restrict__ ao, const bf16* __restrict__ wo,
                const bf16* __restrict__ bo, const bf16* __restrict__ x,
                bf16* __restrict__ out, int M, int D) {
  __shared__ __align__(128) unsigned char smem[gemm::SMEM_BYTES];
  const int m0 = blockIdx.x * gemm::BM;
  const int n0 = blockIdx.y * gemm::BN;
  gemm::FragC acc[2][4];
  gemm::mma_bf16(
      smem,
      [&](bf16* as, int k0) { gemm::copy_a_bf16(as, ao, M, D, m0, k0); },
      wo, D, n0, acc);
  gemm::epilogue<float>(smem, acc, [&](int r, int c, const float* p) {
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M) return;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * D + n);
    const bf16* xe = reinterpret_cast<const bf16*>(&raw);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = __bfloat162float(xe[e]) +
             (p[e] + __bfloat162float(bo[n + e]));
    }
    gemm::store8_bf16(out + (size_t)m * D + n, v);
  });
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V and row statistics fit one block's
// shared memory (the LN-folded block's).
int pigeon_fused_block_attention_max_seq() {
  return ln_qkv_attention_max_seq();
}

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D) bf16 raw; ln_scale/ln_bias (D,) f32; wq/wk/wv/wo (D, D) in
// torch Linear layout and bq/bk/bv/bo (D,), bf16; workspace ao (B, S, D)
// bf16; out (B, S, D) bf16. All contiguous. Launches both passes on
// `stream` and returns the first failing launch's cudaError_t (0 on
// success).
int pigeon_fused_block_attention(const void* x, const void* ln_scale,
                                 const void* ln_bias, const void* wq,
                                 const void* wk, const void* wv,
                                 const void* bq, const void* bk,
                                 const void* bv, const void* wo,
                                 const void* bo, void* ao, void* out,
                                 int batch, int seq, int dim, int heads,
                                 float eps, void* stream) {
  if (heads * DH != dim || dim % gemm::BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_qkv_attention(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
      static_cast<const bf16*>(bv), static_cast<bf16*>(ao), batch, seq, dim,
      heads, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * seq;
  out_proj_kernel<<<dim3((rows + gemm::BM - 1) / gemm::BM, dim / gemm::BN),
                    gemm::THREADS, 0, st>>>(
      static_cast<const bf16*>(ao), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), rows, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
