// The block that kernel K6 (fused_block_attention.cu) launches first: LN1
// folded into the fused QKV projection + attention of one (head, batch)
// block. A prologue takes each row's statistics into shared memory and
// each streamed x tile is normalised as it is staged, in Flax's
// fast-variance LayerNorm and its association order (ln_row.cuh, whose
// arithmetic K5's LayerNorm kernel and K9 share).

#pragma once

#include "attention_tile.cuh"
#include "ln_row.cuh"

namespace {

// ---------------------------------------------------------------------
// LN1 folded into the block's staging (K6): Flax's fast-variance
// LayerNorm in its association order (flash_attention.py::_layer_norm_f32).
// ---------------------------------------------------------------------

// Each row's mean and rsqrt(max(E[x^2] - E[x]^2, 0) + eps) over D in f32,
// rows [0, S) of xb (row stride D), one warp a row, into mu[] and rs[];
// ends with a barrier.
__device__ __forceinline__ void ln_row_stats(const bf16* __restrict__ xb,
                                             int S, int D, float eps,
                                             float* mu, float* rs) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < S; r += THREADS / 32) {
    const LnStats stats = ln_warp_stats(xb + (size_t)r * D, D, eps);
    if (lane == 0) {
      mu[r] = stats.mean;
      rs[r] = stats.rs;
    }
  }
  __syncthreads();
}

// Stage x[0:64, 0:64] (global row stride `ld`) normalised: row r gets
// (x - mu[r]) * (rs[r] * ls[c]) + lb[c] in f32, rounded to bf16; rows at
// or past `rows` are zeros.
__device__ __forceinline__ void stage_ln_tile(bf16* dst, const bf16* src,
                                              int ld, int rows,
                                              const float* mu,
                                              const float* rs,
                                              const float* ls,
                                              const float* lb) {
  constexpr int VEC = 64 / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < TILE * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      packed = ln_normalise8(
          *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c), mu[r],
          rs[r], ls + c, lb + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = packed;
  }
}

// Shared memory: K1's resident K/V and work area, then the row statistics.
__host__ __device__ constexpr int ln_qkv_smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, QKV_WORK_BYTES) + 2 * s_pad * 4;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ln_qkv_attention_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const bf16* __restrict__ wq,
                              const bf16* __restrict__ wk,
                              const bf16* __restrict__ wv,
                              const bf16* __restrict__ bq,
                              const bf16* __restrict__ bk,
                              const bf16* __restrict__ bv,
                              bf16* __restrict__ out, int S, int D, int H,
                              float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_pad = ((S + TILE - 1) / TILE) * TILE;
  float* mu = reinterpret_cast<float*>(
      smem + resident_smem_bytes(s_pad, QKV_WORK_BYTES));
  float* rs = mu + s_pad;
  const bf16* xb = x + (size_t)blockIdx.y * S * D;

  ln_row_stats(xb, S, D, eps, mu, rs);

  fused_qkv_attention_block(
      smem,
      [&](bf16* dst, int r0, int d0, int rows) {
        stage_ln_tile(dst, xb + (size_t)r0 * D + d0, D, rows, mu + r0,
                      rs + r0, ln_scale + d0, ln_bias + d0);
      },
      wq, wk, wv, bq, bk, bv, out, S, D, H, scale);
}

// Longest sequence whose resident K/V and row statistics fit one block's
// shared memory.
inline int ln_qkv_attention_max_seq() {
  int s_pad = TILE;
  while (ln_qkv_smem_bytes(s_pad + TILE) <= MAX_SMEM) s_pad += TILE;
  return s_pad;
}

// Launch the block on `stream`: x (B, S, D) raw, out (B, S, H*64).
inline cudaError_t launch_ln_qkv_attention(
    const bf16* x, const float* ln_scale, const float* ln_bias,
    const bf16* wq, const bf16* wk, const bf16* wv, const bf16* bq,
    const bf16* bk, const bf16* bv, bf16* out, int batch, int seq, int dim,
    int heads, float eps, cudaStream_t stream) {
  const int s_pad = ((seq + TILE - 1) / TILE) * TILE;
  const int smem = ln_qkv_smem_bytes(s_pad);
  if (batch < 1 || seq < 1 || heads < 1 || dim % QKV_KC != 0 ||
      smem > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_ln_qkv_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_ln_qkv_attention_kernel<<<dim3(heads, batch), THREADS, smem,
                                  stream>>>(
      x, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, out, seq, dim, heads,
      1.0f / sqrtf(static_cast<float>(DH)), eps);
  return cudaGetLastError();
}

}  // namespace
