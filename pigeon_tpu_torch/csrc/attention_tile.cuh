// The attention body shared by kernels K1 (fused_qkv_attention.cu), K3
// (flash_attention.cu) and K8 (fused_qkv_attention_int8.cu): one 64-row
// query tile of one head against that head's K and V, resident in shared
// memory, with the arithmetic of
// pigeon_tpu/kernels/flash_attention.py::_attn_kernel and
// _heads_attention:
//
//     s = (q k^T) * scale                              (f32)
//     p = exp(s - max(s))                              (exact row max)
//     out = bf16((bf16(p) @ v) / sum(p))               (f32 denominator)
//
// Two passes over the resident K: pass 1 takes the exact row maximum,
// pass 2 forms p, its f32 row sum and bf16(p) @ V. Matrix products are
// WMMA 16x16x16 bf16 fragments with f32 accumulation. Rows of K/V past S
// must hold finite values (they are masked out of the softmax); query
// rows past S are computed and never written.
//
// Shared-memory layout, all row strides in elements: q/k/v/p tiles bf16
// with stride LDB, the score tile f32 with stride LDF.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

typedef __nv_bfloat16 bf16;

constexpr int DH = 64;        // head dim
constexpr int TILE = 64;      // rows of a query / key / projection tile
constexpr int LDB = 72;       // bf16 row stride in shared memory (+8 pad)
constexpr int LDF = 68;       // f32 row stride in shared memory (+4 pad)
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_SMEM = 232448;  // per-block dynamic shared memory, sm_90

constexpr int TILE_B = TILE * LDB * 2;  // one 64-row bf16 tile: 9216 B
constexpr int TILE_F = TILE * LDF * 4;  // one 64-row f32 tile: 17408 B
// The work area attend_tile needs after the resident K/V: the Q tile
// (bf16), the score tile S (f32) and the probability tile P (bf16).
constexpr int ATTN_WORK_BYTES = TILE_B + TILE_F + TILE_B;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragBRow;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared memory of a block that keeps one head's K and V resident for
// s_pad rows and has `work` bytes of work area after them.
__host__ __device__ constexpr int resident_smem_bytes(int s_pad, int work) {
  return 2 * s_pad * LDB * 2 + work;
}

// Longest sequence (a multiple of TILE) whose resident K/V and `work`
// bytes fit one block's shared memory.
inline int resident_max_seq(int work) {
  int s_pad = TILE;
  while (resident_smem_bytes(s_pad + TILE, work) <= MAX_SMEM) s_pad += TILE;
  return s_pad;
}

// Copy a 64 x 64 bf16 block (global row stride `ld`) into shared memory,
// zero-filling rows at or past `rows`.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int ld, int rows) {
  constexpr int VEC = 64 / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < TILE * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = v;
  }
}

// scores (64 x 64, f32, row stride LDF) = Q tile @ K[k0:k0+64]^T; each warp
// computes two 16 x 16 fragments of the 4 x 4 grid.
__device__ __forceinline__ void score_tile(float* sf, const bf16* qs,
                                           const bf16* ks, int rf, int cf) {
  FragC acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, qs + rf * 16 * LDB + kk, LDB);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBCol b;
      wmma::load_matrix_sync(b, ks + (cf + j) * 16 * LDB + kk, LDB);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(sf + rf * 16 * LDF + (cf + j) * 16, acc[j], LDF,
                            wmma::mem_row_major);
  }
}

// The query tile in `qs` (its staging complete and synchronised) against
// the resident `ks`/`vs` of S rows: writes rows [0, rows) of the
// normalised output, 64 bf16 each, to out + r * ld_out. `sf` and `ps` are
// the S and P tiles of the work area. Ends with a barrier, so the caller
// may restage `qs`, `sf` and `ps` right after.
__device__ __forceinline__ void attend_tile(const bf16* qs, const bf16* ks,
                                            const bf16* vs, float* sf,
                                            bf16* ps, int S, float scale,
                                            bf16* out, int ld_out,
                                            int rows) {
  const int n_tiles = (S + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;        // 16-row strip
  const int cf = (warp % 2) * 2;  // first of two 16-column fragments
  const int row = threadIdx.x / 4;  // softmax: 4 lanes per row ...
  const int c0 = (threadIdx.x % 4) * 16;  // ... 16 columns each

  // Pass 1: the exact row maximum over all S keys.
  float m = -INFINITY;
  for (int kt = 0; kt < n_tiles; ++kt) {
    score_tile(sf, qs, ks + kt * TILE * LDB, rf, cf);
    __syncthreads();
    const int kv = min(TILE, S - kt * TILE);
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      if (c < kv) m = fmaxf(m, sf[row * LDF + c] * scale);
    }
    __syncthreads();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));

  // Pass 2: p = exp(s - m); the f32 row sum, and bf16(p) @ V.
  float l = 0.0f;
  FragC acc_o[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_o[j], 0.0f);
  for (int kt = 0; kt < n_tiles; ++kt) {
    score_tile(sf, qs, ks + kt * TILE * LDB, rf, cf);
    __syncthreads();
    const int kv = min(TILE, S - kt * TILE);
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      const float p = c < kv ? expf(sf[row * LDF + c] * scale - m) : 0.0f;
      l += p;
      ps[row * LDB + c] = __float2bfloat16(p);
    }
    __syncthreads();
    const bf16* vt = vs + kt * TILE * LDB;
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, ps + rf * 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBRow bm;
        wmma::load_matrix_sync(bm, vt + kk * LDB + (cf + j) * 16, LDB);
        wmma::mma_sync(acc_o[j], a, bm, acc_o[j]);
      }
    }
    // No barrier needed here: the next score_tile writes `sf`, which
    // nobody reads now, and `ps` is rewritten only after its barrier.
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // Normalise and write this head's 64 columns of the output rows.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(sf + rf * 16 * LDF + (cf + j) * 16, acc_o[j],
                            LDF, wmma::mem_row_major);
  }
  __syncthreads();
  if (row < rows) {
    const float inv = 1.0f / l;
    bf16* dst = out + (size_t)row * ld_out + c0;
#pragma unroll
    for (int c = 0; c < 16; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
          sf[row * LDF + c0 + c] * inv, sf[row * LDF + c0 + c + 1] * inv);
    }
  }
  __syncthreads();
}

}  // namespace
