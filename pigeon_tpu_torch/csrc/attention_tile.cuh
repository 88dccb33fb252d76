// The WMMA attention tiles of the tuning kernels V1-V3
// (attention_bwd_tile.cuh) and V10 (online_attention_tile.cuh), kept in
// the design the attention kernels had before they moved to wgmma: 64-row
// tiles of one head staged in shared memory, WMMA 16x16x16 bf16 fragments
// with f32 accumulation. `stage_tile` stages a 64 x 64 bf16 block,
// `score_tile` takes a 64 x 64 f32 score tile Q K^T, `write_rows` writes
// an f32 tile's rows as bf16.
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

constexpr int TILE_B = TILE * LDB * 2;  // one 64-row bf16 tile: 9216 B
constexpr int TILE_F = TILE * LDF * 4;  // one 64-row f32 tile: 17408 B

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragBRow;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

// Write a 64 x 64 f32 tile's first `rows` rows as bf16 into one head's
// columns of a (B, S, P) tensor: each thread one row, 16 columns.
__device__ __forceinline__ void write_rows(bf16* dst, const float* f,
                                           int ld, int rows) {
  const int row = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 16;
  if (row < rows) {
#pragma unroll
    for (int c = 0; c < 16; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * ld + c0 + c) =
          __floats2bfloat162_rn(f[row * LDF + c0 + c],
                                f[row * LDF + c0 + c + 1]);
    }
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

}  // namespace
