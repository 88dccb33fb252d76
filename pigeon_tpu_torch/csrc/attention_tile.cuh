// The WMMA attention body shared by kernels K7
// (fused_block_attention_int8.cu), K8 (fused_qkv_attention_int8.cu)
// and the tuning kernels V1-V3 and V10: one 64-row query tile of one head
// against that head's K and V, resident in shared memory, with the
// arithmetic of
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
//
// Below it, `fused_qkv_attention_int8_block`: the whole (head, batch)
// block of K8 and K7, q/k/v projected from int8 x in-kernel.

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

// ---------------------------------------------------------------------
// The int8 q/k/v projection + attention of one (head, batch) block,
// shared by K8 (fused_qkv_attention_int8.cu) and K7
// (fused_block_attention_int8.cu); K8's source note says how it works.
// ---------------------------------------------------------------------

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major>
    FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major>
    FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC8;

constexpr int KC8 = 64;    // D columns (bytes) staged per step
constexpr int SUB8 = 16;   // bytes per row of one sub-tile (one k step)
constexpr int TILE_I8 = TILE * KC8;  // one staged 64 x 64 int8 tile: 4 KB
// Work area after the resident K/V: Q (bf16) + S (f32) + P (bf16) for the
// attention. Phase 1 stages three int8 tiles, then holds two int32
// accumulator tiles; phase 2 stages two int8 tiles in the S/P area and
// its int32 accumulator tile overlays S.
constexpr int INT8_WORK_BYTES = ATTN_WORK_BYTES;
static_assert(3 * TILE_I8 <= INT8_WORK_BYTES, "phase-1 staging overflows");
static_assert(2 * TILE_F <= INT8_WORK_BYTES, "phase-1 epilogue overflows");
static_assert(2 * TILE_I8 <= TILE_F + TILE_B, "phase-2 staging overflows");
static_assert(THREADS == TILE * (KC8 / SUB8), "one 16-byte vector a thread");

// Copy a 64 x 64 int8 block (global row stride `ld` bytes) into shared
// memory as four [64][16] sub-tiles, zero-filling rows at or past `rows`.
__device__ __forceinline__ void stage_tile_i8(int8_t* dst, const int8_t* src,
                                              int ld, int rows) {
  const int r = threadIdx.x / (KC8 / SUB8);
  const int v = threadIdx.x % (KC8 / SUB8);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (r < rows) {
    val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + v * SUB8);
  }
  *reinterpret_cast<uint4*>(dst + v * TILE * SUB8 + r * SUB8) = val;
}

// f32(acc) * fs + b with two roundings, in the JAX kernel's order.
__device__ __forceinline__ bf16 dequant(int acc, float fs, float b) {
  return __float2bfloat16(__fadd_rn(__fmul_rn(__int2float_rn(acc), fs), b));
}

// Block (h = blockIdx.x, b = blockIdx.y): this head's K and V for all S
// rows projected into the resident area at the start of `smem` (phase 1),
// then each 64-row query tile projected and attended (phase 2). xb is
// batch b's int8 x (S, D); W* int8 (P, D); fs* the f32 dequant scales
// with the activation scale folded in; b* f32. Writes out[b, :,
// h*64:(h+1)*64] (bf16, row stride P).
__device__ __forceinline__ void fused_qkv_attention_int8_block(
    unsigned char* smem, const int8_t* __restrict__ xb,
    const int8_t* __restrict__ wq, const int8_t* __restrict__ wk,
    const int8_t* __restrict__ wv, const float* __restrict__ fsq,
    const float* __restrict__ fsk, const float* __restrict__ fsv,
    const float* __restrict__ bq, const float* __restrict__ bk,
    const float* __restrict__ bv, bf16* __restrict__ out, int S, int D,
    int H, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int P = H * DH;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int s_pad = n_tiles * TILE;
  const int warp = threadIdx.x / 32;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + s_pad * LDB;
  unsigned char* work = smem + 2 * s_pad * LDB * 2;

  // Linear layout (P, D): head h owns the contiguous rows h*64 .. h*64+63.
  const int8_t* wq_h = wq + (size_t)h * DH * D;
  const int8_t* wk_h = wk + (size_t)h * DH * D;
  const int8_t* wv_h = wv + (size_t)h * DH * D;
  const int c_h = h * DH;  // this head's first channel

  // ---- Phase 1: K and V of this head for all S rows, kept resident. ----
  {
    int8_t* xs = reinterpret_cast<int8_t*>(work);
    int8_t* wks = xs + TILE_I8;
    int8_t* wvs = wks + TILE_I8;
    int* ik = reinterpret_cast<int*>(work);
    int* iv = ik + TILE * LDF;
    const int mat = warp / 4;  // warps 0-3 project K, 4-7 project V
    const int rf = warp % 4;   // this warp's 16-row strip
    const int8_t* ws = mat ? wvs : wks;
    int* acc_tile = mat ? iv : ik;

    for (int t = 0; t < n_tiles; ++t) {
      const int r0 = t * TILE;
      const int rows = min(TILE, S - r0);
      FragC8 acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0);
      for (int d0 = 0; d0 < D; d0 += KC8) {
        stage_tile_i8(xs, xb + (size_t)r0 * D + d0, D, rows);
        stage_tile_i8(wks, wk_h + d0, D, TILE);
        stage_tile_i8(wvs, wv_h + d0, D, TILE);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC8 / SUB8; ++kk) {
          FragA8 a;
          wmma::load_matrix_sync(a, xs + kk * TILE * SUB8 + rf * 16 * SUB8,
                                 SUB8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB8 bm;
            wmma::load_matrix_sync(bm, ws + kk * TILE * SUB8 + j * 16 * SUB8,
                                   SUB8);
            wmma::mma_sync(acc[j], a, bm, acc[j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(acc_tile + rf * 16 * LDF + j * 16, acc[j],
                                LDF, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * TILE * DH; i += THREADS) {
        const int m = i / (TILE * DH);
        const int r = (i % (TILE * DH)) / DH;
        const int c = i % DH;
        (m ? vs : ks)[(r0 + r) * LDB + c] =
            dequant((m ? iv : ik)[r * LDF + c], (m ? fsv : fsk)[c_h + c],
                    (m ? bv : bk)[c_h + c]);
      }
      __syncthreads();
    }
  }

  // ---- Phase 2: query tiles against the resident K/V. ----
  {
    bf16* qs = reinterpret_cast<bf16*>(work);
    float* sf = reinterpret_cast<float*>(work + TILE_B);
    bf16* ps = reinterpret_cast<bf16*>(work + TILE_B + TILE_F);
    // Q-projection staging and its accumulator reuse the S/P area (free
    // until scoring).
    int8_t* xs = reinterpret_cast<int8_t*>(work + TILE_B);
    int8_t* wqs = xs + TILE_I8;
    int* iq = reinterpret_cast<int*>(work + TILE_B);
    const int rf = warp / 2;        // 16-row strip
    const int cf = (warp % 2) * 2;  // first of two 16-column fragments

    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = t * TILE;
      const int rows = min(TILE, S - q0);

      // Q tile = bf16(f32(x_q[q0:q0+64] @ Wq_h^T) * fsq_h + bq_h).
      {
        FragC8 acc[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0);
        for (int d0 = 0; d0 < D; d0 += KC8) {
          stage_tile_i8(xs, xb + (size_t)q0 * D + d0, D, rows);
          stage_tile_i8(wqs, wq_h + d0, D, TILE);
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KC8 / SUB8; ++kk) {
            FragA8 a;
            wmma::load_matrix_sync(a, xs + kk * TILE * SUB8 + rf * 16 * SUB8,
                                   SUB8);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              FragB8 bm;
              wmma::load_matrix_sync(
                  bm, wqs + kk * TILE * SUB8 + (cf + j) * 16 * SUB8, SUB8);
              wmma::mma_sync(acc[j], a, bm, acc[j]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(iq + rf * 16 * LDF + (cf + j) * 16, acc[j],
                                  LDF, wmma::mem_row_major);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < TILE * DH; i += THREADS) {
          const int r = i / DH;
          const int c = i % DH;
          qs[r * LDB + c] = dequant(iq[r * LDF + c], fsq[c_h + c],
                                    bq[c_h + c]);
        }
        __syncthreads();
      }

      attend_tile(qs, ks, vs, sf, ps, S, scale,
                  out + ((size_t)b * S + q0) * P + h * DH, P, rows);
    }
  }
}

}  // namespace
