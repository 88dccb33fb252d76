// The tiled int8 GEMM of kernel K7's out-projection
// (fused_block_attention_int8.cu):
//
//     C[m, n] = epilogue(sum_k A[m, k] W[n, k])      A (M, K), W (N, K)
//
// with W in torch.nn.Linear layout (output rows, K contiguous). A block of
// THREADS = 256 threads (8 warps, 4 along M x 2 along N, each warp 32 x 64
// as 2 x 4 WMMA fragments) computes one BM x BN = 128 x 128 output tile,
// walking K in steps whose W tile is double-buffered by cp.async while the
// caller's `load_a` stages the matching A tile (quantized on the way).
//
//   mma_int8: int8 x int8 -> int32, K in 64-byte steps, each tile stored
//             as four [rows][16 bytes] sub-tiles, one per WMMA k step, so
//             every fragment starts on a 256-byte boundary with a 16-byte
//             leading dimension (WMMA's alignment rules for 8-bit
//             operands);
//   epilogue: the accumulators through a per-warp 16 x 16 patch, handing
//             the caller 8 consecutive values of one row at a time, so it
//             can finish them in f32 and write one 16-byte vector.
//
// Everything lives in namespace `gemm`, so a source can include this and
// attention_tile.cuh side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {
namespace gemm {

using namespace nvcuda;

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // block tile rows
constexpr int BN = 128;       // block tile columns
// 64-byte K steps as four 16-byte sub-tiles.
constexpr int BK8 = 64;
constexpr int SUB = 16;
constexpr int STAGE8 = BM * BK8;     // one 128 x 64 int8 tile: 8192 B
constexpr int EPI_LD = 20;           // per-warp 16 x 16 patch stride
// Static shared memory of a GEMM block: two buffers of an A and a W tile.
constexpr int SMEM_BYTES = 4 * STAGE8;
static_assert(8 * 16 * EPI_LD * 4 <= SMEM_BYTES, "epilogue overflows");

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major>
    FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major>
    FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// int8 main loop of the block tile whose W rows start at n0: acc +=
// A_tile @ W[n0:n0+BN]^T over K (a multiple of BK8). load_a(int8_t* as,
// int k0) stages the BM x BK8 A tile at K offset k0 as four [BM][SUB]
// sub-tiles (sub-tile c / SUB holds bytes c .. c + 15 of each row); it may
// issue cp.async copies, which join the W tile's group. `smem` holds
// SMEM_BYTES.
template <class LoadA>
__device__ __forceinline__ void mma_int8(unsigned char* smem, LoadA load_a,
                                         const int8_t* __restrict__ w, int K,
                                         int n0, FragC8 (&acc)[2][4]) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  auto load_stage = [&](int buf, int k0) {
    int8_t* as = reinterpret_cast<int8_t*>(smem + buf * 2 * STAGE8);
    int8_t* bs = reinterpret_cast<int8_t*>(smem + buf * 2 * STAGE8 + STAGE8);
    load_a(as, k0);
    for (int i = threadIdx.x; i < BN * BK8 / SUB; i += THREADS) {
      const int r = i / (BK8 / SUB);
      const int v = i % (BK8 / SUB);
      cp_async16(bs + v * BN * SUB + r * SUB,
                 w + (size_t)(n0 + r) * K + k0 + v * SUB, true);
    }
  };

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int steps = K / BK8;
  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_stage((s + 1) & 1, (s + 1) * BK8);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* as =
        reinterpret_cast<const int8_t*>(smem + (s & 1) * 2 * STAGE8);
    const int8_t* bs =
        reinterpret_cast<const int8_t*>(smem + (s & 1) * 2 * STAGE8 + STAGE8);
#pragma unroll
    for (int kk = 0; kk < BK8 / SUB; ++kk) {
      FragA8 fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(
            fa[i], as + kk * BM * SUB + (wm * 32 + i * 16) * SUB, SUB);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB8 fb;
        wmma::load_matrix_sync(
            fb, bs + kk * BN * SUB + (wn * 64 + j * 16) * SUB, SUB);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// Hand the block tile's accumulators to fn(r, c, v), 8 values v[0..7] of
// tile row r, columns c .. c + 7 (r, c relative to the tile's corner),
// each (r, c) once, through a per-warp patch in `smem` (which must be free:
// after a main loop it is). T is the accumulator's element type.
template <class T, class Frag, class Fn>
__device__ __forceinline__ void epilogue(unsigned char* smem,
                                         Frag (&acc)[2][4], Fn fn) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  T* patch = reinterpret_cast<T*>(smem) + warp * 16 * EPI_LD;
  const int pr = lane / 2;
  const int pc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], EPI_LD, wmma::mem_row_major);
      __syncwarp();
      fn(wm * 32 + i * 16 + pr, wn * 64 + j * 16 + pc,
         patch + pr * EPI_LD + pc);
      __syncwarp();
    }
  }
}

// Write 8 f32 values rounded to bf16 as one 16-byte vector.
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* v) {
  __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    packed[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

}  // namespace gemm
}  // namespace
