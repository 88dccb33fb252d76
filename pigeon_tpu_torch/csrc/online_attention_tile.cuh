// The online-softmax attention body of V10, the 256-key tuning variant
// of K3′ (attention_fwd_variants.cu), kept in the TPU script's design to
// measure it; K3′ itself runs K3's wgmma forward (flash_fwd_sm90.cuh).
// Exact attention with a running max over CHUNK-key steps, for one 64-row
// query tile of one head,
//
//     s     = (q k_c^T) * 64^-0.5                          (f32)
//     m_new = max(m, max_c(s));  p = exp(s - m_new);  corr = exp(m - m_new)
//     l     = l * corr + sum(p)                             (f32 p)
//     acc   = acc * corr + bf16(p) @ v_c                    (f32)
//
// and out = bf16(acc / l). The block keeps its Q tile, one CHUNK-key chunk
// of K and V, the f32 score tile (the bf16 P tile written over it) and the
// f32 output accumulator in shared memory; four threads a row hold the
// row's running max and denominator and CHUNK / 4 of its scores in
// registers, on WMMA (mma.sync) with no copy/compute overlap.
// Keys past S are staged as zeros and masked; query rows past S are never
// written.

#pragma once

#include "attention_tile.cuh"

namespace {

// Shared memory of a block at CHUNK keys a step: Q, one K and one V chunk,
// the score tile and the accumulator.
template <int CHUNK>
__host__ __device__ constexpr int online_smem_bytes() {
  return TILE_B + 2 * CHUNK * LDB * 2 + TILE * (CHUNK + 4) * 4 + TILE_F;
}

template <int CHUNK, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
online_attention_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        int S, int H, float scale) {
  static_assert(CHUNK % TILE == 0, "CHUNK is whole 64-key tiles");
  static_assert(MIN_BLOCKS * online_smem_bytes<CHUNK>() <= 228 * 1024 -
                    MIN_BLOCKS * 1024,
                "MIN_BLOCKS blocks an SM");
  constexpr int LDS = CHUNK + 4;  // f32 score row stride
  constexpr int LDP = 2 * LDS;    // bf16 P row stride: row r overlays S row r
  constexpr int CHUNK_B = CHUNK * LDB * 2;  // one staged K or V chunk
  constexpr int PER = CHUNK / 4;            // a thread's keys of its row
  constexpr int SFRAGS = CHUNK / 32;        // score fragments of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * TILE;
  const int rows = min(TILE, S - q0);
  const int ld = H * DH;  // row stride of (B, S, H, 64)
  const size_t head = (size_t)b * S * ld + (size_t)h * DH;

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + TILE_B);
  bf16* vs = reinterpret_cast<bf16*>(smem + TILE_B + CHUNK_B);
  float* sf = reinterpret_cast<float*>(smem + TILE_B + 2 * CHUNK_B);
  bf16* ps = reinterpret_cast<bf16*>(sf);
  float* acc = reinterpret_cast<float*>(smem + TILE_B + 2 * CHUNK_B +
                                        TILE * LDS * 4);

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;             // 16-row strip of the tile
  const int row = threadIdx.x / 4;     // softmax: 4 threads a row ...
  const int quarter = threadIdx.x % 4;  // ... PER keys, 16 outputs each

  stage_tile(qs, q + head + (size_t)q0 * ld, ld, rows);
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[row * LDF + quarter * 16 + j] = 0.0f;
  float m = -INFINITY;  // running max of the row
  float l = 0.0f;       // running denominator

  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int kv = min(CHUNK, S - c0);
    for (int half = 0; half < CHUNK / TILE; ++half) {
      const int r0 = c0 + half * TILE;
      const int n = max(0, min(TILE, S - r0));
      stage_tile(ks + half * TILE * LDB, k + head + (size_t)r0 * ld, ld, n);
      stage_tile(vs + half * TILE * LDB, v + head + (size_t)r0 * ld, ld, n);
    }
    __syncthreads();

    // s = Q K_c^T: warp (rf, half) computes a 16 x CHUNK/2 strip.
    {
      const int cf = (warp % 2) * SFRAGS;
      FragC sacc[SFRAGS];
#pragma unroll
      for (int j = 0; j < SFRAGS; ++j) wmma::fill_fragment(sacc[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, qs + rf * 16 * LDB + kk, LDB);
#pragma unroll
        for (int j = 0; j < SFRAGS; ++j) {
          FragBCol bm;
          wmma::load_matrix_sync(bm, ks + (cf + j) * 16 * LDB + kk, LDB);
          wmma::mma_sync(sacc[j], a, bm, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < SFRAGS; ++j) {
        wmma::store_matrix_sync(sf + rf * 16 * LDS + (cf + j) * 16, sacc[j],
                                LDS, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // The row's max, p, denominator and correction; the accumulator rows
    // scaled by the correction.
    float p[PER];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = quarter * PER + j;
      p[j] = c < kv ? sf[row * LDS + c] * scale : -INFINITY;
      cmax = fmaxf(cmax, p[j]);
    }
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      p[j] = quarter * PER + j < kv ? expf(p[j] - m_new) : 0.0f;
      psum += p[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[row * LDF + quarter * 16 + j] *= corr;
    __syncthreads();  // every score read before P overwrites the scores
#pragma unroll
    for (int j = 0; j < PER; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(ps + row * LDP + quarter * PER + j) =
          __floats2bfloat162_rn(p[j], p[j + 1]);
    }
    __syncthreads();

    // acc += bf16(P) @ V_c: warp (rf, half) updates a 16 x 32 strip.
    {
      const int cf = (warp % 2) * 2;
      FragC oacc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(oacc[j], acc + rf * 16 * LDF + (cf + j) * 16,
                               LDF, wmma::mem_row_major);
      }
#pragma unroll
      for (int kk = 0; kk < CHUNK; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ps + rf * 16 * LDP + kk, LDP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBRow bm;
          wmma::load_matrix_sync(bm, vs + kk * LDB + (cf + j) * 16, LDB);
          wmma::mma_sync(oacc[j], a, bm, oacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(acc + rf * 16 * LDF + (cf + j) * 16, oacc[j],
                                LDF, wmma::mem_row_major);
      }
    }
    __syncthreads();  // before K/V, S and P are restaged
  }

  if (row < rows) {
    bf16* dst = out + head + (size_t)(q0 + row) * ld + quarter * 16;
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(
          acc[row * LDF + quarter * 16 + j] / l,
          acc[row * LDF + quarter * 16 + j + 1] / l);
    }
  }
}

// Launch the kernel at CHUNK keys a step over (B, S, H, 64) q/k/v on
// `stream`; returns the first failing call's error.
template <int CHUNK, int MIN_BLOCKS>
inline cudaError_t launch_online_attention(const void* q, const void* k,
                                           const void* v, void* out,
                                           int batch, int seq, int heads,
                                           cudaStream_t stream) {
  if (batch < 1 || seq < 1 || heads < 1) return cudaErrorInvalidValue;
  constexpr int smem = online_smem_bytes<CHUNK>();
  cudaError_t err = cudaFuncSetAttribute(
      online_attention_kernel<CHUNK, MIN_BLOCKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + TILE - 1) / TILE, batch * heads);
  online_attention_kernel<CHUNK, MIN_BLOCKS><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seq, heads,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace
