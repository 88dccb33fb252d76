// The softmax-attention backward shared by kernels K2
// (fused_qkv_attention_bwd.cu, its passes 2 and 3) and K4
// (flash_attention_bwd.cu): dq, dk and dv of one head's attention on
// (B, S, H*64) q/k/v and output cotangent g, with the arithmetic of
// pigeon_tpu/kernels/flash_attention.py::_attn_bwd_kernel (and of the
// attention part of _fused_qkv_bwd_kernel):
//
//   s = (q k^T) * scale,  m = rowmax(s),  u = exp(s - m),  den = sum(u)
//   g_n = bf16(g / den),  dv = bf16(u)^T g_n
//   dp = g v^T (f32),     r = sum(dp * u) / den        (from f32 u)
//   dl = bf16(u * (dp - r) * scale / den)
//   dq = dl k,  dk = dl^T q                             (f32 accumulate)
//
// The TPU kernel keeps two (S, S) f32 buffers per head in VMEM; a Hopper
// block has 227 KB, so the work is two launches over 64-row tiles, no
// atomics, the same sums in every run:
//
//   dq pass:   one block per (query tile, head, batch) holds its Q and G
//              tiles and walks the key tiles three times: the row max m;
//              den and sum(dp * u) (so r comes from f32 u, not from the
//              forward's bf16 output); then dl and dq += dl k. It writes
//              m, den and r to a (3, B, H, S) f32 workspace.
//   dk/dv pass: one block per (key tile, head, batch) holds its K and V
//              tiles and walks the query tiles: dv += bf16(u)^T g_n and
//              dk += dl^T q, with the row statistics of the dq pass.
//
// Ragged S is masked: rows past S are staged as zeros, get u = 0 and are
// never written. q/k/v/g are read in the (B, S, H, 64) layout (row stride
// H*64), so no transpose runs before or after.

#pragma once

#include "attention_tile.cuh"

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;

constexpr int DQ_SMEM = 5 * TILE_B + 2 * TILE_F;    // 80,896 B
constexpr int DKDV_SMEM = 7 * TILE_B + 2 * TILE_F;  // 99,328 B

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

struct AttnArgs {
  const bf16 *q, *k, *v, *g;  // (B, S, P)
  bf16 *dq, *dk, *dv;         // (B, S, P)
  float *m, *den, *r;         // (B, H, S) row statistics
  int S, H;
  float scale;
};

// Pass 2: one block per (query tile, head, batch).
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(AttnArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = args.S, H = args.H, P = H * DH;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int q0 = qt * TILE;
  const int rows = min(TILE, S - q0);
  const float scale = args.scale;

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + TILE * LDB;
  bf16* ks = gs + TILE * LDB;
  bf16* vs = ks + TILE * LDB;
  bf16* dls = vs + TILE * LDB;
  float* sf = reinterpret_cast<float*>(smem + 5 * TILE_B);
  float* dpf = sf + TILE * LDF;

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;          // 16-row strip
  const int cf = (warp % 2) * 2;    // first of two 16-column fragments
  const int row = threadIdx.x / 4;  // element-wise: 4 lanes per row ...
  const int c0 = (threadIdx.x % 4) * 16;  // ... 16 columns each

  const size_t head = (size_t)b * S * P + h * DH;
  stage_tile(qs, args.q + head + (size_t)q0 * P, P, rows);
  stage_tile(gs, args.g + head + (size_t)q0 * P, P, rows);

  // Sweep 1: the exact row maximum of the scaled scores.
  float m = -INFINITY;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv = min(TILE, S - kt * TILE);
    stage_tile(ks, args.k + head + (size_t)kt * TILE * P, P, kv);
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    __syncthreads();
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      if (c < kv) m = fmaxf(m, sf[row * LDF + c] * scale);
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));

  // Sweep 2: den = sum(u) and sum(dp * u), u = exp(s - m) in f32.
  float den = 0.0f, num = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv = min(TILE, S - kt * TILE);
    stage_tile(ks, args.k + head + (size_t)kt * TILE * P, P, kv);
    stage_tile(vs, args.v + head + (size_t)kt * TILE * P, P, kv);
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    score_tile(dpf, gs, vs, rf, cf);
    __syncthreads();
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      if (c < kv) {
        const float u = expf(sf[row * LDF + c] * scale - m);
        den += u;
        num += dpf[row * LDF + c] * u;
      }
    }
  }
  den += __shfl_xor_sync(0xffffffffu, den, 1);
  den += __shfl_xor_sync(0xffffffffu, den, 2);
  num += __shfl_xor_sync(0xffffffffu, num, 1);
  num += __shfl_xor_sync(0xffffffffu, num, 2);
  const float r = num / den;
  const float dl_scale = scale / den;
  if (row < rows && threadIdx.x % 4 == 0) {
    const size_t i = ((size_t)b * H + h) * S + q0 + row;
    args.m[i] = m;
    args.den[i] = den;
    args.r[i] = r;
  }

  // Sweep 3: dl = bf16(u (dp - r) scale / den) and dq += dl k.
  FragC acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv = min(TILE, S - kt * TILE);
    stage_tile(ks, args.k + head + (size_t)kt * TILE * P, P, kv);
    stage_tile(vs, args.v + head + (size_t)kt * TILE * P, P, kv);
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    score_tile(dpf, gs, vs, rf, cf);
    __syncthreads();
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      float dl = 0.0f;
      if (c < kv) {
        const float u = expf(sf[row * LDF + c] * scale - m);
        dl = (u * (dpf[row * LDF + c] - r)) * dl_scale;
      }
      dls[row * LDB + c] = __float2bfloat16(dl);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, dls + rf * 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBRow fb;
        wmma::load_matrix_sync(fb, ks + kk * LDB + (cf + j) * 16, LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();  // ks and dls are rewritten next iteration
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(sf + rf * 16 * LDF + (cf + j) * 16, acc[j], LDF,
                            wmma::mem_row_major);
  }
  __syncthreads();
  write_rows(args.dq + head + (size_t)q0 * P, sf, P, rows);
}

// Pass 3: one block per (key tile, head, batch).
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(AttnArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float m_s[TILE], den_s[TILE], r_s[TILE];
  const int S = args.S, H = args.H, P = H * DH;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int k0 = kt * TILE;
  const int kv = min(TILE, S - k0);
  const float scale = args.scale;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE * LDB;
  bf16* qs = vs + TILE * LDB;
  bf16* gs = qs + TILE * LDB;
  bf16* us = gs + TILE * LDB;   // bf16(u)
  bf16* gns = us + TILE * LDB;  // g_n = bf16(g / den)
  bf16* dls = gns + TILE * LDB;
  float* sf = reinterpret_cast<float*>(smem + 7 * TILE_B);
  float* dpf = sf + TILE * LDF;

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;
  const int cf = (warp % 2) * 2;
  const int row = threadIdx.x / 4;        // a query row of the tile ...
  const int c0 = (threadIdx.x % 4) * 16;  // ... and 16 of its columns

  const size_t head = (size_t)b * S * P + h * DH;
  const size_t stats = ((size_t)b * H + h) * S;
  stage_tile(ks, args.k + head + (size_t)k0 * P, P, kv);
  stage_tile(vs, args.v + head + (size_t)k0 * P, P, kv);

  FragC acc_dk[2], acc_dv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.0f);
    wmma::fill_fragment(acc_dv[j], 0.0f);
  }
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    const int rows = min(TILE, S - q0);
    stage_tile(qs, args.q + head + (size_t)q0 * P, P, rows);
    stage_tile(gs, args.g + head + (size_t)q0 * P, P, rows);
    if (threadIdx.x < TILE) {
      const bool ok = threadIdx.x < rows;
      m_s[threadIdx.x] = ok ? args.m[stats + q0 + threadIdx.x] : 0.0f;
      den_s[threadIdx.x] = ok ? args.den[stats + q0 + threadIdx.x] : 1.0f;
      r_s[threadIdx.x] = ok ? args.r[stats + q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    score_tile(dpf, gs, vs, rf, cf);
    __syncthreads();
    {
      const bool ok = row < rows;
      const float m = m_s[row], den = den_s[row], r = r_s[row];
      const float dl_scale = scale / den;
#pragma unroll
      for (int c = c0; c < c0 + 16; ++c) {
        float u = 0.0f, dl = 0.0f;
        if (ok) {
          u = expf(sf[row * LDF + c] * scale - m);
          dl = (u * (dpf[row * LDF + c] - r)) * dl_scale;
        }
        us[row * LDB + c] = __float2bfloat16(u);
        dls[row * LDB + c] = __float2bfloat16(dl);
        gns[row * LDB + c] =
            __float2bfloat16(__bfloat162float(gs[row * LDB + c]) / den);
      }
    }
    __syncthreads();
    // dv[j] += sum_i u[i][j] g_n[i]; dk[j] += sum_i dl[i][j] q[i]: the
    // (query, key) tiles read transposed as col-major A fragments.
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      FragAT fu, fd;
      wmma::load_matrix_sync(fu, us + kk * LDB + rf * 16, LDB);
      wmma::load_matrix_sync(fd, dls + kk * LDB + rf * 16, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBRow fg, fq;
        wmma::load_matrix_sync(fg, gns + kk * LDB + (cf + j) * 16, LDB);
        wmma::load_matrix_sync(fq, qs + kk * LDB + (cf + j) * 16, LDB);
        wmma::mma_sync(acc_dv[j], fu, fg, acc_dv[j]);
        wmma::mma_sync(acc_dk[j], fd, fq, acc_dk[j]);
      }
    }
    __syncthreads();  // qs, gs and the u/dl tiles are rewritten next
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(sf + rf * 16 * LDF + (cf + j) * 16, acc_dv[j],
                            LDF, wmma::mem_row_major);
    wmma::store_matrix_sync(dpf + rf * 16 * LDF + (cf + j) * 16, acc_dk[j],
                            LDF, wmma::mem_row_major);
  }
  __syncthreads();
  write_rows(args.dv + head + (size_t)k0 * P, sf, P, kv);
  write_rows(args.dk + head + (size_t)k0 * P, dpf, P, kv);
}

// Launch the dq pass, then the dk/dv pass, on `stream` over `batch`
// sequences; returns the first failing call's error.
inline cudaError_t attention_backward_passes(const AttnArgs& args, int batch,
                                             cudaStream_t stream) {
  const dim3 tiles((args.S + TILE - 1) / TILE, args.H, batch);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<<<tiles, THREADS, DQ_SMEM, stream>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKDV_SMEM);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<<<tiles, THREADS, DKDV_SMEM, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
