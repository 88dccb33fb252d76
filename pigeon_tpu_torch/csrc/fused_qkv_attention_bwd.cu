// Fused QKV projection + softmax attention BACKWARD, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_qkv_bwd_kernel
// (launcher `_fused_qkv_backward`, the VJP of `fused_qkv_mha` on the
// training route of every CLIP encoder layer). Given x (B, S, D), the
// Linear-layout weights W* (P, D), biases b* (P,) and the output
// cotangent g (B, S, P), it returns dx (B, S, D) and the projection
// cotangents dq, dk, dv (B, S, P), at the rounding points of
// flash_attention.py:397-455:
//
//   q, k, v = bf16(x @ W*^T + b*)                       (f32 bias add)
//   s = (q k^T) * scale,  m = rowmax(s),  u = exp(s - m),  den = sum(u)
//   g_n = bf16(g / den),  dv = bf16(u)^T g_n
//   dp = g v^T (f32),     r = sum(dp * u) / den        (from f32 u)
//   dl = bf16(u * (dp - r) * scale / den)
//   dq = dl k,  dk = dl^T q,  dx = dq Wq + dk Wk + dv Wv  (f32 accumulate)
//
// The weight and bias gradients are left to the caller (cuBLAS), as the
// JAX package leaves them to XLA.
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// D=1024, H=16) the call is ~450 GFLOP of bf16 tensor-core work: the
// q/k/v projection and the dx product are ~116 GFLOP each, and the
// attention part recomputes the scores four times and dp three times
// (~218 GFLOP), over ~300 MB of operands and workspace, far above the
// card's ~295 FLOP per byte. The tensor cores bound it, and this first
// form feeds them with WMMA (mma.sync) from shared memory.
//
// The TPU kernel keeps two (S, S) f32 buffers per head in VMEM; a Hopper
// block has 227 KB. So the work is four launches, none with atomics, each
// giving the same sums in every run:
//
//   1. proj:  q/k/v = bf16(x W*^T + b*) into a bf16 workspace (B, S, P)
//             each (113 MB at B=32): a tiled GEMM, 128 x 128 block tiles,
//             K in 32-wide steps double-buffered with cp.async. Keeping
//             q/k/v on chip, as the TPU kernel does, is later work.
//   2. dq:    one block per (query tile, head, batch) holds its Q and G
//             tiles and walks the key tiles three times: the row max m;
//             den and sum(dp * u) (so r comes from f32 u, not from the
//             forward's bf16 output); then dl and dq += dl k. It writes
//             m, den and r for pass 3.
//   3. dk/dv: one block per (key tile, head, batch) holds its K and V
//             tiles and walks the query tiles: dv += bf16(u)^T g_n and
//             dk += dl^T q, with the row statistics from pass 2.
//   4. dx:    [dq|dk|dv] (B*S, 3P) @ [Wq;Wk;Wv] (3P, D), the head
//             reduction the TPU kernel did in a VMEM scratch across its
//             in-order group sweep; here a tiled GEMM, K = 3P, f32
//             accumulation.
//
// At the training shape passes 2 and 3 run 32 x 16 x 10 = 5,120 blocks
// each. Ragged S is masked as in K1: rows past S are staged as zeros,
// get u = 0 and are never written.
//
// Constraints (checked by the Python wrapper): head_dim 64, D and P
// multiples of 128, all operands bf16, contiguous, 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DH = 64;        // head dim
constexpr int TILE = 64;      // rows of a query / key tile
constexpr int LDB = 72;       // bf16 row stride of a tile (+8 pad)
constexpr int LDF = 68;       // f32 row stride of a tile (+4 pad)
constexpr int THREADS = 256;  // 8 warps
constexpr int TILE_B = TILE * LDB * 2;  // one 64-row bf16 tile: 9216 B
constexpr int TILE_F = TILE * LDF * 4;  // one 64-row f32 tile: 17408 B
constexpr int DQ_SMEM = 5 * TILE_B + 2 * TILE_F;    // 80,896 B
constexpr int DKDV_SMEM = 7 * TILE_B + 2 * TILE_F;  // 99,328 B

// GEMM tiling: 128 x 128 block tile, 32-deep K steps, 8 warps as 4 (M)
// x 2 (N), each warp 32 x 64 (2 x 4 fragments).
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDK = BK + 8;   // a tile stored (row, k): 40
constexpr int LDN = BN + 8;   // a tile stored (k, col): 136
constexpr int STAGE = BM * LDK * 2;  // 10240 B, >= BK * LDN * 2 = 8704 B
constexpr int EPI_LD = 20;    // per-warp 16 x 16 f32 epilogue, row stride

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragBRow;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---------------------------------------------------------------------
// Passes 1 and 4: tiled GEMMs.
// ---------------------------------------------------------------------

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

struct GemmArgs {
  const bf16* a[3];     // proj: a[0] = x (M, D); dx: dq, dk, dv (M, P)
  const bf16* w[3];     // Wq, Wk, Wv (P, D)
  const bf16* bias[3];  // proj: bq, bk, bv
  bf16* out[3];         // proj: q, k, v (M, P); dx: out[0] = dx (M, D)
  int M, D, P;
};

// PROJ: out_t[m, n] = bf16(sum_k x[m, k] W_t[n, k] + b_t[n]) for the
//       three matrices t laid side by side along N (N = 3P, K = D).
// DX:   out[m, n] = bf16(sum_t sum_k d_t[m, k] W_t[k, n]) with the three
//       products laid end to end along K (K = 3P, N = D).
template <bool PROJ>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(GemmArgs args) {
  __shared__ __align__(128) unsigned char smem[4 * STAGE];
  const int M = args.M, D = args.D, P = args.P;
  const int K = PROJ ? D : 3 * P;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // 32-row strip of the block tile
  const int wn = warp % 2;  // 64-column strip
  // PROJ: the block's 128 columns lie inside one of the three matrices.
  const int t_out = PROJ ? n0 / P : 0;

  auto load_stage = [&](int buf, int k0) {
    bf16* as = reinterpret_cast<bf16*>(smem + buf * 2 * STAGE);
    bf16* bs = reinterpret_cast<bf16*>(smem + buf * 2 * STAGE + STAGE);
    const int t = PROJ ? 0 : k0 / P;
    const bf16* a = args.a[t];
    const int lda = PROJ ? D : P;
    const int ka = PROJ ? k0 : k0 - t * P;
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(as + r * LDK + c,
                 a + (size_t)(ok ? m : 0) * lda + ka + c, ok);
    }
    if constexpr (PROJ) {
      // W_t rows n (the output columns), K contiguous: stored (n, k).
      const bf16* w = args.w[t_out] + (size_t)(n0 - t_out * P) * D;
      for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        cp_async16(bs + r * LDK + c, w + (size_t)r * D + k0 + c, true);
      }
    } else {
      // W_t rows k, the output columns n contiguous: stored (k, n).
      const bf16* w = args.w[t] + (size_t)(k0 - t * P) * D;
      for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
        const int r = i / (BN / 8);
        const int c = (i % (BN / 8)) * 8;
        cp_async16(bs + r * LDN + c, w + (size_t)r * D + n0 + c, true);
      }
    }
  };

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_stage((s + 1) & 1, (s + 1) * BK);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const bf16* as = reinterpret_cast<const bf16*>(smem + (s & 1) * 2 * STAGE);
    const bf16* bs =
        reinterpret_cast<const bf16*>(smem + (s & 1) * 2 * STAGE + STAGE);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDK + kk,
                               LDK);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (PROJ) {
          FragBCol fb;
          wmma::load_matrix_sync(fb, bs + (wn * 64 + j * 16) * LDK + kk, LDK);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                     acc[i][j]);
        } else {
          FragBRow fb;
          wmma::load_matrix_sync(fb, bs + kk * LDN + wn * 64 + j * 16, LDN);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                     acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16 x 16 f32 patch (overlaying the now
  // idle staging buffers): each lane converts 8 values of one row and
  // writes them as one 16-byte vector.
  float* patch = reinterpret_cast<float*>(smem) + warp * 16 * EPI_LD;
  const int pr = lane / 2;
  const int pc = (lane % 2) * 8;
  bf16* out = args.out[t_out];
  const int ldo = PROJ ? P : D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], EPI_LD, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + pr;
      const int n = n0 + wn * 64 + j * 16 + pc - t_out * P;
      if (m < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = patch[pr * EPI_LD + pc + e];
          if constexpr (PROJ) v[e] += __bfloat162float(args.bias[t_out][n + e]);
        }
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          packed[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(out + (size_t)m * ldo + n) =
            *reinterpret_cast<const uint4*>(packed);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------
// Passes 2 and 3: attention backward over 64-row tiles.
// ---------------------------------------------------------------------

// Copy one head's 64 x 64 bf16 block (global row stride `ld`) into
// shared memory, zero-filling rows at or past `rows`.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int ld, int rows) {
  constexpr int VEC = DH / 8;  // 16-byte vectors per row
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

// out (64 x 64 f32, row stride LDF) = A @ B^T for two 64 x 64 bf16 tiles
// stored row-major; each warp computes two 16 x 16 fragments.
__device__ __forceinline__ void abt_tile(float* out, const bf16* a,
                                         const bf16* b, int rf, int cf) {
  FragC acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + rf * 16 * LDB + kk, LDB);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + (cf + j) * 16 * LDB + kk, LDB);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(out + rf * 16 * LDF + (cf + j) * 16, acc[j], LDF,
                            wmma::mem_row_major);
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
    abt_tile(sf, qs, ks, rf, cf);
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
    abt_tile(sf, qs, ks, rf, cf);
    abt_tile(dpf, gs, vs, rf, cf);
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
    abt_tile(sf, qs, ks, rf, cf);
    abt_tile(dpf, gs, vs, rf, cf);
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
    abt_tile(sf, qs, ks, rf, cf);
    abt_tile(dpf, gs, vs, rf, cf);
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

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D); wq/wk/wv (P, D) in torch Linear layout; bq/bk/bv (P,);
// g (B, S, P) -> dx (B, S, D), dq/dk/dv (B, S, P). Workspace: q/k/v
// (B, S, P) bf16 each and stats (3, B, H, S) f32. All bf16 operands
// contiguous, P = heads * 64. Launches the four passes on `stream` and
// returns the first failing launch's cudaError_t (0 on success).
int pigeon_fused_qkv_attention_backward(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* bq, const void* bk, const void* bv, const void* g, void* dx,
    void* dq, void* dk, void* dv, void* q_ws, void* k_ws, void* v_ws,
    void* stats, int batch, int seq, int dim, int heads, void* stream) {
  const int P = heads * DH;
  if (batch < 1 || seq < 1 || heads < 1 || dim % BN != 0 || P % BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = batch * seq;
  const int m_blocks = (M + BM - 1) / BM;
  cudaError_t err;

  GemmArgs proj = {};
  proj.a[0] = static_cast<const bf16*>(x);
  proj.w[0] = static_cast<const bf16*>(wq);
  proj.w[1] = static_cast<const bf16*>(wk);
  proj.w[2] = static_cast<const bf16*>(wv);
  proj.bias[0] = static_cast<const bf16*>(bq);
  proj.bias[1] = static_cast<const bf16*>(bk);
  proj.bias[2] = static_cast<const bf16*>(bv);
  proj.out[0] = static_cast<bf16*>(q_ws);
  proj.out[1] = static_cast<bf16*>(k_ws);
  proj.out[2] = static_cast<bf16*>(v_ws);
  proj.M = M;
  proj.D = dim;
  proj.P = P;
  gemm_kernel<true><<<dim3(m_blocks, 3 * P / BN), THREADS, 0, st>>>(proj);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* f = static_cast<float*>(stats);
  const size_t n_rows = (size_t)batch * heads * seq;
  AttnArgs attn = {};
  attn.q = static_cast<const bf16*>(q_ws);
  attn.k = static_cast<const bf16*>(k_ws);
  attn.v = static_cast<const bf16*>(v_ws);
  attn.g = static_cast<const bf16*>(g);
  attn.dq = static_cast<bf16*>(dq);
  attn.dk = static_cast<bf16*>(dk);
  attn.dv = static_cast<bf16*>(dv);
  attn.m = f;
  attn.den = f + n_rows;
  attn.r = f + 2 * n_rows;
  attn.S = seq;
  attn.H = heads;
  attn.scale = 1.0f / sqrtf(static_cast<float>(DH));
  const dim3 tiles((seq + TILE - 1) / TILE, heads, batch);

  err = cudaFuncSetAttribute(attn_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<<<tiles, THREADS, DQ_SMEM, st>>>(attn);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKDV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<<<tiles, THREADS, DKDV_SMEM, st>>>(attn);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  GemmArgs back = {};
  back.a[0] = static_cast<const bf16*>(dq);
  back.a[1] = static_cast<const bf16*>(dk);
  back.a[2] = static_cast<const bf16*>(dv);
  back.w[0] = proj.w[0];
  back.w[1] = proj.w[1];
  back.w[2] = proj.w[2];
  back.out[0] = static_cast<bf16*>(dx);
  back.M = M;
  back.D = dim;
  back.P = P;
  gemm_kernel<false><<<dim3(m_blocks, dim / BN), THREADS, 0, st>>>(back);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
