// The attention-backward tuning variants of scripts/bench_attn_bwd.py on
// (B, S, H, 64) q/k/v and output cotangent g, for Hopper (sm_90a). Each
// replaces one Pallas body of that script (the TPU file and function are
// named at its entry point below); on the card they answer what bounds
// K4 (flash_attention_bwd.cu) and K2's attention passes:
//
//   V1 bwd_r_from_o  K4's dq, dk, dv with r = sum(g * (bf16(u) v) / den),
//                    u = exp(s - m) against the exact row max: r from the
//                    recomputed output, where K4 takes sum(dp * u) / den.
//                    It runs on K4's wgmma passes (flash_bwd_sm90.cuh)
//                    under its own tag, V1Attention: a statistics pass of
//                    its own (flash_attention_bwd_stats_from_output_kernel:
//                    K4's block, Q and G tiles and K/V ring; one sweep of
//                    Q K^T for the exact max, a second for u, den and
//                    o_rec = bf16(u) V on wgmma, then r from G's tile),
//                    then K4's gradient and dq passes unchanged. Eight
//                    S x S x 64 walks against K4's seven, as the TPU
//                    body's six products against K4's five: the time
//                    against K4's in one driver run is what statistics
//                    from the output, not from dp, cost or save.
//   V2 dq            dq alone (the script's split4, first half): K4's
//                    statistics pass under the tag V2Attention (two walks:
//                    s, dp), then a query-major dq pass
//                    (flash_attention_bwd_rows_dq_kernel, three walks: s,
//                    dp, dl k) that keeps each row's dq in registers. 2 + 3
//                    walks against the TPU body's 3 products. The g_n the
//                    statistics pass writes goes unread.
//   V3 dkv           dk, dv alone (split4's second half): K4's statistics
//                    pass under V3Attention, then K4's gradient pass
//                    without its dq product (DQ = false: no dl^T tile, no
//                    f32 workspace, no reduce-add, no dq cast). 2 + 4
//                    walks against the TPU body's 4.
//   V4 dots_only     diagnostic: K4's products with the softmax chain
//                    replaced by casts (s = q k^T unscaled, dv = bf16(s)^T
//                    g, dp = g v^T, dl = bf16(s * dp), dq = dl k,
//                    dk = dl^T q). Two launches: a dq pass and a dk/dv
//                    pass, each forming s and dp for its tiles, 7 products
//                    a (query tile, key tile) pair where the TPU body
//                    forms 5.
//   V5 vpu_only      diagnostic: the scores and K4's S-wide softmax chain
//                    with the output products removed (dp stands in as
//                    the scaled scores): dq = bf16(q + bf16(dl[:, :64])),
//                    dk = k, dv = bf16(g / den). One launch, a block per
//                    query tile walking the key tiles three times (the
//                    max; den and sum(dp * u); dl).
//
// Why V2 and V3 need a statistics pass the TPU bodies do not: a TPU body
// holds a head's whole (S, S) score block in VMEM, so it finds each row's
// max, den and r in the block it takes the products from. A Hopper block
// holds 128 rows and one 128-key chunk (227 KB of shared memory): V3's
// key-major block never sees a whole query row, and V2's query-major
// block needs the row's r, a sum over every key, before its first dl.
//
// What bounds them on the H100, at the tuning shape (B = 32 views,
// S = 577, H = 16): the TPU bodies' products are ~22 GFLOP each
// (2 B H S^2 64, 0.022 ms at 989 TFLOP/s); V1 has six (~131 GFLOP,
// ~0.13 ms), V2 three and V3 four (~153 GFLOP together), V4 five; q/k/v/g
// and the outputs are ~265 MB (~0.08 ms), so the tensor cores bound the
// exact variants and V4. V2 and V3 walk 5 and 6 times, each walk's
// products waiting on its exps. V5's TPU body does one product and ~12
// f32 operations an S x S element (~2 G at 67 TFLOP/s, ~0.03 ms): its own
// bound is small, and its time is what the softmax chain costs as the
// WMMA pass runs it (three sweeps, the scores formed in each). V4 and V5
// keep the design the attention kernels had before they moved to wgmma
// (WMMA from shared memory, no copy/compute overlap; attention_tile.cuh).
//
// Keeping the measured work alive: nvcc deletes what never reaches
// memory. V5 stores only dl's first 64 columns; every other column of dl
// goes into a per-row f32 side output, sum(|dl|) over all S keys, which
// the plain version computes too. V4's and V1-V3's outputs read every
// product. Checked in the SASS (cuobjdump -sass of the sm_90a build):
// vpu_only_kernel keeps 48 HMMA (three sweeps of score tiles) and 48
// MUFU.EX2 (the exps of sweeps 2 and 3, sweep 3 peeled at its first key
// tile), so every key's dl is formed.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// bf16, (B, S, H, 64) contiguous and 16-byte aligned; V5 needs S >= 64;
// V1-V3 take K4's row-statistics workspace (3, B, H, S) f32 and its g_n
// (B, S, H, 64) bf16; V1 also K4's zeroed dq_acc (B, H, ceil(S / 64),
// 4096) f32. Ragged S is masked: rows past S are staged as zeros (TMA
// reads zeros past row S for V1-V3), get u = 0 and are never written.

#include "attention_tile.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

// V1-V3's instances of K4's passes.
struct V1Attention {};
struct V2Attention {};
struct V3Attention {};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;

// The arguments of V4 and V5: q/k/v/g and dq/dk/dv (B, S, H*64).
struct AttnArgs {
  const bf16 *q, *k, *v, *g;
  bf16 *dq, *dk, *dv;
  int S, H;
  float scale;
};

constexpr int DQ_SMEM = 5 * TILE_B + 2 * TILE_F;         // 80,896 B
constexpr int DOTS_DKDV_SMEM = 6 * TILE_B + 2 * TILE_F;  // 90,112 B
constexpr int VPU_SMEM = 2 * TILE_B + TILE_F;            // 35,840 B

// V4's dq pass: one block per (query tile, head, batch); for each key
// tile s = Q K^T, dp = G V^T, dl = bf16(s * dp), dq += dl K.
__global__ void __launch_bounds__(THREADS)
dots_only_dq_kernel(AttnArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = args.S, H = args.H, P = H * DH;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int q0 = qt * TILE;
  const int rows = min(TILE, S - q0);

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + TILE * LDB;
  bf16* ks = gs + TILE * LDB;
  bf16* vs = ks + TILE * LDB;
  bf16* dls = vs + TILE * LDB;
  float* sf = reinterpret_cast<float*>(smem + 5 * TILE_B);
  float* dpf = sf + TILE * LDF;

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;
  const int cf = (warp % 2) * 2;
  const int row = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 16;

  const size_t head = (size_t)b * S * P + h * DH;
  stage_tile(qs, args.q + head + (size_t)q0 * P, P, rows);
  stage_tile(gs, args.g + head + (size_t)q0 * P, P, rows);

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
      const float dl = c < kv ? sf[row * LDF + c] * dpf[row * LDF + c] : 0.0f;
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

// V4's dk/dv pass: one block per (key tile, head, batch); for each query
// tile s and dp again, dv += bf16(s)^T G and dk += bf16(s * dp)^T Q.
__global__ void __launch_bounds__(THREADS)
dots_only_dkdv_kernel(AttnArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = args.S, H = args.H, P = H * DH;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int k0 = kt * TILE;
  const int kv = min(TILE, S - k0);

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE * LDB;
  bf16* qs = vs + TILE * LDB;
  bf16* gs = qs + TILE * LDB;
  bf16* us = gs + TILE * LDB;   // bf16(s)
  bf16* dls = us + TILE * LDB;  // bf16(s * dp)
  float* sf = reinterpret_cast<float*>(smem + 6 * TILE_B);
  float* dpf = sf + TILE * LDF;

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;
  const int cf = (warp % 2) * 2;
  const int row = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 16;

  const size_t head = (size_t)b * S * P + h * DH;
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
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    score_tile(dpf, gs, vs, rf, cf);
    __syncthreads();
    {
      const bool ok = row < rows;
#pragma unroll
      for (int c = c0; c < c0 + 16; ++c) {
        const float s = ok ? sf[row * LDF + c] : 0.0f;
        us[row * LDB + c] = __float2bfloat16(s);
        dls[row * LDB + c] = __float2bfloat16(s * dpf[row * LDF + c]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      FragAT fu, fd;
      wmma::load_matrix_sync(fu, us + kk * LDB + rf * 16, LDB);
      wmma::load_matrix_sync(fd, dls + kk * LDB + rf * 16, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBRow fg, fq;
        wmma::load_matrix_sync(fg, gs + kk * LDB + (cf + j) * 16, LDB);
        wmma::load_matrix_sync(fq, qs + kk * LDB + (cf + j) * 16, LDB);
        wmma::mma_sync(acc_dv[j], fu, fg, acc_dv[j]);
        wmma::mma_sync(acc_dk[j], fd, fq, acc_dk[j]);
      }
    }
    __syncthreads();  // qs, gs and the s/dl tiles are rewritten next
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

// V5: one block per (query tile, head, batch). `dl_abs` (B, H, S) f32
// takes each row's sum(|dl|) over all S keys.
__global__ void __launch_bounds__(THREADS)
vpu_only_kernel(AttnArgs args, float* __restrict__ dl_abs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = args.S, H = args.H, P = H * DH;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int q0 = qt * TILE;
  const int rows = min(TILE, S - q0);
  const float scale = args.scale;

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TILE * LDB;
  float* sf = reinterpret_cast<float*>(smem + 2 * TILE_B);

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;
  const int cf = (warp % 2) * 2;
  const int row = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 16;

  const size_t head = (size_t)b * S * P + h * DH;
  stage_tile(qs, args.q + head + (size_t)q0 * P, P, rows);

  // Sweep 1: the row max of the scaled scores.
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

  // Sweep 2: den = sum(u) and sum(dp * u) with dp the scaled scores.
  float den = 0.0f, num = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv = min(TILE, S - kt * TILE);
    stage_tile(ks, args.k + head + (size_t)kt * TILE * P, P, kv);
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    __syncthreads();
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      if (c < kv) {
        const float dp = sf[row * LDF + c] * scale;
        const float u = expf(dp - m);
        den += u;
        num += dp * u;
      }
    }
  }
  den += __shfl_xor_sync(0xffffffffu, den, 1);
  den += __shfl_xor_sync(0xffffffffu, den, 2);
  num += __shfl_xor_sync(0xffffffffu, num, 1);
  num += __shfl_xor_sync(0xffffffffu, num, 2);
  const float r = num / den;
  const float dl_scale = scale / den;

  // Sweep 3: dl = u (dp - r) scale / den over every key; the first 64
  // columns kept for dq, |dl| summed over all of them.
  float dl0[16];
  float dsum = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv = min(TILE, S - kt * TILE);
    stage_tile(ks, args.k + head + (size_t)kt * TILE * P, P, kv);
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      float dl = 0.0f;
      if (c < kv) {
        const float dp = sf[row * LDF + c] * scale;
        const float u = expf(dp - m);
        dl = (u * (dp - r)) * dl_scale;
      }
      dsum += fabsf(dl);
      if (kt == 0) dl0[j] = dl;
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);

  if (row < rows) {
    const size_t at = head + (size_t)(q0 + row) * P + c0;
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const float d0 = __bfloat162float(__float2bfloat16(dl0[j]));
      const float d1 = __bfloat162float(__float2bfloat16(dl0[j + 1]));
      *reinterpret_cast<__nv_bfloat162*>(args.dq + at + j) =
          __floats2bfloat162_rn(
              __bfloat162float(qs[row * LDB + c0 + j]) + d0,
              __bfloat162float(qs[row * LDB + c0 + j + 1]) + d1);
      *reinterpret_cast<__nv_bfloat162*>(args.dk + at + j) =
          *reinterpret_cast<const __nv_bfloat162*>(args.k + at + j);
      *reinterpret_cast<__nv_bfloat162*>(args.dv + at + j) =
          __floats2bfloat162_rn(__bfloat162float(args.g[at + j]) / den,
                                __bfloat162float(args.g[at + j + 1]) / den);
    }
    if (threadIdx.x % 4 == 0) {
      dl_abs[((size_t)b * H + h) * S + q0 + row] = dsum;
    }
  }
}

inline cudaError_t launch(void (*kernel)(AttnArgs), int smem,
                          const AttnArgs& args, int batch,
                          cudaStream_t stream) {
  const dim3 tiles((args.S + TILE - 1) / TILE, args.H, batch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, THREADS, smem, stream>>>(args);
  return cudaGetLastError();
}

// V4's and V5's arguments: q/k/v/g and dq/dk/dv (B, S, H, 64) bf16.
AttnArgs make_args(const void* q, const void* k, const void* v,
                   const void* g, void* dq, void* dk, void* dv, int seq,
                   int heads) {
  AttnArgs args = {};
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.g = static_cast<const bf16*>(g);
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.S = seq;
  args.H = heads;
  args.scale = 1.0f / sqrtf(static_cast<float>(DH));
  return args;
}

// V1-V3's arguments of K4's passes: the statistics (3, B, H, S) f32 and
// g_n workspaces, dq_acc (V1 alone, else null) and the outputs each
// produces (the others null).
BwdArgs bwd_args(void* stats, void* g_n, void* dq_acc, void* dq, void* dk,
                 void* dv, int batch, int seq, int heads) {
  float* f = static_cast<float*>(stats);
  const size_t n_rows = (size_t)batch * heads * seq;
  BwdArgs args = {};
  args.m = f;
  args.den = f + n_rows;
  args.r = f + 2 * n_rows;
  args.g_n = static_cast<bf16*>(g_n);
  args.dq_acc = static_cast<float*>(dq_acc);
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.S = seq;
  args.H = heads;
  args.scale = 1.0f / sqrtf(static_cast<float>(HD));
  args.scale_log2 = args.scale * LOG2E;
  return args;
}

bool bad_shape(int batch, int seq, int heads) {
  return batch < 1 || seq < 1 || heads < 1;
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// V1, scripts/bench_attn_bwd.py::bwd_r_from_o: dq, dk, dv, with K4's
// workspaces (stats, g_n and dq_acc, zeroed).
int pigeon_attention_bwd_r_from_o(const void* q, const void* k,
                                  const void* v, const void* g, void* dq,
                                  void* dk, void* dv, void* stats, void* g_n,
                                  void* dq_acc, int batch, int seq, int heads,
                                  void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const BwdArgs args =
      bwd_args(stats, g_n, dq_acc, dq, dk, dv, batch, seq, heads);
  return static_cast<int>(
      launch_flash_backward<V1Attention, BwdPasses::kFromOutput>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V2, scripts/bench_attn_bwd.py::dq_body: dq, with K4's statistics and
// g_n workspaces.
int pigeon_attention_dq(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* stats, void* g_n,
                        int batch, int seq, int heads, void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const BwdArgs args = bwd_args(stats, g_n, nullptr, dq, nullptr, nullptr,
                                batch, seq, heads);
  return static_cast<int>(
      launch_flash_backward<V2Attention, BwdPasses::kRowsDq>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V3, scripts/bench_attn_bwd.py::dkv_body: dk, dv, with K4's statistics
// and g_n workspaces.
int pigeon_attention_dkv(const void* q, const void* k, const void* v,
                         const void* g, void* dk, void* dv, void* stats,
                         void* g_n, int batch, int seq, int heads,
                         void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const BwdArgs args = bwd_args(stats, g_n, nullptr, nullptr, dk, dv, batch,
                                seq, heads);
  return static_cast<int>(
      launch_flash_backward<V3Attention, BwdPasses::kDkDv>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V4, scripts/bench_attn_bwd.py::dots_only: dq, dk, dv.
int pigeon_attention_bwd_dots_only(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, int batch, int seq,
                                   int heads, void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const AttnArgs a = make_args(q, k, v, g, dq, dk, dv, seq, heads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch(dots_only_dq_kernel, DQ_SMEM, a, batch, st);
  if (err == cudaSuccess) {
    err = launch(dots_only_dkdv_kernel, DOTS_DKDV_SMEM, a, batch, st);
  }
  return static_cast<int>(err);
}

// V5, scripts/bench_attn_bwd.py::vpu_only: dq, dk, dv and each row's
// sum(|dl|) into dl_abs (B, H, S) f32.
int pigeon_attention_bwd_vpu_only(const void* q, const void* k,
                                  const void* v, const void* g, void* dq,
                                  void* dk, void* dv, void* dl_abs,
                                  int batch, int seq, int heads,
                                  void* stream) {
  if (bad_shape(batch, seq, heads) || seq < DH) return cudaErrorInvalidValue;
  const AttnArgs a = make_args(q, k, v, g, dq, dk, dv, seq, heads);
  const dim3 tiles((seq + TILE - 1) / TILE, heads, batch);
  cudaError_t err = cudaFuncSetAttribute(
      vpu_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      VPU_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  vpu_only_kernel<<<tiles, THREADS, VPU_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float*>(dl_abs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
