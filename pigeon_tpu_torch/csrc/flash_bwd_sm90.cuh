// The attention backward of kernel K4 (flash_attention_bwd.cu), and of K2
// (fused_qkv_attention_bwd.cu) on its projected q/k/v, on Hopper's wgmma,
// for (B, S, H, 64) bf16 q/k/v and output cotangent g, with the
// arithmetic of pigeon_tpu/kernels/flash_attention.py::_attn_bwd_kernel
// (and of the attention part of _fused_qkv_bwd_kernel):
//
//   s = (q k^T) * scale,  m = rowmax(s),  u = exp(s - m),  den = sum(u)
//   g_n = bf16(g / den),  dv = bf16(u)^T g_n
//   dp = g v^T (f32),     r = sum(dp * u) / den
//   dl = bf16(u * (dp - r) * scale / den)
//   dq = dl k,  dk = dl^T q                              (f32 accumulate)
//
// Three launches, seven S x S x 64 product walks in all. Each kernel's
// `Tag` names the user's instance, so K2's passes, K4's and the tuning
// kernels V1-V5's (attention_bwd_variants.cu) are told apart in a
// profile. A launch's passes (BwdPasses) are K4's three, or a tuning
// kernel's:
//   V1 takes r from the recomputed output: its own statistics pass
//      (flash_attention_bwd_stats_from_output_kernel, three walks), then
//      the gradient and dq passes unchanged, eight walks in all;
//   V2 (dq alone) runs the statistics pass, then a query-major dq pass
//      (flash_attention_bwd_rows_dq_kernel, three walks: s, dp, dl k),
//      2 + 3 walks against the TPU body's 3;
//   V3 (dk, dv alone) runs the statistics pass, then the gradient pass
//      without dq (four walks: s, dp, dv, dk), 2 + 4 against its 4;
//   V4 (the products alone) runs no statistics pass: the gradient pass
//      under CastChain (u = s, dl = s dp; no exp, no statistics read),
//      dv's B operand g itself, then the dq cast, five walks as its TPU
//      body's five. K4's gradient time minus V4's is what the exps and
//      the statistics cost that pass;
//   V5 (the chain alone) runs the statistics pass without G V^T (DP =
//      false: dp = s scale, V never loaded; its g_n = bf16(g / den) is
//      V5's dv), then one query-major sweep for dl
//      (flash_attention_bwd_dl_sweep_kernel: s, dl against the final max,
//      sum |dl|, dq and dk), one walk each. K4's statistics time minus
//      V5's is what the dp product costs that pass.
// The TPU bodies hold a whole (S, S) score block of a head in VMEM, so
// each finds its rows' max, den and r in the same block it takes the
// products from. A Hopper block sees 128 queries and one 128-key chunk
// at a time (227 KB of shared memory): a key-major block never sees a
// whole query row, and a query-major one needs the row's r, a sum over
// every key, before its first dl (a running r cannot be corrected once
// bf16(dl) has fed the dq product). So every design here takes the
// statistics first, in a pass of their own, and forms the gradients
// from final statistics.
//
//   statistics pass (flash_attention_bwd_stats_kernel): one block per
//     (128-row query tile, head, image) holds its Q and G tiles and
//     streams 128-key chunks of K and V through a two-stage TMA ring. Two
//     consumer warpgroups of 64 rows take s = Q K^T and dp = G V^T on
//     wgmma (m64n128k16, both from shared memory) and keep, per row, the
//     running max m, den and num = sum(dp * u), both rescaled by
//     corr = exp(m - m_new) as the max moves. They write m, den and
//     r = num / den to the (3, B, H, S) workspace and g_n = bf16(g / den)
//     to a (B, S, H, 64) bf16 workspace. Two walks.
//   gradient pass (flash_attention_bwd_grad_kernel): one block per
//     (128-key tile, head, image) holds its K and V tiles; each consumer
//     warpgroup owns 64 keys and keeps their dk and dv in registers. The
//     64-row query chunks stream in (Q, G and g_n by TMA, the chunk's
//     statistics by the producer warp) and per chunk the warpgroup takes
//       s^T = K Q^T and dp^T = V G^T    (m64n64k16 from shared memory),
//       u = exp(s - m), dl = bf16(u (dp - r) scale / den)  (registers),
//       dv += bf16(u)^T g_n, dk += dl^T q  (A = u^T, dl^T from registers,
//                                           B MN-major from the tiles),
//       dq_part = dl k  (dl^T written to a swizzled shared tile, read as a
//                        transposed A operand; K read MN-major),
//     and adds dq_part to an f32 workspace with one bulk reduce-add of
//     16 KB (cp.reduce.async.bulk ... add.f32). Five walks; four under
//     DQ = false (V3), with no dl^T tile, staging or reduce. The chain
//     from s and dp to u and dl is a policy (SoftmaxChain, K4's; V4's
//     CastChain).
//   dq pass (flash_attention_bwd_dq_kernel): the f32 workspace to bf16 dq
//     in (B, S, H, 64).
//   dq rows (flash_attention_bwd_rows_dq_kernel, V2): the statistics
//     pass's block, tiles and ring; each consumer warpgroup keeps its 64
//     rows' dq in registers and per 128-key chunk takes s and dp as the
//     statistics pass does, dl in place, then dq += dl K on wgmma with dl
//     from registers and K read MN-major (the forward's P V, with dl for p
//     and K for V). No f32 workspace, no reduce-add, no cast launch.
//
// Because the statistics are final before any gradient is formed, each
// rounding of the plain version is reproduced at the same place: u
// relative to the final max, bf16(u) for dv, bf16(g / den), bf16(dl).
// K4's dq sums over the key tiles arrive in the order the bulk reduces
// land, which changes from run to run; V2's run in one fixed order.
//
// What bounds them: at 32 views (S 577, H 16) one walk is 21.8 GFLOP,
// 0.022 ms at 989 TFLOP/s, and q/k/v/g with the outputs ~0.1 ms of
// bytes, so the tensor cores bound each pass; the statistics pass's and
// the dq rows' products wait on each chunk's exps (no overlap within a
// warpgroup), the gradient pass's on its dq traffic.
//
// Ragged S: TMA reads zeros past row S. Keys past S get s = -inf in the
// statistics pass and u = 0 in the gradient pass and the dq rows; query
// rows past S take m = +inf, scale / den = 0 and r = 0 in the gradient
// pass and the dq rows, so they add nothing (their den would be 0), and
// are never written.

#pragma once

#include "hopper_sm90.cuh"

namespace {

constexpr int BWD_THREADS = 384;  // producer + two consumer warpgroups
constexpr int BWD_TILE = 128 * ROW_BYTES;   // 128-row tile, 16 KB
constexpr int BWD_CHUNK = 64 * ROW_BYTES;   // 64-row tile, 8 KB
constexpr int BWD_STAGES = 2;

// The query-major passes (statistics, V1's statistics, V2's dq rows): Q
// and G tiles, then the K/V ring, then the barriers (qg_full, k_full[2],
// v_full[2], empty[2]).
constexpr int ST_KV_OFF = 2 * BWD_TILE;
constexpr int ST_BAR_OFF = ST_KV_OFF + BWD_STAGES * 2 * BWD_TILE;
constexpr int ST_SMEM = ST_BAR_OFF + (1 + 3 * BWD_STAGES) * 8 + 1024;

// Gradient pass: K and V tiles; the ring of query chunks (Q, G, g_n and
// the chunk's m, scale / den and r); each consumer's dl^T tile and dq
// staging; the barriers (kv_full, full[2], empty[2]).
constexpr int GR_STAGE_BYTES = 3 * BWD_CHUNK + 1024;
constexpr int GR_RING_OFF = 2 * BWD_TILE;
constexpr int GR_DL_OFF = GR_RING_OFF + BWD_STAGES * GR_STAGE_BYTES;
constexpr int GR_DQ_OFF = GR_DL_OFF + 2 * BWD_CHUNK;
constexpr int GR_BAR_OFF = GR_DQ_OFF + 2 * 64 * HD * 4;
constexpr int GR_SMEM = GR_BAR_OFF + (1 + 2 * BWD_STAGES) * 8 + 1024;

struct BwdArgs {
  float *m, *den, *r;  // (B, H, S) row statistics
  bf16* g_n;           // (B, S, H, 64) bf16(g / den)
  float* dq_acc;       // (B, H, ceil(S / 64), 64 x 64) f32, zeroed
  bf16 *dq, *dk, *dv;  // (B, S, H, 64)
  int S, H;
  float scale, scale_log2;
  float* dl_abs;       // (B, H, S) f32, V5's sum |dl| a row
};

// ------------------------------------------------------------ statistics

// g_n = bf16(g / den) of row `tr` of a swizzled 64-row G tile, this
// thread's quarter of it (two 16-byte chunks) to `dst`, the row in the
// (B, S, H, 64) output.
__device__ __forceinline__ void store_g_n(bf16* dst,
                                          const unsigned char* g_tile,
                                          int tr, int quad, float den) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 2 * quad + half;  // 16-byte chunk of the row
    const uint4 raw = *reinterpret_cast<const uint4*>(
        g_tile + tr * ROW_BYTES + ((c ^ (tr & 7)) * 16));
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 outv;
    uint32_t* o32 = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(in[e]);
      o32[e] = pack_bf16(f.x / den, f.y / den);
    }
    *reinterpret_cast<uint4*>(dst + 8 * c) = outv;
  }
}

// The ring of the query-major passes (statistics, V1's statistics, V2's
// dq rows): the block's Q and G tiles, two stages of a 128-key K and V
// chunk, and their barriers at ST_BAR_OFF (qg_full, k_full[2],
// v_full[2], empty[2]; each stage freed by both consumer warpgroups).
struct RowRing {
  uint64_t *qg_full, *k_full, *v_full, *empty;
};

// The barriers of `smem`'s ring, initialised by thread 0 before any
// thread of the block goes on.
__device__ __forceinline__ RowRing row_ring_init(unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ST_BAR_OFF);
  const RowRing ring = {bars, bars + 1, bars + 1 + BWD_STAGES,
                        bars + 1 + 2 * BWD_STAGES};
  if (threadIdx.x == 0) {
    mbar_init(ring.qg_full, 1);
    for (int st = 0; st < BWD_STAGES; ++st) {
      mbar_init(ring.k_full + st, 1);
      mbar_init(ring.v_full + st, 1);
      mbar_init(ring.empty + st, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return ring;
}

// The producer thread: the Q tile (and the G tile where G) of rows q0..,
// then each 128-key chunk of K (and V where V) into the next free stage.
template <bool G = true, bool V = true>
__device__ __forceinline__ void row_ring_load(
    unsigned char* smem, const RowRing& ring, const CUtensorMap* q_map,
    const CUtensorMap* g_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, int h, int q0, int b, int n_chunks) {
  mbar_expect_tx(ring.qg_full, (G ? 2 : 1) * BWD_TILE);
  tma_load(smem, q_map, ring.qg_full, h, q0, b);
  if constexpr (G) tma_load(smem + BWD_TILE, g_map, ring.qg_full, h, q0, b);
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j % BWD_STAGES;
    if (j >= BWD_STAGES) {
      mbar_wait(ring.empty + st, (j / BWD_STAGES - 1) & 1);
    }
    unsigned char* kv = smem + ST_KV_OFF + st * 2 * BWD_TILE;
    mbar_expect_tx(ring.k_full + st, BWD_TILE);
    tma_load(kv, k_map, ring.k_full + st, h, j * 128, b);
    if constexpr (V) {
      mbar_expect_tx(ring.v_full + st, BWD_TILE);
      tma_load(kv + BWD_TILE, v_map, ring.v_full + st, h, j * 128, b);
    }
  }
}

// The statistics pass; under DP = false (V5) dp is the scaled scores
// s scale, not G V^T: no V in the ring, no dp product.
template <class Tag, bool DP = true>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_attention_bwd_stats_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap g_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 BwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int S = args.S, H = args.H;
  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + 127) / 128;
  const RowRing ring = row_ring_init(smem);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      row_ring_load<true, DP>(smem, ring, &q_map, &g_map, &k_map, &v_map, h,
                              q0, b, n_chunks);
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  const int quad = lane % 4;
  const uint32_t q_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  [[maybe_unused]] const uint32_t g_addr = q_addr + BWD_TILE;
  const float c2 = args.scale_log2;

  float m[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.0f, 0.0f}, num[2] = {0.0f, 0.0f};
  mbar_wait(ring.qg_full, 0);
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j % BWD_STAGES;
    const int parity = (j / BWD_STAGES) & 1;
    const uint32_t k_addr = smem_u32(smem + ST_KV_OFF + st * 2 * BWD_TILE);
    [[maybe_unused]] const uint32_t v_addr = k_addr + BWD_TILE;

    float s[64], dp[64];
    mbar_wait(ring.k_full + st, parity);
    if constexpr (DP) mbar_wait(ring.v_full + st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                          desc_sw128(k_addr + kk * 32), kk > 0);
    }
    if constexpr (DP) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss_n128<0, 0>(dp, desc_sw128(g_addr + kk * 32),
                            desc_sw128(v_addr + kk * 32), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    if constexpr (DP) fence_regs(dp);
    mbar_arrive(ring.empty + st);

    const int kv = S - j * 128;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
      if constexpr (!DP) dp[i] = s[i] * args.scale;
      s[i] = col < kv ? s[i] * c2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2], m_use[2], usum[2] = {0.0f, 0.0f}, dsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_use[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
      corr[r] = fast_exp2(m[r] - m_use[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float u = fast_exp2(s[i] - m_use[(i >> 1) & 1]);
      usum[(i >> 1) & 1] += u;
      dsum[(i >> 1) & 1] += dp[i] * u;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] = den[r] * corr[r] + usum[r];
      num[r] = num[r] * corr[r] + dsum[r];
    }
  }

  // m (in units of s), den and r of the rows below S; g_n = bf16(g / den).
  const size_t ld = static_cast<size_t>(H) * HD;
  const size_t stat_row = (static_cast<size_t>(b) * H + h) * S;
  const unsigned char* g_tile = smem + BWD_TILE + cw * 64 * ROW_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    num[r] += __shfl_xor_sync(0xffffffffu, num[r], 1);
    num[r] += __shfl_xor_sync(0xffffffffu, num[r], 2);
    const int tr = row + 8 * r;  // row in the warpgroup's 64
    const int q = q0 + cw * 64 + tr;
    if (q >= S) continue;
    if (quad == 0) {
      args.m[stat_row + q] = m[r] / LOG2E;
      args.den[stat_row + q] = den[r];
      args.r[stat_row + q] = num[r] / den[r];
    }
    store_g_n(args.g_n + (static_cast<size_t>(b) * S + q) * ld + h * HD,
              g_tile, tr, quad, den[r]);
  }
}

// u = 2^(s c2 - mc) of one 128-key chunk's scores in place on the
// thread's two rows, 0 for keys at or past `kv`; adds u to `den`.
__device__ __forceinline__ void exp_chunk(float (&s)[64], int kv, int quad,
                                          float c2, const float (&mc)[2],
                                          float (&den)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
    s[i] = col < kv ? fast_exp2(fmaf(s[i], c2, -mc[(i >> 1) & 1])) : 0.0f;
    den[(i >> 1) & 1] += s[i];
  }
}

// The statistics of the tuning kernel V1 (attention_bwd_variants.cu):
// r from the recomputed output, o_rec = (bf16(u) V) / den and
// r = sum(g * o_rec), where K4's pass takes sum(dp * u) / den. The block,
// its Q and G tiles and the two-stage K/V ring are K4's; the keys are
// swept twice:
//   1. s = Q K^T (m64n128k16 from shared memory, K alone in the ring) for
//      the exact row max m;
//   2. s = Q K^T again, u = 2^(s c2 - m c2) against the final m, den =
//      sum(u) in f32, and o_rec += bf16(u) V_c on wgmma with A from
//      registers (eight m64n64k16, V MN-major), the next chunk's s issued
//      with this chunk's P V and its exps run while P V does (the
//      forward's overlap; no rescale, m is final).
// Then r = sum over the row's 64 columns of g * (o_rec / den), g read
// from the G tile. m, den and r go to the (3, B, H, S) workspace in K4's
// units (m in units of s), g_n = bf16(g / den) to its workspace, so K4's
// gradient and dq passes run on them unchanged. Three S x S x 64 walks.
template <class Tag>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_attention_bwd_stats_from_output_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap g_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, BwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int S = args.S, H = args.H;
  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + 127) / 128;
  const RowRing ring = row_ring_init(smem);
  uint64_t* qg_full = ring.qg_full;
  uint64_t* k_full = ring.k_full;
  uint64_t* v_full = ring.v_full;
  uint64_t* empty = ring.empty;
  const int wg = threadIdx.x / 128;

  // Ring step `it` holds chunk it of sweep 1 (K) or chunk it - n_chunks of
  // sweep 2 (K and V). The stages alternate, so the jj-th chunk of sweep 2
  // is the (jj / 2)-th V a stage has taken.
  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qg_full, 2 * BWD_TILE);
      tma_load(smem, &q_map, qg_full, h, q0, b);
      tma_load(smem + BWD_TILE, &g_map, qg_full, h, q0, b);
      for (int it = 0; it < 2 * n_chunks; ++it) {
        const int st = it % BWD_STAGES;
        const int j = it < n_chunks ? it : it - n_chunks;
        if (it >= BWD_STAGES) {
          mbar_wait(empty + st, (it / BWD_STAGES - 1) & 1);
        }
        unsigned char* kv = smem + ST_KV_OFF + st * 2 * BWD_TILE;
        mbar_expect_tx(k_full + st, BWD_TILE);
        tma_load(kv, &k_map, k_full + st, h, j * 128, b);
        if (it >= n_chunks) {
          mbar_expect_tx(v_full + st, BWD_TILE);
          tma_load(kv + BWD_TILE, &v_map, v_full + st, h, j * 128, b);
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  const int quad = lane % 4;
  const uint32_t q_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  const uint32_t kv_base = smem_u32(smem + ST_KV_OFF);
  const float c2 = args.scale_log2;
  float s[64];

  // Sweep 1: the exact row max of the unscaled scores.
  float mx[2] = {-INFINITY, -INFINITY};
  mbar_wait(qg_full, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int st = it % BWD_STAGES;
    const uint32_t k_addr = kv_base + st * 2 * BWD_TILE;
    mbar_wait(k_full + st, (it / BWD_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                          desc_sw128(k_addr + kk * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty + st);
    const int kv = S - it * 128;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
      if (col < kv) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  }
  float mc[2];  // m c2, the max in the exponent's units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mc[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * c2;
  }

  // Sweep 2: u against the final max, den, and o_rec = bf16(u) V.
  float o[32], den[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  uint32_t pa[8][4];
  int it = n_chunks;
  int st = it % BWD_STAGES;
  mbar_wait(k_full + st, (it / BWD_STAGES) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                        desc_sw128(kv_base + st * 2 * BWD_TILE + kk * 32),
                        kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  exp_chunk(s, S, quad, c2, mc, den);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
  // Chunk jj's scores issued with chunk jj - 1's P V, its exps while P V
  // runs; the waits come before the products.
  for (int jj = 1; jj < n_chunks; ++jj) {
    const int prev = st;
    ++it;
    st = it % BWD_STAGES;
    mbar_wait(v_full + prev, ((jj - 1) / BWD_STAGES) & 1);
    mbar_wait(k_full + st, (it / BWD_STAGES) & 1);
    const uint32_t k_addr = kv_base + st * 2 * BWD_TILE;
    const uint32_t v_addr = kv_base + prev * 2 * BWD_TILE + BWD_TILE;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                          desc_sw128(k_addr + kk * 32), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      wgmma_rs_n64<1>(o, pa[k], desc_sw128(v_addr + k * 16 * ROW_BYTES), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    exp_chunk(s, S - jj * 128, quad, c2, mc, den);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + prev);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
  }
  {
    const uint32_t v_addr = kv_base + st * 2 * BWD_TILE + BWD_TILE;
    mbar_wait(v_full + st, ((n_chunks - 1) / BWD_STAGES) & 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      wgmma_rs_n64<1>(o, pa[k], desc_sw128(v_addr + k * 16 * ROW_BYTES), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + st);
  }

  // r = sum(g * o_rec / den) over the row's 64 columns; m (in units of
  // s), den and r of the rows below S; g_n = bf16(g / den).
  const size_t ld = static_cast<size_t>(H) * HD;
  const size_t stat_row = (static_cast<size_t>(b) * H + h) * S;
  const unsigned char* g_tile = smem + BWD_TILE + cw * 64 * ROW_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    const int tr = row + 8 * r;  // row in the warpgroup's 64
    float num = 0.0f;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              g_tile + tr * ROW_BYTES + ((j8 ^ (tr & 7)) * 16) + quad * 4));
      num += g.x * (o[4 * j8 + 2 * r] / den[r]);
      num += g.y * (o[4 * j8 + 2 * r + 1] / den[r]);
    }
    num += __shfl_xor_sync(0xffffffffu, num, 1);
    num += __shfl_xor_sync(0xffffffffu, num, 2);
    const int q = q0 + cw * 64 + tr;
    if (q >= S) continue;
    if (quad == 0) {
      args.m[stat_row + q] = mc[r] / LOG2E;
      args.den[stat_row + q] = den[r];
      args.r[stat_row + q] = num;
    }
    store_g_n(args.g_n + (static_cast<size_t>(b) * S + q) * ld + h * HD,
              g_tile, tr, quad, den[r]);
  }
}

// -------------------------------------------------------------- gradients

// The gradient pass's chain: a chunk's s^T and dp^T (this thread's 32
// elements of a m64n64 accumulator: two key rows, query columns c) to u
// and dl in place. K4's: u = 2^(s c2 - m log2 e) against the chunk's
// staged statistics (0 for keys past S) and dl = u (dp - r) scale / den.
struct SoftmaxChain {
  static constexpr bool kStats = true;  // the producer stages statistics
  __device__ __forceinline__ static void apply(float (&s)[32],
                                               float (&dp)[32],
                                               const float* stats,
                                               const bool (&key_in)[2],
                                               int quad, float c2) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 8 * (e >> 2) + 2 * quad + (e & 1);
      const float u = key_in[(e >> 1) & 1]
                          ? fast_exp2(fmaf(s[e], c2, -stats[c])) : 0.0f;
      s[e] = u;
      dp[e] = u * (dp[e] - stats[128 + c]) * stats[64 + c];
    }
  }
};

// V4's casts: u = s (0 for keys past S) and dl = s dp, the unscaled
// scores; no exp, no statistics.
struct CastChain {
  static constexpr bool kStats = false;
  __device__ __forceinline__ static void apply(float (&s)[32],
                                               float (&dp)[32], const float*,
                                               const bool (&key_in)[2], int,
                                               float) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float u = key_in[(e >> 1) & 1] ? s[e] : 0.0f;
      s[e] = u;
      dp[e] = u * dp[e];
    }
  }
};

// The gradient pass; under DQ = false (V3) it forms dk and dv alone: no
// dl^T tile, no dq product, staging or reduce-add. `Chain` forms u and
// dl (SoftmaxChain, or V4's CastChain, whose producer stages no
// statistics and whose g_n map reads g itself).
template <class Tag, bool DQ = true, class Chain = SoftmaxChain>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_attention_bwd_grad_kernel(const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap g_map,
                                const __grid_constant__ CUtensorMap gn_map,
                                BwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int S = args.S, H = args.H;
  const int k0 = blockIdx.x * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_q = (S + 63) / 64;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + GR_BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + BWD_STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < BWD_STAGES; ++st) {
      // The TMA arrival and one from each lane of the producer warp, which
      // stages the chunk's statistics.
      mbar_init(full + st, 1 + 32);
      mbar_init(empty + st, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      [[maybe_unused]] const size_t stat_row =
          (static_cast<size_t>(b) * H + h) * S;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * BWD_TILE);
        tma_load(smem, &k_map, kv_full, h, k0, b);
        tma_load(smem + BWD_TILE, &v_map, kv_full, h, k0, b);
      }
      for (int i = 0; i < n_q; ++i) {
        const int st = i % BWD_STAGES;
        if (i >= BWD_STAGES) mbar_wait(empty + st, (i / BWD_STAGES - 1) & 1);
        unsigned char* stage = smem + GR_RING_OFF + st * GR_STAGE_BYTES;
        if (lane == 0) {
          mbar_expect_tx(full + st, 3 * BWD_CHUNK);
          tma_load(stage, &q_map, full + st, h, i * 64, b);
          tma_load(stage + BWD_CHUNK, &g_map, full + st, h, i * 64, b);
          tma_load(stage + 2 * BWD_CHUNK, &gn_map, full + st, h, i * 64, b);
        }
        if constexpr (Chain::kStats) {
          float* stats = reinterpret_cast<float*>(stage + 3 * BWD_CHUNK);
#pragma unroll
          for (int e = lane; e < 64; e += 32) {
            const int q = i * 64 + e;
            const bool in = q < S;
            stats[e] = in ? args.m[stat_row + q] * LOG2E : INFINITY;
            stats[64 + e] = in ? args.scale / args.den[stat_row + q] : 0.0f;
            stats[128 + e] = in ? args.r[stat_row + q] : 0.0f;
          }
        }
        mbar_arrive(full + st);
      }
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // key row (and row + 8)
  const int quad = lane % 4;
  const uint32_t k_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  const uint32_t v_addr = k_addr + BWD_TILE;
  // The dl^T tile and dq staging (unused under DQ = false).
  [[maybe_unused]] unsigned char* dl_tile =
      smem + GR_DL_OFF + cw * BWD_CHUNK;
  [[maybe_unused]] const uint32_t dl_addr = smem_u32(dl_tile);
  [[maybe_unused]] float* dq_stage =
      reinterpret_cast<float*>(smem + GR_DQ_OFF) + cw * 64 * HD;
  const float c2 = args.scale_log2;
  bool key_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_in[r] = k0 + cw * 64 + row + 8 * r < S;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_q; ++i) {
    const int st = i % BWD_STAGES;
    unsigned char* stage = smem + GR_RING_OFF + st * GR_STAGE_BYTES;
    const uint32_t q_addr = smem_u32(stage);
    const uint32_t g_addr = q_addr + BWD_CHUNK;
    const uint32_t gn_addr = q_addr + 2 * BWD_CHUNK;
    const float* stats = reinterpret_cast<const float*>(stage + 3 * BWD_CHUNK);

    // s^T = K Q^T and dp^T = V G^T: rows are this warpgroup's keys,
    // columns the chunk's queries.
    float s[32], dp[32];
    mbar_wait(full + st, (i / BWD_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n64<0, 0>(s, desc_sw128(k_addr + kk * 32),
                         desc_sw128(q_addr + kk * 32), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n64<0, 0>(dp, desc_sw128(v_addr + kk * 32),
                         desc_sw128(g_addr + kk * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // u and dl in place (K4: u = exp(s - m), dl = u (dp - r) scale / den).
    Chain::apply(s, dp, stats, key_in, quad, c2);
    uint32_t ua[4][4], dla[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc_to_a(s, k, ua[k]);
      acc_to_a(dp, k, dla[k]);
      fence_regs(ua[k]);
      fence_regs(dla[k]);
    }
    fence_regs(dv);
    fence_regs(dk);

    // dv += bf16(u)^T g_n and dk += dl^T q: B is the chunk's rows read
    // MN-major, 16 queries (2048 bytes) a step.
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_rs_n64<1>(dv, ua[k], desc_sw128(gn_addr + k * 16 * ROW_BYTES), 1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_rs_n64<1>(dk, dla[k], desc_sw128(q_addr + k * 16 * ROW_BYTES), 1);
    }
    wgmma_commit();

    [[maybe_unused]] float dq[32];
    if constexpr (DQ) {
      // dl^T as a swizzled [key][query] tile: the transposed A of dq.
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int tr = row + 8 * rr;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int chunk = 2 * k + half;  // 8-query group
            *reinterpret_cast<uint32_t*>(dl_tile + tr * ROW_BYTES +
                                         ((chunk ^ (tr & 7)) * 16) +
                                         quad * 4) = dla[k][2 * half + rr];
          }
        }
      }
      fence_proxy_async();
      // The previous chunk's reduce has read the dq staging once this
      // barrier passes.
      if (tid == 0) bulk_wait_read();
      named_barrier(1 + cw, 128);

      // dq_part = dl K: A = dl^T tile and B = K, both MN-major.
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss_n64<1, 1>(dq, desc_sw128(dl_addr + k * 16 * ROW_BYTES),
                           desc_sw128(k_addr + k * 16 * ROW_BYTES), k > 0);
      }
      wgmma_commit();
    }
    // Waits for dv and dk too (and dq where DQ).
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if constexpr (DQ) fence_regs(dq);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fence_regs(ua[k]);
      fence_regs(dla[k]);
    }
    mbar_arrive(empty + st);

    if constexpr (DQ) {
      // Stage dq_part as a row-major 64 x 64 f32 tile, 32-byte chunk c of
      // row r at chunk c ^ (r % 8) (no bank conflicts), and add it to the
      // workspace in one bulk reduce.
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = row + 8 * ((e >> 1) & 1);
        *reinterpret_cast<float2*>(dq_stage + r * HD +
                                   (((e >> 2) ^ (r & 7)) * 8) + 2 * quad) =
            make_float2(dq[e], dq[e + 1]);
      }
      fence_proxy_async();
      named_barrier(1 + cw, 128);
      if (tid == 0) {
        bulk_reduce_add_f32(args.dq_acc + ((static_cast<size_t>(b) * H + h) *
                                               n_q + i) * 64 * HD,
                            dq_stage, 64 * HD * 4);
      }
    }
  }
  if constexpr (DQ) {
    if (tid == 0) bulk_wait();
  }

  // dk and dv of the keys below S.
  const size_t ld = static_cast<size_t>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_in[r]) continue;
    const size_t off =
        (static_cast<size_t>(b) * S + k0 + cw * 64 + row + 8 * r) * ld +
        h * HD;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int e = 4 * j8 + 2 * r;
      *reinterpret_cast<uint32_t*>(args.dk + off + 8 * j8 + 2 * quad) =
          pack_bf16(dk[e], dk[e + 1]);
      *reinterpret_cast<uint32_t*>(args.dv + off + 8 * j8 + 2 * quad) =
          pack_bf16(dv[e], dv[e + 1]);
    }
  }
}

// --------------------------------------------------------------------- dq

// dq = bf16(dq_acc): each thread 8 neighbouring columns of one row. The
// workspace holds each (head, 64-query chunk) as the gradient pass staged
// it: a row-major 64 x 64 f32 tile, 32-byte chunk c of row r at chunk
// c ^ (r % 8).
template <class Tag>
__global__ void flash_attention_bwd_dq_kernel(BwdArgs args, int batch) {
  const int S = args.S, H = args.H;
  const int n_q = (S + 63) / 64;
  const size_t items = static_cast<size_t>(batch) * H * n_q * 512;
  for (size_t p = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       p < items; p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t tile = p / 512;
    const int c = static_cast<int>(p % 8);
    const int row = static_cast<int>(p / 8 % 64);
    const int q = static_cast<int>(tile % n_q) * 64 + row;
    if (q >= S) continue;
    const float* src =
        args.dq_acc + tile * 64 * HD + row * HD + ((c ^ (row & 7)) * 8);
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 d = *reinterpret_cast<const float4*>(src + 4);
    uint4 outv;
    outv.x = pack_bf16(a.x, a.y);
    outv.y = pack_bf16(a.z, a.w);
    outv.z = pack_bf16(d.x, d.y);
    outv.w = pack_bf16(d.z, d.w);
    const size_t bh = tile / n_q;
    const size_t b = bh / H, h = bh % H;
    *reinterpret_cast<uint4*>(args.dq + ((b * S + q) * H + h) * HD + 8 * c) =
        outv;
  }
}

// ---------------------------------------------------------------- dq rows

// V2's dq (attention_bwd_variants.cu) behind the statistics pass: one
// block per (128-row query tile, head, image), the statistics pass's
// tiles and ring; each consumer warpgroup keeps its 64 rows' dq in
// registers. Per 128-key chunk: s = Q K^T and dp = G V^T (four
// m64n128k16 each from shared memory), u = 2^(s c2 - m log2 e) (0 for
// keys past S), dl = u (dp - r) scale / den in place, dl packed to bf16
// A fragments, dq += dl K_c (eight m64n64k16, K read MN-major). The
// stage is freed once the dq product has read it. Three walks; dq is
// summed chunk by chunk in one order, so a call gives the same bits as
// the last.
template <class Tag>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_attention_bwd_rows_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap g_map,
                                   const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap v_map,
                                   BwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int S = args.S, H = args.H;
  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + 127) / 128;
  const RowRing ring = row_ring_init(smem);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      row_ring_load(smem, ring, &q_map, &g_map, &k_map, &v_map, h, q0, b,
                    n_chunks);
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  const int quad = lane % 4;
  const uint32_t q_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  const uint32_t g_addr = q_addr + BWD_TILE;
  const float c2 = args.scale_log2;

  // The rows' m log2 e, scale / den and r, once; rows past S take +inf,
  // 0 and 0, so their u and dl are 0.
  const size_t stat_row = (static_cast<size_t>(b) * H + h) * S;
  float mc[2], dsc[2], rr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + cw * 64 + row + 8 * r;
    const bool in = q < S;
    mc[r] = in ? args.m[stat_row + q] * LOG2E : INFINITY;
    dsc[r] = in ? args.scale / args.den[stat_row + q] : 0.0f;
    rr[r] = in ? args.r[stat_row + q] : 0.0f;
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  mbar_wait(ring.qg_full, 0);
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j % BWD_STAGES;
    const int parity = (j / BWD_STAGES) & 1;
    const uint32_t k_addr = smem_u32(smem + ST_KV_OFF + st * 2 * BWD_TILE);
    const uint32_t v_addr = k_addr + BWD_TILE;

    float s[64], dp[64];
    mbar_wait(ring.k_full + st, parity);
    mbar_wait(ring.v_full + st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                          desc_sw128(k_addr + kk * 32), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n128<0, 0>(dp, desc_sw128(g_addr + kk * 32),
                          desc_sw128(v_addr + kk * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dl = u (dp - r) scale / den in place, 0 for keys past S.
    const int kv = S - j * 128;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
      const int r = (i >> 1) & 1;
      const float u = col < kv ? fast_exp2(fmaf(s[i], c2, -mc[r])) : 0.0f;
      dp[i] = u * (dp[i] - rr[r]) * dsc[r];
    }
    uint32_t dla[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc_to_a(dp, k, dla[k]);
      fence_regs(dla[k]);
    }

    // dq += dl K_c: B is the chunk's keys read MN-major, 16 keys (2048
    // bytes) a step.
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      wgmma_rs_n64<1>(dq, dla[k], desc_sw128(k_addr + k * 16 * ROW_BYTES), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int k = 0; k < 8; ++k) fence_regs(dla[k]);
    mbar_arrive(ring.empty + st);
  }

  // dq of the rows below S.
  const size_t ld = static_cast<size_t>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + cw * 64 + row + 8 * r;
    if (q >= S) continue;
    bf16* dst = args.dq + (static_cast<size_t>(b) * S + q) * ld + h * HD;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j8 + 2 * quad) =
          pack_bf16(dq[4 * j8 + 2 * r], dq[4 * j8 + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- dl sweep

// V5's dl (attention_bwd_variants.cu) behind its statistics pass (DP =
// false): one block per (128-row query tile, head, image), the
// statistics pass's block and ring with the Q tile and K alone. Per
// 128-key chunk: s = Q K^T (four m64n128k16 from shared memory), u =
// 2^(s c2 - m log2 e) against the final max (0 for keys past S), dl =
// u (s scale - r) scale / den in place, |dl| summed a row. Chunk 0's
// first 64 columns give dq = bf16(q + bf16(dl)) at once, q read from the
// Q tile; after the sweep each row's sum |dl| goes to dl_abs and dk = k
// is copied for the block's rows (k read from device memory). One walk.
template <class Tag>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_attention_bwd_dl_sweep_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const bf16* __restrict__ k,
                                    BwdArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int S = args.S, H = args.H;
  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + 127) / 128;
  const RowRing ring = row_ring_init(smem);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      row_ring_load<false, false>(smem, ring, &q_map, nullptr, &k_map,
                                  nullptr, h, q0, b, n_chunks);
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  const int quad = lane % 4;
  const unsigned char* q_tile = smem + cw * 64 * ROW_BYTES;
  const uint32_t q_addr = smem_u32(q_tile);
  const float c2 = args.scale_log2, scale = args.scale;
  const size_t ld = static_cast<size_t>(H) * HD;

  // The rows' m log2 e, scale / den and r, once; rows past S take +inf,
  // 0 and 0, so their u and dl are 0.
  const size_t stat_row = (static_cast<size_t>(b) * H + h) * S;
  float mc[2], dsc[2], rr[2], dl_abs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + cw * 64 + row + 8 * r;
    const bool in = q < S;
    mc[r] = in ? args.m[stat_row + q] * LOG2E : INFINITY;
    dsc[r] = in ? scale / args.den[stat_row + q] : 0.0f;
    rr[r] = in ? args.r[stat_row + q] : 0.0f;
  }

  mbar_wait(ring.qg_full, 0);
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j % BWD_STAGES;
    const uint32_t k_addr = smem_u32(smem + ST_KV_OFF + st * 2 * BWD_TILE);
    float s[64];
    mbar_wait(ring.k_full + st, (j / BWD_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                          desc_sw128(k_addr + kk * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    mbar_arrive(ring.empty + st);

    // dl = u (s scale - r) scale / den in place, 0 for keys past S.
    const int kv = S - j * 128;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
      const int r = (i >> 1) & 1;
      const float u = col < kv ? fast_exp2(fmaf(s[i], c2, -mc[r])) : 0.0f;
      s[i] = u * (s[i] * scale - rr[r]) * dsc[r];
      dl_abs[r] += fabsf(s[i]);
    }
    if (j > 0) continue;
    // dq = bf16(q + bf16(dl)) of the first 64 keys' columns (S >= 64).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tr = row + 8 * r;  // row in the warpgroup's 64
      const int q = q0 + cw * 64 + tr;
      if (q >= S) continue;
      bf16* dst = args.dq + (static_cast<size_t>(b) * S + q) * ld + h * HD;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const float2 qv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                q_tile + tr * ROW_BYTES + ((j8 ^ (tr & 7)) * 16) + quad * 4));
        const int e = 4 * j8 + 2 * r;
        *reinterpret_cast<uint32_t*>(dst + 8 * j8 + 2 * quad) = pack_bf16(
            qv.x + __bfloat162float(__float2bfloat16(s[e])),
            qv.y + __bfloat162float(__float2bfloat16(s[e + 1])));
      }
    }
  }

  // Each row's sum |dl| over all keys, then dk = k for the block's rows
  // (64 rows of 8 16-byte chunks a warpgroup).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl_abs[r] += __shfl_xor_sync(0xffffffffu, dl_abs[r], 1);
    dl_abs[r] += __shfl_xor_sync(0xffffffffu, dl_abs[r], 2);
    const int q = q0 + cw * 64 + row + 8 * r;
    if (q < S && quad == 0) args.dl_abs[stat_row + q] = dl_abs[r];
  }
  for (int c = tid; c < 64 * 8; c += 128) {
    const int q = q0 + cw * 64 + c / 8;
    if (q >= S) continue;
    const size_t off =
        (static_cast<size_t>(b) * S + q) * ld + h * HD + 8 * (c % 8);
    *reinterpret_cast<uint4*>(args.dk + off) =
        *reinterpret_cast<const uint4*>(k + off);
  }
}

// The passes a launch runs:
//   kK4          statistics, gradient, dq cast: dq, dk, dv (K4, K2);
//   kFromOutput  V1's statistics from the output, then as kK4;
//   kRowsDq      statistics, the query-major dq rows: dq alone (V2);
//   kDkDv        statistics, the gradient pass without dq: dk, dv (V3);
//   kDotsOnly    the gradient pass under CastChain, dq cast (V4);
//   kVpuOnly     statistics without G V^T, the dl sweep (V5).
// kRowsDq, kDkDv and kVpuOnly take no dq_acc; kRowsDq leaves g_n unread;
// kDotsOnly takes no statistics, and its g_n is g.
enum class BwdPasses { kK4, kFromOutput, kRowsDq, kDkDv, kDotsOnly, kVpuOnly };

// The statistics pass a launch takes: K4's, V1's from the output, or
// V5's without the dp product (none under kDotsOnly).
template <class Tag, BwdPasses P>
inline auto stats_kernel() {
  if constexpr (P == BwdPasses::kFromOutput) {
    return &flash_attention_bwd_stats_from_output_kernel<Tag>;
  } else {
    return &flash_attention_bwd_stats_kernel<Tag, P != BwdPasses::kVpuOnly>;
  }
}

// The pass after the statistics: the gradient pass (with its dq product
// but under kDkDv, V4's chain under kDotsOnly), V2's dq rows or V5's dl
// sweep.
template <class Tag, BwdPasses P>
inline auto second_kernel() {
  if constexpr (P == BwdPasses::kRowsDq) {
    return &flash_attention_bwd_rows_dq_kernel<Tag>;
  } else if constexpr (P == BwdPasses::kVpuOnly) {
    return &flash_attention_bwd_dl_sweep_kernel<Tag>;
  } else if constexpr (P == BwdPasses::kDotsOnly) {
    return &flash_attention_bwd_grad_kernel<Tag, true, CastChain>;
  } else {
    return &flash_attention_bwd_grad_kernel<Tag, P != BwdPasses::kDkDv>;
  }
}

// Launch the passes `P` names on `stream`; returns the first failing
// call's error.
template <class Tag, BwdPasses P = BwdPasses::kK4>
inline cudaError_t launch_flash_backward(const void* q, const void* k,
                                         const void* v, const void* g,
                                         BwdArgs args, int batch,
                                         cudaStream_t stream) {
  // The second pass is query-major (the dq rows, the dl sweep).
  constexpr bool ROWS = P == BwdPasses::kRowsDq || P == BwdPasses::kVpuOnly;
  constexpr bool STATS = P != BwdPasses::kDotsOnly;
  const int S = args.S, H = args.H;
  if (batch < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  CUtensorMap q128, g128, k128, v128, q64, g64, gn64;
  cudaError_t err = cudaSuccess;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rows;
  } maps[] = {{&q128, q, 128}, {&g128, g, 128}, {&k128, k, 128},
              {&v128, v, 128}, {&q64, q, 64},   {&g64, g, 64},
              {&gn64, args.g_n, 64}};
  // The query-major passes read the 128-row maps alone.
  for (int i = 0; i < (ROWS ? 4 : 7); ++i) {
    err = bshd_map(maps[i].map, maps[i].base, batch, S, H, maps[i].rows);
    if (err != cudaSuccess) return err;
  }
  const auto second = second_kernel<Tag, P>();
  constexpr int SECOND_SMEM = ROWS ? ST_SMEM : GR_SMEM;
  static bool smem_set = false;  // once a process
  if (!smem_set) {
    if constexpr (STATS) {
      err = cudaFuncSetAttribute(stats_kernel<Tag, P>(),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ST_SMEM);
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute(second,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SECOND_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((S + 127) / 128, H, batch);
  if constexpr (STATS) {
    const auto stats = stats_kernel<Tag, P>();
    stats<<<grid, BWD_THREADS, ST_SMEM, stream>>>(q128, g128, k128, v128,
                                                  args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (P == BwdPasses::kVpuOnly) {
    second<<<grid, BWD_THREADS, SECOND_SMEM, stream>>>(
        q128, k128, static_cast<const bf16*>(k), args);
  } else if constexpr (ROWS) {
    second<<<grid, BWD_THREADS, SECOND_SMEM, stream>>>(q128, g128, k128,
                                                       v128, args);
  } else {
    second<<<grid, BWD_THREADS, SECOND_SMEM, stream>>>(k128, v128, q64, g64,
                                                       gn64, args);
  }
  err = cudaGetLastError();
  if constexpr (P == BwdPasses::kK4 || P == BwdPasses::kFromOutput ||
                P == BwdPasses::kDotsOnly) {
    if (err != cudaSuccess) return err;
    const size_t items =
        static_cast<size_t>(batch) * H * ((S + 63) / 64) * 512;
    const int blocks = static_cast<int>(
        (items + 255) / 256 < 65535 ? (items + 255) / 256 : 65535);
    flash_attention_bwd_dq_kernel<Tag>
        <<<blocks, 256, 0, stream>>>(args, batch);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
