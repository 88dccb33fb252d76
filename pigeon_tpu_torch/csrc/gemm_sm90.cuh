// A persistent bf16 GEMM on Hopper's wgmma with TMA-fed operands:
//
//     out[m, n] = bf16(sum_k A[m, k] B(k, n) + bias[n])    (f32 sums and bias)
//
// for a row-major bf16 A (M, K) and a bf16 B stored either K-major, (N, K)
// as a torch Linear weight ("A B^T", B_KMAJOR), or MN-major, (K, N)
// ("A B"). Each operand may be up to three row-major matrices laid end to
// end: A, and an MN-major B, along K in segments of `seg_k`; a K-major B,
// the biases and the output along N in segments of `seg_n`. Kernel K2
// (fused_qkv_attention_bwd.cu) runs both forms: its projection
// q|k|v = x [Wq; Wk; Wv]^T + b (N in three segments) and its dx =
// [dq|dk|dv] [Wq; Wk; Wv] (K in three segments, one f32 sum over all
// of them, rounded once).
//
// What bounds it on the H100: at K2's training shape (M = 32 x 577, N or
// K = 3 x 1024, the other 1024) each GEMM is 116 GFLOP over ~190 MB, about
// 600 FLOP per byte: the tensor cores bound it (0.117 ms). The design
// keeps them fed:
//   - output tiles of 128 x BN (BN 256, or 128 where the widths are not
//     multiples of 256), K in 64-wide steps (one 128-byte swizzled row);
//   - a block of 384 threads: a producer warpgroup (40 registers by
//     setmaxnreg) whose first thread streams each step's A tile (128 x 64)
//     and B tile (BN x 64) by TMA through a ring of GEMM_STAGES stages,
//     running ahead across the block's tiles; two consumer warpgroups (232
//     registers) of 64 rows each, whose 64 x BN f32 sums stay in registers:
//     four m64nBNk16 wgmma a step from shared memory, one step's group left
//     in flight while the next step's data is awaited;
//   - a persistent grid, one block an SM, walking the tiles N-fastest: the
//     blocks at work share A's rows, and all of B stays in L2.
// The epilogue adds the bias in f32, rounds once to bf16 and writes the
// rows below M (TMA reads rows past M as zeros).

#pragma once

#include "hopper_sm90.cuh"

namespace {

constexpr int GEMM_BM = 128;      // output rows of a tile (2 x 64)
constexpr int GEMM_BK = 64;       // K a step: one 128-byte row
constexpr int GEMM_STAGES = 4;    // ring depth
constexpr int GEMM_THREADS = 384; // producer + two consumer warpgroups
constexpr int GEMM_A_BYTES = GEMM_BM * ROW_BYTES;  // 16 KB
constexpr int GEMM_MAX_SEGS = 3;

template <int BN>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return GEMM_A_BYTES + BN * ROW_BYTES;
}

// The stages, then the barriers full[STAGES] and empty[STAGES].
template <int BN>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return GEMM_STAGES * gemm_stage_bytes<BN>() + 2 * GEMM_STAGES * 8 + 1024;
}

struct GemmSm90Maps {
  CUtensorMap a[GEMM_MAX_SEGS];  // A's K segments, boxes of 128 rows
  // K-major: B's N segments, boxes of BN rows; MN-major: its K segments,
  // boxes of 64 rows.
  CUtensorMap b[GEMM_MAX_SEGS];
};

struct GemmSm90Args {
  int M, N, K;
  int seg_k, seg_n;
  const bf16* bias[GEMM_MAX_SEGS];  // per N segment, or null
  bf16* out[GEMM_MAX_SEGS];         // per N segment, (M, seg_n)
};

// d (+)= A B on a 64 x BN tile.
template <int BN, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_bn(float (&d)[BN / 2],
                                            uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (BN == 256) {
    wgmma_ss_n256<0, TRANS_B>(d, desc_a, desc_b, accumulate);
  } else {
    wgmma_ss_n128<0, TRANS_B>(d, desc_a, desc_b, accumulate);
  }
}

// `Tag` names the instance, so that each user has a symbol of its own in
// a profile.
template <class Tag, int BN, bool B_KMAJOR>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ GemmSm90Maps maps,
                 GemmSm90Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  constexpr int STAGE = gemm_stage_bytes<BN>();
  const int n_tiles = args.N / BN;
  const int tiles = (args.M + GEMM_BM - 1) / GEMM_BM * n_tiles;
  const int steps = args.K / GEMM_BK;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + GEMM_STAGES * STAGE);
  uint64_t* empty = full + GEMM_STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < GEMM_STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer.
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
        const int m0 = w / n_tiles * GEMM_BM, n0 = w % n_tiles * BN;
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int st = it % GEMM_STAGES;
          if (it >= GEMM_STAGES) {
            mbar_wait(empty + st, (it / GEMM_STAGES - 1) & 1);
          }
          unsigned char* a_dst = smem + st * STAGE;
          unsigned char* b_dst = a_dst + GEMM_A_BYTES;
          const int k0 = ks * GEMM_BK;
          const int ta = k0 / args.seg_k, ka = k0 - ta * args.seg_k;
          mbar_expect_tx(full + st, STAGE);
          tma_load_2d(a_dst, &maps.a[ta], full + st, ka, m0);
          if constexpr (B_KMAJOR) {
            const int tb = n0 / args.seg_n;
            tma_load_2d(b_dst, &maps.b[tb], full + st, k0,
                        n0 - tb * args.seg_n);
          } else {
            // BN / 64 tiles of 64 rows (k) by 64 columns (n), side by side.
            for (int j = 0; j < BN / 64; ++j) {
              tma_load_2d(b_dst + j * 64 * ROW_BYTES, &maps.b[ta], full + st,
                          n0 + 64 * j, ka);
            }
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup cw: rows 64 cw .. + 63 of each tile.
  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  const int quad = lane % 4;
  const uint32_t base = smem_u32(smem);
  float acc[BN / 2];

  int it = 0;
  for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
    const int m0 = w / n_tiles * GEMM_BM, n0 = w % n_tiles * BN;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int st = it % GEMM_STAGES;
      const uint32_t a_addr = base + st * STAGE + cw * 64 * ROW_BYTES;
      const uint32_t b_addr = base + st * STAGE + GEMM_A_BYTES;
      mbar_wait(full + st, (it / GEMM_STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
        // K-major B: +32 bytes within its rows a k16 step. MN-major: 16 of
        // its rows, the 64-wide tiles 64 rows apart.
        const uint64_t desc_b =
            B_KMAJOR ? desc_sw128(b_addr + kk * 32)
                     : desc_sw128(b_addr + kk * 16 * ROW_BYTES,
                                  64 * ROW_BYTES);
        wgmma_ss_bn<BN, B_KMAJOR ? 0 : 1>(
            acc, desc_sw128(a_addr + kk * 32), desc_b, ks > 0 || kk > 0);
      }
      wgmma_commit();
      // The previous step's products are done: free its stage.
      wgmma_wait<1>();
      fence_regs(acc);
      if (ks > 0) mbar_arrive(empty + (it - 1) % GEMM_STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + (it - 1) % GEMM_STAGES);

    // out = bf16(acc + bias) on the rows below M.
    // The segment by selects: a run-time index into the parameter's
    // arrays would copy them to the stack.
    const int t = n0 / args.seg_n;
    const int n_local = n0 - t * args.seg_n;
    const bf16* bias =
        t == 0 ? args.bias[0] : t == 1 ? args.bias[1] : args.bias[2];
    bf16* out = t == 0 ? args.out[0] : t == 1 ? args.out[1] : args.out[2];
    const int m = m0 + cw * 64 + row;
    bf16* dst = out + static_cast<size_t>(m) * args.seg_n + n_local;
    const bool in[2] = {m < args.M, m + 8 < args.M};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      float2 b2 = make_float2(0.0f, 0.0f);
      if (bias != nullptr) {
        b2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + n_local + c));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        *reinterpret_cast<uint32_t*>(
            dst + static_cast<size_t>(8 * r) * args.seg_n + c) =
            pack_bf16(acc[4 * j + 2 * r] + b2.x, acc[4 * j + 2 * r + 1] + b2.y);
      }
    }
  }
}

template <class Tag, int BN, bool B_KMAJOR>
inline cudaError_t launch_gemm_sm90(const GemmSm90Maps& maps,
                                    const GemmSm90Args& args,
                                    cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;  // once a process
  if (!smem_set) {
    err = cudaFuncSetAttribute(gemm_sm90_kernel<Tag, BN, B_KMAJOR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gemm_smem_bytes<BN>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long tiles =
      static_cast<long>((args.M + GEMM_BM - 1) / GEMM_BM) * (args.N / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_sm90_kernel<Tag, BN, B_KMAJOR>
      <<<grid, GEMM_THREADS, gemm_smem_bytes<BN>(), stream>>>(maps, args);
  return cudaGetLastError();
}

// out = A B^T (B_KMAJOR: b[i] is (seg_n, K), N = segments x seg_n) or
// A B (b[i] is (seg_k, N), K = segments x seg_k) on `stream`; a[i] is
// (M, seg_k), out[i] (M, seg_n) and bias[i] (seg_n,) or null, all bf16,
// row-major, contiguous, 16-byte aligned. seg_n a multiple of 128 and of
// N's tile, seg_k of 64. Returns the first failing call's error.
template <class Tag, bool B_KMAJOR>
inline cudaError_t gemm_sm90(const bf16* const* a, const bf16* const* b,
                             const bf16* const* bias, bf16* const* out,
                             int M, int N, int K, int seg_k, int seg_n,
                             cudaStream_t stream) {
  if (M < 1 || seg_k < GEMM_BK || seg_k % GEMM_BK || seg_n < 128 ||
      seg_n % 128 || K % seg_k || N % seg_n ||
      K / seg_k > GEMM_MAX_SEGS || N / seg_n > GEMM_MAX_SEGS) {
    return cudaErrorInvalidValue;
  }
  const int bn = seg_n % 256 == 0 ? 256 : 128;
  GemmSm90Maps maps = {};
  GemmSm90Args args = {};
  args.M = M;
  args.N = N;
  args.K = K;
  args.seg_k = seg_k;
  args.seg_n = seg_n;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < K / seg_k; ++i) {
    err = rowmajor_map(&maps.a[i], a[i], M, seg_k, GEMM_BM);
    if (err != cudaSuccess) return err;
    if (!B_KMAJOR) err = rowmajor_map(&maps.b[i], b[i], seg_k, N, 64);
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < N / seg_n; ++i) {
    if (B_KMAJOR) err = rowmajor_map(&maps.b[i], b[i], seg_n, K, bn);
    if (err != cudaSuccess) return err;
    args.bias[i] = bias == nullptr ? nullptr : bias[i];
    args.out[i] = out[i];
  }
  return bn == 256 ? launch_gemm_sm90<Tag, 256, B_KMAJOR>(maps, args, stream)
                   : launch_gemm_sm90<Tag, 128, B_KMAJOR>(maps, args, stream);
}

}  // namespace
