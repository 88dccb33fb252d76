// A persistent GEMM on Hopper's wgmma with TMA-fed operands, bf16 or int8:
//
//     out[m, n] = bf16(epilogue(sum_k A[m, k] B(k, n), cols[n], res[m, n]))
//
// (f32 sums of bf16 operands, or exact s32 sums of int8 ones; the
// epilogue in f32, one rounding) for a row-major A (M, K) and a B stored
// either K-major, (N, K) as a torch Linear weight ("A B^T", B_KMAJOR), or
// MN-major, (K, N) ("A B", bf16 only: 8-bit wgmma reads both operands
// K-major). Each operand may be up to three row-major matrices laid end
// to end: A, and an MN-major B, along K in segments of `seg_k`; a K-major
// B, the column vectors, the residuals and the output along N in segments
// of `seg_n`. The epilogue is a policy type (below), which also names the
// operand type: bias then one rounding for K1's, K2's and K5's
// projections and K2's dx = [dq|dk|dv] [Wq; Wk; Wv] (K in three segments,
// one f32 sum); bias and quick-GELU for K9's fc1; bias and a bf16
// residual, in the association order each TPU kernel has, for K9's fc2
// and K6's out-projection; for int8 operands, the dequant of K8's and
// K7's projections (per-channel f32 scale, then f32 bias) and of K7's
// out-projection (the residual and its bias, then the scaled sums).
//
// What bounds it on the H100: at K2's training shape (M = 32 x 577, N or
// K = 3 x 1024, the other 1024) each GEMM is 116 GFLOP over ~190 MB, about
// 600 FLOP per byte: the tensor cores bound it (0.117 ms). K9's fc1 and
// fc2 (155 GFLOP each at M = 18464, I = 4096) sit further above the
// card's ridge; the int8 projections at 4 views (14.5 G operations over
// ~6 MB) too. The design keeps the tensor cores fed:
//   - output tiles of 128 x BN (BN 256, or 128 where the widths are not
//     multiples of 256), K in steps of 128 bytes (one 128-byte swizzled
//     row: 64 bf16 or 128 int8, four wgmma of 32 bytes each);
//   - a block of 384 threads: a producer warpgroup (40 registers by
//     setmaxnreg) whose first thread streams each step's A tile (128 rows)
//     and B tile (BN rows) by TMA through a ring of GEMM_STAGES stages,
//     running ahead across the block's tiles; two consumer warpgroups (232
//     registers) of 64 rows each, whose 64 x BN sums stay in registers:
//     four m64nBNk16 (bf16) or m64nBNk32 (int8) wgmma a step from shared
//     memory, one step's group left in flight while the next step's data
//     is awaited;
//   - a persistent grid, one block an SM, walking the tiles N-fastest: the
//     blocks at work share A's rows, and all of B stays in L2.
// The epilogue runs after the tile's last wgmma_wait, on the rows below M
// (TMA reads rows past M as zeros): a branch or a wait inside a stage
// would make ptxas serialise the products.

#pragma once

#include "hopper_sm90.cuh"

namespace {

constexpr int GEMM_BM = 128;      // output rows of a tile (2 x 64)
constexpr int GEMM_KSTEPS = 4;    // wgmma a stage, 32 bytes of K each
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
  // Per N segment: the bias, (seg_n,) of the policy's Bias type, or null
  // where a bf16 policy has none.
  const void* bias[GEMM_MAX_SEGS];
  // Per N segment, (seg_n,) f32: the dequant scales of a SCALED policy;
  // else null.
  const float* scale[GEMM_MAX_SEGS];
  bf16* out[GEMM_MAX_SEGS];         // per N segment, (M, seg_n)
  // Per N segment, (M, seg_n), read by a RESIDUAL epilogue; else null.
  const bf16* residual[GEMM_MAX_SEGS];
};

// The operand types. Either way a stage holds 128 bytes of K a row, and
// each of its GEMM_KSTEPS wgmma advances the descriptors by 32 bytes.
struct OperandBf16 {
  typedef bf16 T;
  typedef float Acc;                // f32 sums
  static constexpr int BK = 64;     // K values a stage
  // d (+)= A B on a 64 x BN tile, one k16 step.
  template <int BN, int TRANS_B>
  __device__ static __forceinline__ void mma(float (&d)[BN / 2],
                                             uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
    if constexpr (BN == 256) {
      wgmma_ss_n256<0, TRANS_B>(d, desc_a, desc_b, accumulate);
    } else {
      wgmma_ss_n128<0, TRANS_B>(d, desc_a, desc_b, accumulate);
    }
  }
};

struct OperandS8 {
  typedef int8_t T;
  typedef int32_t Acc;              // s32 sums, exact
  static constexpr int BK = 128;    // K values a stage
  // d (+)= A B on a 64 x BN tile, one k32 step; B K-major.
  template <int BN, int TRANS_B>
  __device__ static __forceinline__ void mma(int32_t (&d)[BN / 2],
                                             uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
    static_assert(TRANS_B == 0, "8-bit wgmma reads B K-major only");
    if constexpr (BN == 256) {
      wgmma_ss_s8_n256(d, desc_a, desc_b, accumulate);
    } else {
      wgmma_ss_s8_n128(d, desc_a, desc_b, accumulate);
    }
  }
};

// The epilogue policies. Each names its operand type (`Operand`), the
// type of its bias (`Bias`), whether it reads dequant scales (`SCALED`)
// and a residual (`RESIDUAL`). `cols` loads the column vectors at (n, n +
// 1) of one N segment; `store` takes a consumer thread's sums at (m, n)
// and (m, n + 1), those columns and, for a RESIDUAL policy, the
// residual's pair at the same place (`res`; unused otherwise), and stores
// the bf16 pair at `dst`, rounded once from f32.

// The bf16 policies' column vector: the bias pair in f32, zeros where the
// GEMM has none.
struct BiasCols {
  typedef OperandBf16 Operand;
  typedef bf16 Bias;
  static constexpr bool SCALED = false;
  __device__ static __forceinline__ float2 cols(const void* bias,
                                                const float*, int n) {
    if (bias == nullptr) return make_float2(0.0f, 0.0f);
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(bias) + n));
  }
};

// bf16(acc + bias): K1's, K2's and K5's projections, K2's dx.
struct EpilogueBias : BiasCols {
  static constexpr bool RESIDUAL = false;
  __device__ static __forceinline__ void store(bf16* dst, const bf16*,
                                               float a0, float a1, float2 b) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a0 + b.x, a1 + b.y);
  }
};

// bf16(quick_gelu(acc + bias)), quick_gelu(y) = y sigmoid(1.702 y): K9's
// fc1 (fused_mlp.py::_fused_ln_mlp_kernel). The exponential and the
// reciprocal on the special-function unit: a few f32 ulps, far under the
// one bf16 rounding that follows; exp overflowing to inf gives -0.
struct EpilogueBiasQuickGelu : BiasCols {
  static constexpr bool RESIDUAL = false;
  __device__ static __forceinline__ float quick_gelu(float y) {
    return __fdividef(y, 1.0f + __expf(-1.702f * y));
  }
  __device__ static __forceinline__ void store(bf16* dst, const bf16*,
                                               float a0, float a1, float2 b) {
    *reinterpret_cast<uint32_t*>(dst) =
        pack_bf16(quick_gelu(a0 + b.x), quick_gelu(a1 + b.y));
  }
};

// bf16((res + bias) + acc): K9's fc2, x + b2 + h W2^T in that order.
struct EpilogueResidualBiasAcc : BiasCols {
  static constexpr bool RESIDUAL = true;
  __device__ static __forceinline__ void store(bf16* dst, const bf16* res,
                                               float a0, float a1, float2 b) {
    const float2 r =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res));
    *reinterpret_cast<uint32_t*>(dst) =
        pack_bf16((r.x + b.x) + a0, (r.y + b.y) + a1);
  }
};

// bf16(res + (acc + bias)): K6's out-projection, x + (ao Wo^T + bo) in
// that order (flash_attention.py::_fused_block_reference).
struct EpilogueResidualAccBias : BiasCols {
  static constexpr bool RESIDUAL = true;
  __device__ static __forceinline__ void store(bf16* dst, const bf16* res,
                                               float a0, float a1, float2 b) {
    const float2 r =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res));
    *reinterpret_cast<uint32_t*>(dst) =
        pack_bf16(r.x + (a0 + b.x), r.y + (a1 + b.y));
  }
};

// The int8 policies' column vectors: the f32 dequant scale pair `s` (the
// activation scale folded in) and the f32 bias pair `b`, both required.
// The s32 sums convert to f32 exactly (|x_q . w| <= 127^2 D < 2^24 for D
// <= 1040), and every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn): contracted into an FMA, a result one ulp apart could flip
// a requantize downstream, and K8's q/k/v would no longer equal the plain
// version's bit for bit.
struct DequantCols {
  typedef OperandS8 Operand;
  typedef float Bias;
  static constexpr bool SCALED = true;
  struct Cols {
    float2 s, b;
  };
  __device__ static __forceinline__ Cols cols(const void* bias,
                                              const float* scale, int n) {
    return {*reinterpret_cast<const float2*>(scale + n),
            *reinterpret_cast<const float2*>(static_cast<const float*>(bias) +
                                             n)};
  }
};

// bf16(f32(acc) * s + b): K8's and K7's q/k/v projections,
// `y.astype(f32) * s + b` of _fused_qkv_int8_kernel in XLA's order.
struct EpilogueDequantBias : DequantCols {
  static constexpr bool RESIDUAL = false;
  __device__ static __forceinline__ void store(bf16* dst, const bf16*,
                                               int32_t a0, int32_t a1,
                                               Cols c) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(
        __fadd_rn(__fmul_rn(__int2float_rn(a0), c.s.x), c.b.x),
        __fadd_rn(__fmul_rn(__int2float_rn(a1), c.s.y), c.b.y));
  }
};

// bf16((res + b) + f32(acc) * s): K7's out-projection, (x + bo) + po *
// (ao so) of _block_attn_int8_kernel, one accumulator over all of D.
struct EpilogueResidualBiasDequant : DequantCols {
  static constexpr bool RESIDUAL = true;
  __device__ static __forceinline__ void store(bf16* dst, const bf16* res,
                                               int32_t a0, int32_t a1,
                                               Cols c) {
    const float2 r =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res));
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(
        __fadd_rn(__fadd_rn(r.x, c.b.x), __fmul_rn(__int2float_rn(a0), c.s.x)),
        __fadd_rn(__fadd_rn(r.y, c.b.y),
                  __fmul_rn(__int2float_rn(a1), c.s.y)));
  }
};

// Prefetch into L2 the residual of a consumer thread's rows m and m + 8
// (those below M) at columns n0 .. n0 + BN - 1: the four threads of a row
// take one BN / 4-column share each.
template <int BN>
__device__ __forceinline__ void residual_to_l2(const GemmSm90Args& args,
                                               int m, int n0, int quad) {
  const int t = n0 / args.seg_n;
  const bf16* res =
      t == 0 ? args.residual[0] : t == 1 ? args.residual[1] : args.residual[2];
  const bf16* p = res + static_cast<size_t>(m) * args.seg_n +
                  (n0 - t * args.seg_n) + quad * (BN / 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (m + 8 * r < args.M) {
#pragma unroll
      for (int c = 0; c < BN / 4; c += 64) {  // 128-byte lines
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            p + static_cast<size_t>(8 * r) * args.seg_n + c));
      }
    }
  }
}

// `Tag` names the instance, so that each user has a symbol of its own in
// a profile; `Epilogue` is one of the policies above, and its Operand the
// type of A and B.
template <class Tag, int BN, bool B_KMAJOR, class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ GemmSm90Maps maps,
                 GemmSm90Args args) {
  typedef typename Epilogue::Operand Op;
  static_assert(B_KMAJOR || Op::BK == 64, "MN-major B is bf16 only");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  constexpr int STAGE = gemm_stage_bytes<BN>();
  const int n_tiles = args.N / BN;
  const int tiles = (args.M + GEMM_BM - 1) / GEMM_BM * n_tiles;
  const int steps = args.K / Op::BK;
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
          const int k0 = ks * Op::BK;
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
  typename Op::Acc acc[BN / 2];

  int it = 0;
  for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
    const int m0 = w / n_tiles * GEMM_BM, n0 = w % n_tiles * BN;
    if constexpr (Epilogue::RESIDUAL) {
      // Bring the tile's residual rows into L2 while its products run: the
      // epilogue's loads would otherwise wait on device memory, a round
      // trip for each group of them the registers can hold.
      residual_to_l2<BN>(args, m0 + cw * 64 + row, n0, quad);
    }
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int st = it % GEMM_STAGES;
      const uint32_t a_addr = base + st * STAGE + cw * 64 * ROW_BYTES;
      const uint32_t b_addr = base + st * STAGE + GEMM_A_BYTES;
      mbar_wait(full + st, (it / GEMM_STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GEMM_KSTEPS; ++kk) {
        // K-major B: +32 bytes within its rows a step. MN-major: 16 of
        // its rows, the 64-wide tiles 64 rows apart.
        const uint64_t desc_b =
            B_KMAJOR ? desc_sw128(b_addr + kk * 32)
                     : desc_sw128(b_addr + kk * 16 * ROW_BYTES,
                                  64 * ROW_BYTES);
        Op::template mma<BN, B_KMAJOR ? 0 : 1>(
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

    // out = bf16(epilogue(acc, cols, res)) on the rows below M.
    // The segment by selects: a run-time index into the parameter's
    // arrays would copy them to the stack.
    const int t = n0 / args.seg_n;
    const int n_local = n0 - t * args.seg_n;
    const void* bias =
        t == 0 ? args.bias[0] : t == 1 ? args.bias[1] : args.bias[2];
    const float* scale = nullptr;
    if constexpr (Epilogue::SCALED) {
      scale = t == 0 ? args.scale[0] : t == 1 ? args.scale[1] : args.scale[2];
    }
    bf16* out = t == 0 ? args.out[0] : t == 1 ? args.out[1] : args.out[2];
    const int m = m0 + cw * 64 + row;
    const size_t at = static_cast<size_t>(m) * args.seg_n + n_local;
    bf16* dst = out + at;
    const bf16* res = nullptr;
    if constexpr (Epilogue::RESIDUAL) {
      res = (t == 0   ? args.residual[0]
             : t == 1 ? args.residual[1]
                      : args.residual[2]) +
            at;
    }
    const bool in[2] = {m < args.M, m + 8 < args.M};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const auto cols = Epilogue::cols(bias, scale, n_local + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        const size_t off = static_cast<size_t>(8 * r) * args.seg_n + c;
        Epilogue::store(dst + off, Epilogue::RESIDUAL ? res + off : nullptr,
                        acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1], cols);
      }
    }
  }
}

// The operand pointer types of a policy.
template <class Epilogue>
using GemmIn = typename Epilogue::Operand::T;
template <class Epilogue>
using GemmBias = typename Epilogue::Bias;

// The GEMM at tile width BN (seg_n a multiple of BN): tensor maps,
// arguments and the persistent launch. `gemm_sm90` picks BN.
template <class Tag, int BN, bool B_KMAJOR, class Epilogue>
inline cudaError_t gemm_sm90_at(const GemmIn<Epilogue>* const* a,
                                const GemmIn<Epilogue>* const* b,
                                const GemmBias<Epilogue>* const* bias,
                                bf16* const* out,
                                const bf16* const* residual, int M, int N,
                                int K, int seg_k, int seg_n,
                                cudaStream_t stream,
                                const float* const* scale = nullptr) {
  typedef GemmIn<Epilogue> T;
  GemmSm90Maps maps = {};
  GemmSm90Args args = {};
  args.M = M;
  args.N = N;
  args.K = K;
  args.seg_k = seg_k;
  args.seg_n = seg_n;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < K / seg_k; ++i) {
    err = rowmajor_map<T>(&maps.a[i], a[i], M, seg_k, GEMM_BM);
    if (err != cudaSuccess) return err;
    if (!B_KMAJOR) err = rowmajor_map<T>(&maps.b[i], b[i], seg_k, N, 64);
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < N / seg_n; ++i) {
    if (B_KMAJOR) err = rowmajor_map<T>(&maps.b[i], b[i], seg_n, K, BN);
    if (err != cudaSuccess) return err;
    args.bias[i] = bias == nullptr ? nullptr : bias[i];
    args.scale[i] = scale == nullptr ? nullptr : scale[i];
    args.out[i] = out[i];
    args.residual[i] = residual == nullptr ? nullptr : residual[i];
  }
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;  // once a process
  if (!smem_set) {
    err = cudaFuncSetAttribute(gemm_sm90_kernel<Tag, BN, B_KMAJOR, Epilogue>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gemm_smem_bytes<BN>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long tiles = static_cast<long>((M + GEMM_BM - 1) / GEMM_BM) * (N / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_sm90_kernel<Tag, BN, B_KMAJOR, Epilogue>
      <<<grid, GEMM_THREADS, gemm_smem_bytes<BN>(), stream>>>(maps, args);
  return cudaGetLastError();
}

// out = epilogue(A B^T) (B_KMAJOR: b[i] is (seg_n, K), N = segments x
// seg_n) or epilogue(A B) (b[i] is (seg_k, N), K = segments x seg_k) on
// `stream`; a[i] is (M, seg_k), out[i] and residual[i] (M, seg_n), bias[i]
// and scale[i] (seg_n,), A and B of the policy's operand type, bias of its
// Bias type, scale f32, out and residual bf16, all row-major, contiguous
// and 16-byte aligned. bias may be null for a bf16 policy; a SCALED policy
// needs bias and scale, a RESIDUAL one residual. seg_n a multiple of 128,
// seg_k of 128 bytes. Returns the first failing call's error.
template <class Tag, bool B_KMAJOR, class Epilogue = EpilogueBias>
inline cudaError_t gemm_sm90(const GemmIn<Epilogue>* const* a,
                             const GemmIn<Epilogue>* const* b,
                             const GemmBias<Epilogue>* const* bias,
                             bf16* const* out, int M, int N, int K,
                             int seg_k, int seg_n, cudaStream_t stream,
                             const bf16* const* residual = nullptr,
                             const float* const* scale = nullptr) {
  constexpr int BK = Epilogue::Operand::BK;
  if (M < 1 || seg_k < BK || seg_k % BK || seg_n < 128 || seg_n % 128 ||
      K % seg_k || N % seg_n || K / seg_k > GEMM_MAX_SEGS ||
      N / seg_n > GEMM_MAX_SEGS ||
      (Epilogue::RESIDUAL && residual == nullptr) ||
      (Epilogue::SCALED && (bias == nullptr || scale == nullptr))) {
    return cudaErrorInvalidValue;
  }
  return seg_n % 256 == 0
             ? gemm_sm90_at<Tag, 256, B_KMAJOR, Epilogue>(
                   a, b, bias, out, residual, M, N, K, seg_k, seg_n, stream,
                   scale)
             : gemm_sm90_at<Tag, 128, B_KMAJOR, Epilogue>(
                   a, b, bias, out, residual, M, N, K, seg_k, seg_n, stream,
                   scale);
}

}  // namespace
