// LayerNorm + quick-GELU MLP + residual forward, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/fused_mlp.py::_fused_ln_mlp_kernel (launcher
// `_fused_ln_mlp_forward`, reached through `fused_ln_mlp` on the
// `flash_fused_mlp` route: the MLP half of every CLIP encoder layer). For
// x (M = B*S rows, D), the Linear-layout weights W1 (I, D) and W2 (D, I)
// and biases b1 (I,), b2 (D,), it computes, at the TPU kernel's rounding
// points (fused_mlp.py:67-96):
//
//     xn  = bf16(LN_f32(x))       Flax's fast variance, f32 ln_scale/bias
//     h   = bf16(quick_gelu_f32(xn W1^T + b1))           (f32 accumulate)
//     out = bf16(x + b2 + h W2^T)                        (f32 accumulate)
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// D=1024, I=4096) the two products are ~310 GFLOP of bf16 tensor-core
// work over ~92 MB of x, weights and out: ~3,400 FLOP per byte, far above
// the card's ~295, so the tensor cores bound it (~0.31 ms). This first
// form is three launches, no atomics:
//
//   1. stats: each row's mean and rsqrt(var + eps) over D in f32, one
//             warp a row, into an (M, 2) f32 workspace;
//   2. fc1:   a tiled GEMM (gemm_tile.cuh: 128 x 128 block tiles, K in
//             32-wide steps, 8 warps of WMMA 16x16x16 with f32
//             accumulation) whose A tiles are normalised, scaled and
//             biased as they are staged (so xn never reaches device
//             memory), with a +b1, quick-GELU and bf16 epilogue into an
//             (M, I) bf16 workspace h (151 MB at the training shape);
//   3. fc2:   the same GEMM over h, A and W tiles double-buffered by
//             cp.async, and an f32 epilogue adding b2 and the residual x.
//
// The TPU kernel keeps h in VMEM by sweeping I in chunks into an f32
// accumulator; keeping it on chip here (a split over I per block tile,
// wgmma, TMA) is later work.
//
// Constraints (checked by the Python wrapper): D and I multiples of 128;
// x, weights, biases and out bf16, ln_scale and ln_bias f32, all
// contiguous and 16-byte aligned. Rows past M are staged as zeros and
// never written.

#include "gemm_tile.cuh"
#include "ln_row.cuh"

namespace {

using gemm::bf16;

struct MlpArgs {
  const bf16* x;          // (M, D)
  const float* stats;     // (M, 2): mean, rsqrt(var + eps)
  const float* ln_scale;  // (D,)
  const float* ln_bias;   // (D,)
  const bf16* w1;         // (I, D)
  const bf16* b1;         // (I,)
  const bf16* w2;         // (D, I)
  const bf16* b2;         // (D,)
  bf16* h;                // (M, I) workspace
  bf16* out;              // (M, D)
  int M, D, I;
};

// Pass 1: each row's mean and rsqrt(max(E[x^2] - E[x]^2, 0) + eps) over D
// in f32 (Flax's fast variance, ln_row.cuh), one warp a row, into stats
// (M, 2).
__global__ void __launch_bounds__(gemm::THREADS)
ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats,
                int M, int D, float eps) {
  const int m = blockIdx.x * (gemm::THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const LnStats ln = ln_warp_stats(x + (size_t)m * D, D, eps);
  if (threadIdx.x % 32 == 0) {
    stats[2 * m] = ln.mean;
    stats[2 * m + 1] = ln.rs;
  }
}

// Passes 2 (FC1) and 3 (!FC1): out[m, n] = epilogue(sum_k A[m, k] W[n, k])
// with A = LN(x) (K = D, N = I) or h (K = I, N = D), W = W1 or W2.
template <bool FC1>
__global__ void __launch_bounds__(gemm::THREADS)
mlp_gemm_kernel(MlpArgs args) {
  __shared__ __align__(128) unsigned char smem[gemm::SMEM_BYTES];
  const int M = args.M;
  const int K = FC1 ? args.D : args.I;
  const int m0 = blockIdx.x * gemm::BM;
  const int n0 = blockIdx.y * gemm::BN;

  gemm::FragC acc[2][4];
  if constexpr (FC1) {
    // Normalise in f32 while staging; rows past M are zeros.
    auto load_a = [&](bf16* as, int k0) {
      for (int i = threadIdx.x; i < gemm::BM * gemm::BK / 8;
           i += gemm::THREADS) {
        const int r = i / (gemm::BK / 8);
        const int c = (i % (gemm::BK / 8)) * 8;
        const int m = m0 + r;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (m < M) {
          packed = ln_normalise8(
              *reinterpret_cast<const uint4*>(args.x + (size_t)m * K + k0 +
                                              c),
              args.stats[2 * m], args.stats[2 * m + 1],
              args.ln_scale + k0 + c, args.ln_bias + k0 + c);
        }
        *reinterpret_cast<uint4*>(as + r * gemm::LDK + c) = packed;
      }
    };
    gemm::mma_bf16(smem, load_a, args.w1, K, n0, acc);
  } else {
    auto load_a = [&](bf16* as, int k0) {
      gemm::copy_a_bf16(as, args.h, M, K, m0, k0);
    };
    gemm::mma_bf16(smem, load_a, args.w2, K, n0, acc);
  }

  const int N = FC1 ? args.I : args.D;
  gemm::epilogue<float>(smem, acc, [&](int r, int c, const float* p) {
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M) return;
    float v[8];
    if constexpr (FC1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = p[e] + __bfloat162float(args.b1[n + e]);
        v[e] = y * (1.0f / (1.0f + expf(-1.702f * y)));  // quick-GELU
      }
      gemm::store8_bf16(args.h + (size_t)m * N + n, v);
    } else {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(args.x + (size_t)m * N + n);
      const bf16* xe = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (__bfloat162float(xe[e]) + __bfloat162float(args.b2[n + e])) +
               p[e];
      }
      gemm::store8_bf16(args.out + (size_t)m * N + n, v);
    }
  });
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, D) bf16; ln_scale/ln_bias (D,) f32; w1 (I, D), b1 (I,), w2 (D, I),
// b2 (D,) bf16; workspace h (M, I) bf16 and stats (M, 2) f32; out (M, D)
// bf16. Launches the three passes on `stream` and returns the first
// failing launch's cudaError_t (0 on success).
int pigeon_fused_ln_mlp(const void* x, const void* ln_scale,
                        const void* ln_bias, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* h, void* stats,
                        void* out, int rows, int dim, int inter, float eps,
                        void* stream) {
  if (rows < 1 || dim < gemm::BN || dim % gemm::BN != 0 ||
      inter % gemm::BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpArgs args = {};
  args.x = static_cast<const bf16*>(x);
  args.stats = static_cast<const float*>(stats);
  args.ln_scale = static_cast<const float*>(ln_scale);
  args.ln_bias = static_cast<const float*>(ln_bias);
  args.w1 = static_cast<const bf16*>(w1);
  args.b1 = static_cast<const bf16*>(b1);
  args.w2 = static_cast<const bf16*>(w2);
  args.b2 = static_cast<const bf16*>(b2);
  args.h = static_cast<bf16*>(h);
  args.out = static_cast<bf16*>(out);
  args.M = rows;
  args.D = dim;
  args.I = inter;
  cudaError_t err;
  const int warps = gemm::THREADS / 32;
  ln_stats_kernel<<<(rows + warps - 1) / warps, gemm::THREADS, 0, st>>>(
      args.x, static_cast<float*>(stats), rows, dim, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int m_blocks = (rows + gemm::BM - 1) / gemm::BM;
  mlp_gemm_kernel<true><<<dim3(m_blocks, inter / gemm::BN), gemm::THREADS, 0,
                          st>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlp_gemm_kernel<false><<<dim3(m_blocks, dim / gemm::BN), gemm::THREADS, 0,
                           st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
