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
//   2. fc1:   a tiled GEMM (128 x 128 block tiles, K in 32-wide steps,
//             8 warps of WMMA 16x16x16 with f32 accumulation) whose A
//             tiles are normalised, scaled and biased as they are staged
//             (so xn never reaches device memory), with a +b1, quick-GELU
//             and bf16 epilogue into an (M, I) bf16 workspace h (151 MB at
//             the training shape);
//   3. fc2:   the same GEMM over h with W2's tiles double-buffered by
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
// GEMM tiling: 128 x 128 block tile, 32-deep K steps, 8 warps as 4 (M)
// x 2 (N), each warp 32 x 64 (2 x 4 fragments).
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDK = BK + 8;          // a tile stored (row, k): 40
constexpr int STAGE = BM * LDK * 2;  // one 128 x 32 bf16 tile: 10240 B
constexpr int EPI_LD = 20;           // per-warp 16 x 16 f32 patch stride

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct MlpArgs {
  const bf16* x;          // (M, D)
  float* stats;           // (M, 2): mean, rsqrt(var + eps)
  const float* ln_scale;  // (D,)
  const float* ln_bias;   // (D,)
  const bf16* w1;         // (I, D)
  const bf16* b1;         // (I,)
  const bf16* w2;         // (D, I)
  const bf16* b2;         // (D,)
  bf16* h;                // (M, I) workspace
  bf16* out;              // (M, D)
  int M, D, I;
  float eps;
};

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

// Pass 1: mean and rsqrt(max(E[x^2] - E[x]^2, 0) + eps) of each row.
__global__ void __launch_bounds__(THREADS)
ln_stats_kernel(MlpArgs args) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (THREADS / 32) + warp;
  if (m >= args.M) return;
  const int D = args.D;
  const bf16* row = args.x + (size_t)m * D;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    const float mean = s1 / D;
    args.stats[2 * m] = mean;
    args.stats[2 * m + 1] =
        rsqrtf(fmaxf(s2 / D - mean * mean, 0.0f) + args.eps);
  }
}

// Passes 2 (FC1) and 3 (!FC1): out[m, n] = epilogue(sum_k A[m, k] W[n, k])
// with A = LN(x) (K = D, N = I) or h (K = I, N = D), W = W1 or W2.
template <bool FC1>
__global__ void __launch_bounds__(THREADS)
mlp_gemm_kernel(MlpArgs args) {
  __shared__ __align__(128) unsigned char smem[4 * STAGE];
  const int M = args.M;
  const int K = FC1 ? args.D : args.I;
  const bf16* a = FC1 ? args.x : args.h;
  const bf16* w = FC1 ? args.w1 : args.w2;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // 32-row strip of the block tile
  const int wn = warp % 2;  // 64-column strip

  auto load_stage = [&](int buf, int k0) {
    bf16* as = reinterpret_cast<bf16*>(smem + buf * 2 * STAGE);
    bf16* bs = reinterpret_cast<bf16*>(smem + buf * 2 * STAGE + STAGE);
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int m = m0 + r;
      const bool ok = m < M;
      const bf16* src = a + (size_t)(ok ? m : 0) * K + k0 + c;
      if constexpr (FC1) {
        // Normalise in f32 while staging; rows past M are zeros.
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
          bf16* o = reinterpret_cast<bf16*>(&packed);
          const float mean = args.stats[2 * m];
          const float rs = args.stats[2 * m + 1];
          const float* ls = args.ln_scale + k0 + c;
          const float* lb = args.ln_bias + k0 + c;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[j] = __float2bfloat16((__bfloat162float(e[j]) - mean) *
                                        (rs * ls[j]) +
                                    lb[j]);
          }
        }
        *reinterpret_cast<uint4*>(as + r * LDK + c) = packed;
      } else {
        cp_async16(as + r * LDK + c, src, ok);
      }
    }
    // W rows n (the output columns), K contiguous: stored (n, k).
    for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      cp_async16(bs + r * LDK + c, w + (size_t)(n0 + r) * K + k0 + c, true);
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
        FragBCol fb;
        wmma::load_matrix_sync(fb, bs + (wn * 64 + j * 16) * LDK + kk, LDK);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16 x 16 f32 patch (overlaying the now
  // idle staging buffers): each lane finishes 8 values of one row and
  // writes them as one 16-byte vector.
  float* patch = reinterpret_cast<float*>(smem) + warp * 16 * EPI_LD;
  const int pr = lane / 2;
  const int pc = (lane % 2) * 8;
  const int N = FC1 ? args.I : args.D;
  bf16* out = FC1 ? args.h : args.out;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], EPI_LD, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + pr;
      const int n = n0 + wn * 64 + j * 16 + pc;
      if (m < M) {
        float v[8];
        if constexpr (FC1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float y = patch[pr * EPI_LD + pc + e] +
                            __bfloat162float(args.b1[n + e]);
            v[e] = y * (1.0f / (1.0f + expf(-1.702f * y)));  // quick-GELU
          }
        } else {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(args.x + (size_t)m * N + n);
          const bf16* xe = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = (__bfloat162float(xe[e]) +
                    __bfloat162float(args.b2[n + e])) +
                   patch[pr * EPI_LD + pc + e];
          }
        }
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          packed[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(out + (size_t)m * N + n) =
            *reinterpret_cast<const uint4*>(packed);
      }
      __syncwarp();
    }
  }
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
  if (rows < 1 || dim < BN || dim % BN != 0 || inter % BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpArgs args = {};
  args.x = static_cast<const bf16*>(x);
  args.stats = static_cast<float*>(stats);
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
  args.eps = eps;
  const int warps = THREADS / 32;
  cudaError_t err;
  ln_stats_kernel<<<(rows + warps - 1) / warps, THREADS, 0, st>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int m_blocks = (rows + BM - 1) / BM;
  mlp_gemm_kernel<true><<<dim3(m_blocks, inter / BN), THREADS, 0, st>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlp_gemm_kernel<false><<<dim3(m_blocks, dim / BN), THREADS, 0, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
