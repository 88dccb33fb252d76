// One-pass LayerNorm, residual add + LayerNorm, quick-GELU, SwiGLU and
// LayerScale'd residual add + LayerNorm, bf16 in and out, for Hopper
// (sm_90a); and the backwards of the first three.
//
// These replace no TPU kernel: on the TPU, XLA fuses each encoder layer's
// element-wise chain into its neighbours. On the card the inference
// forward of every encoder layer (models/clip.py `TransformerLayer`, grad
// mode off, float, no mask) ran it as eager PyTorch kernels:
//
//   LN:     x.float(), F.layer_norm in f32, .to(bf16)    three kernels
//   add:    x + a                                        one kernel
//   GELU:   t = 1.702 * x, s = sigmoid(t), x * s         three kernels
//
// What bounds them on the H100: bytes. Every element is read and written
// a few times for a handful of f32 operations, far below the card's ~295
// operations a byte. At the ViT-L/14-336 sweep's batch (512 images of 577
// tokens, D = 1024, I = 4096) the eager chain moves ~32.5 GB a layer:
// each LN reads bf16, writes and reads f32 twice and writes bf16 (6.05
// GB), the GELU's three passes move 16.8 GB, each add 1.8 GB. The design
// reads each input once and writes each output once, and keeps every
// intermediate in registers:
//
//   1. layer_norm_bf16: one warp a row, the row held in registers as
//      16-byte vectors of bf16 (D <= 2048: at most 8 a lane); F.layer_norm's
//      two-pass f32 statistics (the mean, then the mean of (x - mean)^2,
//      each a butterfly of warp shuffles), then gamma * (rstd * (x - mean))
//      + beta in f32, rounded once to bf16. 1.21 GB a layer at that batch
//      (0.36 ms at 3.35 TB/s).
//   2. add_layer_norm_bf16: the same over s = bf16(x + a), the value the
//      eager add gives; writes s (the residual stream) and LN(s). 2.42 GB
//      (0.72 ms).
//   3. quick_gelu_bf16: a grid of 16-byte vectors, rounding where the eager
//      chain rounds: t = bf16(1.702 x), s = bf16(1 / (1 + exp(-t))), y =
//      bf16(x s), each operation rounded on its own (__fmul_rn, __fadd_rn,
//      __frcp_rn: never contracted), the scalar 1.702 as PyTorch passes it
//      (the double cast to f32), expf in full precision as PyTorch's
//      sigmoid calls it. 4.84 GB (1.45 ms); the ~20 f32 instructions and
//      two MUFU operations an element stay under that time.
//
// On an H100 80GB HBM3 at 700 W the three take 0.40, 0.79 and 1.58 ms at
// that batch, 90-92% of the bandwidth, against 2.46, 3.05 and 5.51 ms for
// the eager chain (scripts/bench_torch_eltwise.py).
//
// F.layer_norm's CUDA kernel takes Welford's statistics, this the two-pass
// ones: the outputs can sit one bf16 ulp apart; the LN's own arithmetic,
// fma(gamma, rstd * (x - mean), beta), is PyTorch's as nvcc contracts it.
// This is not ln_row.cuh's Flax form (E[x^2] - E[x]^2), which K5-K9 fold
// in. Each kernel's name (EltLayerNorm, EltAddLayerNorm, EltQuickGelu,
// EltSwiGlu, EltScaleAddLayerNorm) is its own, so a profile tells them
// apart.
//
// The DINOv2 layer (models/clip.py `TransformerLayer` with SwiGLU and
// LayerScale) changes two links of that chain, and each has a kernel:
//
//   SwiGLU:  u1, u2 = u.chunk(2), F.silu(u1), * u2       two kernels
//   scaled:  gamma.to(bf16), a * g, x + p                three kernels
//
//   4. swiglu_bf16: y = bf16(bf16(silu(u1)) * u2) from the fc-in output u
//      (rows, 2I), silu as PyTorch's CUDA kernel computes it, x / (1 +
//      expf(-x)) in f32 (__fdiv_rn, full-precision expf), rounded to bf16,
//      then the product rounded once. One block a row's 512-vector chunk:
//      the gate and the up half are read once each, y written once. At
//      DINOv2-g's sweep batch (128 images of 1,374 tokens, I = 4096) 4.32
//      GB a layer (1.29 ms at 3.35 TB/s); the eager pair moves 7.2 GB.
//   5. scale_add_layer_norm_bf16: s = bf16(x + bf16(bf16(gamma) a)), the
//      residual with LayerScale's per-channel gamma (f32, rounded to bf16
//      as the layer casts its parameters), and LN(s), as add_layer_norm
//      above. 2.16 GB a call at that batch (0.65 ms); two calls a layer:
//      the attention residual with LN2, and the MLP residual with the next
//      layer's LN1 (the final LN after the last layer).
//
// Training (grad mode on, a CLIP layer: models/clip.py) ran the same chain
// three times a step: the forward, the remat recompute of every layer
// (attn_kernel keeps only the attention's outputs), and autograd's
// backward of each eager op. The forwards above now serve the first two,
// LN and add + LN writing each row's f32 mean and rstd (8 bytes a row:
// 2.4 MB at the finetune cell's 512 x 577 rows) where given `stats`. The
// backward, again bytes-bound:
//
//   LN:     dy.float(), F.layer_norm's f32 backward, .to(bf16)   ~7 GB
//   GELU:   two products, sigmoid_backward, x 1.702, the sum     ~36 GB
//
//   6. layer_norm_bwd_bf16: one warp a row, as the forward, x and dy in
//      registers; with x_hat = (x - mean) rstd from the saved statistics
//      and g = gamma dy, dx = bf16((D g - sum g - x_hat sum(g x_hat))
//      rstd / D) (PyTorch's compute_gI form, the sums by warp shuffles).
//      Reads x and dy, writes dx: 1.81 GB (0.54 ms). Where gamma and beta
//      train (the pre-LN and the last layer's LNs in finetune), a grid of
//      two blocks a multiprocessor strides over the rows and each lane
//      keeps its columns' sums of dy x_hat and dy in registers; each block
//      writes its column sums (blocks, 2, D) in warp order, and a second
//      launch adds those in block order: no atomics, so the sums are the
//      same from run to run.
//   7. add_layer_norm_bwd_bf16: the same with the residual stream's
//      gradient ds added as autograd adds it, dx = bf16(ds + bf16(LN'
//      dh)), the gradient of both addends: 2.42 GB (0.72 ms).
//   8. quick_gelu_bwd_bf16: from u alone (autograd saved u and s), t and s
//      again as the forward rounds them, then eager autograd's chain on
//      the card, each step rounded to bf16 (quick_gelu_bwd2 says how),
//      reading u and dy and writing du: 7.26 GB (2.17 ms). Its roundings
//      run as packed bf16x2 operations: with f32 ones and conversions the
//      kernel ran ~50 instructions an element and reached 71% of the
//      bandwidth; packed, 93%.
//
// On the H100 at 700 W the three take 0.59 (0.66 with gamma's and beta's
// gradients), 0.77 and 2.33 ms at those rows, 82-94% of the bandwidth,
// against 3.95 (4.76), 4.53 and 14.1 ms for eager autograd's operations
// (scripts/bench_torch_eltwise.py). Against PyTorch's CUDA backward on the
// same statistics, dx sits within one bf16 ulp but for sums taken in
// another order, and quick-GELU's gradient is equal bit for bit. The
// kernels are named EltLayerNormBwd, EltAddLayerNormBwd,
// EltLayerNormParamGrad and EltQuickGeluBwd.
//
// Constraints (checked by the Python wrapper, kernels/eltwise.py): bf16
// activations, f32 LN parameters and gamma, all contiguous and 16-byte
// aligned, f32 statistics (2, M) contiguous; D a multiple of 8, at most
// 2048; SwiGLU's I a multiple of 8. Rows past M are never read or
// written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROW_THREADS = 256;  // eight warps, one row each
constexpr int MAX_VECS = 8;       // 16-byte vectors a lane: D <= 2048
constexpr int GELU_THREADS = 256;
constexpr int GELU_VECS = 2;      // 16-byte vectors a thread, loads first
constexpr int SWIGLU_THREADS = 256;
constexpr int SWIGLU_VECS = 2;    // of the gate and of the up half each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Eight bf16 of a vector as f32.
__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(f[j]);
  return raw;
}

// LayerNorm of the row a warp holds in `v` (VECS vectors a lane, vector k
// at column (lane + 32 k) * 8, present where that column is below D), to
// `dst`. Every lane of the warp calls it.
// Where `stats` is given, lane 0 writes the row's mean to stats[r] and its
// rstd to stats[M + r].
template <int VECS>
__device__ __forceinline__ void ln_row_store(const uint4* v, int D,
                                             const float* __restrict__ ls,
                                             const float* __restrict__ lb,
                                             float eps, bf16* dst,
                                             float* __restrict__ stats,
                                             int r, int M) {
  const int lane = threadIdx.x % 32;
  float f[8];
  float s1 = 0.0f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if ((lane + 32 * k) * 8 < D) {
      unpack8(v[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) s1 = __fadd_rn(s1, f[j]);
    }
  }
  const float mean = __fdiv_rn(warp_sum(s1), static_cast<float>(D));
  float s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if ((lane + 32 * k) * 8 < D) {
      unpack8(v[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(f[j], mean);
        s2 = __fmaf_rn(d, d, s2);
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(s2), static_cast<float>(D));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  if (stats != nullptr && lane == 0) {
    stats[r] = mean;
    stats[static_cast<size_t>(M) + r] = rstd;
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      unpack8(v[k], f);
      const float4 g0 = *reinterpret_cast<const float4*>(ls + c);
      const float4 g1 = *reinterpret_cast<const float4*>(ls + c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(lb + c);
      const float4 b1 = *reinterpret_cast<const float4*>(lb + c + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = __fmaf_rn(g[j], __fmul_rn(rstd, __fsub_rn(f[j], mean)), b[j]);
      }
      *reinterpret_cast<uint4*>(dst + c) = pack8(y);
    }
  }
}

struct EltLayerNorm {};
struct EltAddLayerNorm {};

// out[r] = bf16(LN_f32(x[r])) over the M rows of x (M, D).
template <class Tag, int VECS>
__global__ void __launch_bounds__(ROW_THREADS)
layer_norm_bf16_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ ls,
                       const float* __restrict__ lb, bf16* __restrict__ out,
                       float* __restrict__ stats, int M, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (r >= M) return;
  const size_t base = static_cast<size_t>(r) * D;
  uint4 v[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) v[k] = *reinterpret_cast<const uint4*>(x + base + c);
  }
  ln_row_store<VECS>(v, D, ls, lb, eps, out + base, stats, r, M);
}

// s[r] = bf16(x[r] + a[r]) and out[r] = bf16(LN_f32(s[r])).
template <class Tag, int VECS>
__global__ void __launch_bounds__(ROW_THREADS)
add_layer_norm_bf16_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ a,
                           const float* __restrict__ ls,
                           const float* __restrict__ lb,
                           bf16* __restrict__ s, bf16* __restrict__ out,
                           float* __restrict__ stats, int M, int D,
                           float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (r >= M) return;
  const size_t base = static_cast<size_t>(r) * D;
  uint4 v[VECS], w[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      v[k] = *reinterpret_cast<const uint4*>(x + base + c);
      w[k] = *reinterpret_cast<const uint4*>(a + base + c);
    }
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      float fx[8], fa[8];
      unpack8(v[k], fx);
      unpack8(w[k], fa);
#pragma unroll
      for (int j = 0; j < 8; ++j) fx[j] = __fadd_rn(fx[j], fa[j]);
      v[k] = pack8(fx);
      *reinterpret_cast<uint4*>(s + base + c) = v[k];
    }
  }
  ln_row_store<VECS>(v, D, ls, lb, eps, out + base, stats, r, M);
}

// quick-GELU of one element at the eager chain's rounding points.
__device__ __forceinline__ float quick_gelu1(float x) {
  // PyTorch multiplies a bf16 tensor by the Python float 1.702 as f32.
  const float k = static_cast<float>(1.702);
  const float t = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, k)));
  const float sg = __bfloat162float(__float2bfloat16_rn(
      __frcp_rn(__fadd_rn(1.0f, expf(-t)))));
  return __fmul_rn(x, sg);
}

struct EltQuickGelu {};

// y = quick_gelu(x) over n elements: vectors of 8 first, then the last
// n % 8 elements by the first threads of block 0.
template <class Tag>
__global__ void __launch_bounds__(GELU_THREADS)
quick_gelu_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                       int64_t n) {
  const int64_t vecs = n / 8;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * GELU_THREADS *
                            GELU_VECS + threadIdx.x;
  uint4 v[GELU_VECS];
#pragma unroll
  for (int k = 0; k < GELU_VECS; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * GELU_THREADS;
    if (i < vecs) v[k] = reinterpret_cast<const uint4*>(x)[i];
  }
#pragma unroll
  for (int k = 0; k < GELU_VECS; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * GELU_THREADS;
    if (i < vecs) {
      float f[8];
      unpack8(v[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = quick_gelu1(f[j]);
      reinterpret_cast<uint4*>(y)[i] = pack8(f);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - vecs * 8) {
    const int64_t i = vecs * 8 + threadIdx.x;
    y[i] = __float2bfloat16_rn(quick_gelu1(__bfloat162float(x[i])));
  }
}

struct EltScaleAddLayerNorm {};

// s[r] = bf16(x[r] + bf16(bf16(gamma) * a[r])) and out[r] = bf16(LN_f32(s[r])).
template <class Tag, int VECS>
__global__ void __launch_bounds__(ROW_THREADS)
scale_add_layer_norm_bf16_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ a,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ ls,
                                 const float* __restrict__ lb,
                                 bf16* __restrict__ s, bf16* __restrict__ out,
                                 int M, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (r >= M) return;
  const size_t base = static_cast<size_t>(r) * D;
  uint4 v[VECS], w[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      v[k] = *reinterpret_cast<const uint4*>(x + base + c);
      w[k] = *reinterpret_cast<const uint4*>(a + base + c);
    }
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      float fx[8], fa[8];
      unpack8(v[k], fx);
      unpack8(w[k], fa);
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float gb = __bfloat162float(__float2bfloat16_rn(g[j]));
        const float p = __bfloat162float(
            __float2bfloat16_rn(__fmul_rn(fa[j], gb)));
        fx[j] = __fadd_rn(fx[j], p);
      }
      v[k] = pack8(fx);
      *reinterpret_cast<uint4*>(s + base + c) = v[k];
    }
  }
  ln_row_store<VECS>(v, D, ls, lb, eps, out + base, nullptr, r, M);
}

// silu of one element as PyTorch's CUDA kernel computes it in f32.
__device__ __forceinline__ float silu1(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

struct EltSwiGlu {};

// y[r, c] = bf16(bf16(silu(u[r, c])) * u[r, I + c]) for u (M, 2I), y (M, I).
// Block b takes row b / chunks, vectors (b % chunks) * SWIGLU_THREADS *
// SWIGLU_VECS onwards of its I / 8.
template <class Tag>
__global__ void __launch_bounds__(SWIGLU_THREADS)
swiglu_bf16_kernel(const bf16* __restrict__ u, bf16* __restrict__ y,
                   int inter, int chunks) {
  const int row = blockIdx.x / chunks;
  const int vecs = inter / 8;
  const int first = (blockIdx.x % chunks) * SWIGLU_THREADS * SWIGLU_VECS +
                    threadIdx.x;
  const uint4* gate = reinterpret_cast<const uint4*>(
      u + static_cast<size_t>(row) * 2 * inter);
  const uint4* up = gate + vecs;
  uint4* dst = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * inter);
  uint4 g[SWIGLU_VECS], h[SWIGLU_VECS];
#pragma unroll
  for (int k = 0; k < SWIGLU_VECS; ++k) {
    const int i = first + k * SWIGLU_THREADS;
    if (i < vecs) {
      g[k] = gate[i];
      h[k] = up[i];
    }
  }
#pragma unroll
  for (int k = 0; k < SWIGLU_VECS; ++k) {
    const int i = first + k * SWIGLU_THREADS;
    if (i < vecs) {
      float fg[8], fh[8];
      unpack8(g[k], fg);
      unpack8(h[k], fh);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sg = __bfloat162float(__float2bfloat16_rn(silu1(fg[j])));
        fg[j] = __fmul_rn(sg, fh[j]);
      }
      dst[i] = pack8(fg);
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct EltLayerNormBwd {};
struct EltAddLayerNormBwd {};

// The LayerNorm's input gradient over the rows r = warp, warp + warps, ...
// of the grid, each row a warp's as in the forward: with x_hat = (x - mean)
// rstd (the forward's saved statistics) and g = gamma dy,
//
//   dx = bf16((D g - sum(g) - x_hat sum(g x_hat)) (rstd / D)),
//
// PyTorch's `compute_gI` form, in f32. RESID adds the residual stream's
// gradient: dx = bf16(ds + dx), the bf16 sum autograd forms. WGRAD keeps
// each lane's sums of dy x_hat and dy for its columns over its rows, then
// the block's sums of those, in warp order, to partial[block] (2, D).
template <class Tag, int VECS, bool RESID, bool WGRAD>
__global__ void __launch_bounds__(ROW_THREADS)
layer_norm_bwd_bf16_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ dy,
                           const bf16* __restrict__ ds,
                           const float* __restrict__ stats,
                           const float* __restrict__ ls,
                           bf16* __restrict__ dx, float* __restrict__ partial,
                           int M, int D) {
  constexpr int WARPS = ROW_THREADS / 32;
  constexpr int ACC = WGRAD ? VECS * 8 : 1;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float gacc[ACC], bacc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) gacc[i] = bacc[i] = 0.0f;
  const float fd = static_cast<float>(D);
  for (int r = blockIdx.x * WARPS + warp; r < M; r += gridDim.x * WARPS) {
    const size_t base = static_cast<size_t>(r) * D;
    uint4 xv[VECS], gv[VECS];
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int c = (lane + 32 * k) * 8;
      if (c < D) {
        xv[k] = *reinterpret_cast<const uint4*>(x + base + c);
        gv[k] = *reinterpret_cast<const uint4*>(dy + base + c);
      }
    }
    const float mean = stats[r];
    const float rstd = stats[static_cast<size_t>(M) + r];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int c = (lane + 32 * k) * 8;
      if (c < D) {
        float fx[8], fg[8];
        unpack8(xv[k], fx);
        unpack8(gv[k], fg);
        const float4 g0 = *reinterpret_cast<const float4*>(ls + c);
        const float4 g1 = *reinterpret_cast<const float4*>(ls + c + 4);
        const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = __fmul_rn(__fsub_rn(fx[j], mean), rstd);
          const float g = __fmul_rn(fg[j], gm[j]);
          s1 = __fadd_rn(s1, g);
          s2 = __fmaf_rn(g, xh, s2);
          if constexpr (WGRAD) {
            gacc[k * 8 + j] = __fmaf_rn(fg[j], xh, gacc[k * 8 + j]);
            bacc[k * 8 + j] = __fadd_rn(bacc[k * 8 + j], fg[j]);
          }
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float term = __fmul_rn(__frcp_rn(fd), rstd);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int c = (lane + 32 * k) * 8;
      if (c < D) {
        float fx[8], fg[8], fs[8];
        unpack8(xv[k], fx);
        unpack8(gv[k], fg);
        if constexpr (RESID) {
          unpack8(*reinterpret_cast<const uint4*>(ds + base + c), fs);
        }
        const float4 g0 = *reinterpret_cast<const float4*>(ls + c);
        const float4 g1 = *reinterpret_cast<const float4*>(ls + c + 4);
        const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = __fmul_rn(__fsub_rn(fx[j], mean), rstd);
          float f = __fmul_rn(__fmul_rn(fd, gm[j]), fg[j]);
          f = __fmaf_rn(-xh, s2, f);
          f = __fsub_rn(f, s1);
          f = __fmul_rn(f, term);
          if constexpr (RESID) {
            fx[j] = __fadd_rn(fs[j], round_bf16(f));
          } else {
            fx[j] = f;
          }
        }
        *reinterpret_cast<uint4*>(dx + base + c) = pack8(fx);
      }
    }
  }
  if constexpr (WGRAD) {
    // One vector slot at a time: each warp's 256 sums of slot k, then
    // thread t adds column k * 256 + t over the warps in order.
    __shared__ float red[2][WARPS][256];
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[0][warp][lane * 8 + j] = gacc[k * 8 + j];
        red[1][warp][lane * 8 + j] = bacc[k * 8 + j];
      }
      __syncthreads();
      const int c = k * 256 + threadIdx.x;
      if (c < D) {
        float g = 0.0f, b = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          g = __fadd_rn(g, red[0][w][threadIdx.x]);
          b = __fadd_rn(b, red[1][w][threadIdx.x]);
        }
        float* dst = partial + static_cast<size_t>(blockIdx.x) * 2 * D;
        dst[c] = g;
        dst[D + c] = b;
      }
    }
  }
}

struct EltLayerNormParamGrad {};

// dgamma[c] = sum_b partial[b, 0, c] and dbeta[c] = sum_b partial[b, 1, c]
// over the `blocks` partial rows: a block takes 32 columns, warp w the rows
// w, w + 8, ..., then warp 0 adds the eight in order. No atomics: the
// sums are the same from run to run.
template <class Tag>
__global__ void __launch_bounds__(ROW_THREADS)
ln_param_grad_kernel(const float* __restrict__ partial,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int blocks, int D) {
  constexpr int WARPS = ROW_THREADS / 32;
  __shared__ float red[2][WARPS][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float g = 0.0f, b = 0.0f;
  if (c < D) {
    for (int i = warp; i < blocks; i += WARPS) {
      const float* row = partial + static_cast<size_t>(i) * 2 * D;
      g = __fadd_rn(g, row[c]);
      b = __fadd_rn(b, row[D + c]);
    }
  }
  red[0][warp][lane] = g;
  red[1][warp][lane] = b;
  __syncthreads();
  if (warp == 0 && c < D) {
    g = 0.0f;
    b = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      g = __fadd_rn(g, red[0][w][lane]);
      b = __fadd_rn(b, red[1][w][lane]);
    }
    dgamma[c] = g;
    dbeta[c] = b;
  }
}

// Packed bf16 operations, each rounded on its own: the explicit .rn keeps
// ptxas from contracting a product and a sum into one fma.
#define PIGEON_BF16X2_OP(NAME, OP)                                          \
  __device__ __forceinline__ __nv_bfloat162 NAME(__nv_bfloat162 a,          \
                                                 __nv_bfloat162 b) {        \
    unsigned d;                                                            \
    asm(OP " %0, %1, %2;"                                                  \
        : "=r"(d)                                                          \
        : "r"(*reinterpret_cast<unsigned*>(&a)),                           \
          "r"(*reinterpret_cast<unsigned*>(&b)));                          \
    return *reinterpret_cast<__nv_bfloat162*>(&d);                         \
  }
PIGEON_BF16X2_OP(mul_bf16x2, "mul.rn.bf16x2")
PIGEON_BF16X2_OP(sub_bf16x2, "sub.rn.bf16x2")
PIGEON_BF16X2_OP(add_bf16x2, "add.rn.bf16x2")
#undef PIGEON_BF16X2_OP

// The gradient of quick-GELU at a pair of u for dy, as eager autograd
// forms it on the card for y = u * s, s = sigmoid(t), t = 1.702 u: t and
// s again as the forward rounds them, then du1 = bf16(dy s), ds =
// bf16(dy u), dt = ds (1 - s) s with every operation rounded to bf16
// (PyTorch's CUDA sigmoid_backward computes in the tensor's type, its CPU
// one in f32), du2 = bf16(1.702 dt) (the f32 product, then bf16) and du =
// bf16(du1 + du2). A product of two bf16 values is exact in f32, and so
// is a sum or difference unless one operand is under 2^-15 of the other,
// which both roundings then return: each f32 operation rounded to bf16 is
// the correctly rounded bf16 operation, so those six run as packed bf16x2
// instructions.
__device__ __forceinline__ __nv_bfloat162 quick_gelu_bwd2(__nv_bfloat162 u,
                                                         __nv_bfloat162 dy) {
  const float k = static_cast<float>(1.702);
  const float2 uf = __bfloat1622float2(u);
  const float2 t = __bfloat1622float2(
      __floats2bfloat162_rn(__fmul_rn(uf.x, k), __fmul_rn(uf.y, k)));
  const __nv_bfloat162 s = __floats2bfloat162_rn(
      __frcp_rn(__fadd_rn(1.0f, expf(-t.x))),
      __frcp_rn(__fadd_rn(1.0f, expf(-t.y))));
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const __nv_bfloat162 dt =
      mul_bf16x2(mul_bf16x2(mul_bf16x2(dy, u), sub_bf16x2(one, s)), s);
  const float2 dtf = __bfloat1622float2(dt);
  const __nv_bfloat162 du2 =
      __floats2bfloat162_rn(__fmul_rn(dtf.x, k), __fmul_rn(dtf.y, k));
  return add_bf16x2(mul_bf16x2(dy, s), du2);
}

struct EltQuickGeluBwd {};

// du = quick_gelu'(u) dy over n elements, laid out as the forward's grid.
template <class Tag>
__global__ void __launch_bounds__(GELU_THREADS)
quick_gelu_bwd_bf16_kernel(const bf16* __restrict__ u,
                           const bf16* __restrict__ dy,
                           bf16* __restrict__ du, int64_t n) {
  const int64_t vecs = n / 8;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * GELU_THREADS *
                            GELU_VECS + threadIdx.x;
  uint4 v[GELU_VECS], g[GELU_VECS];
#pragma unroll
  for (int k = 0; k < GELU_VECS; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * GELU_THREADS;
    if (i < vecs) {
      v[k] = reinterpret_cast<const uint4*>(u)[i];
      g[k] = reinterpret_cast<const uint4*>(dy)[i];
    }
  }
#pragma unroll
  for (int k = 0; k < GELU_VECS; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * GELU_THREADS;
    if (i < vecs) {
      __nv_bfloat162* pu = reinterpret_cast<__nv_bfloat162*>(&v[k]);
      const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&g[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) pu[j] = quick_gelu_bwd2(pu[j], pg[j]);
      reinterpret_cast<uint4*>(du)[i] = v[k];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - vecs * 8) {
    const int64_t i = vecs * 8 + threadIdx.x;
    du[i] = quick_gelu_bwd2(__bfloat162bfloat162(u[i]),
                            __bfloat162bfloat162(dy[i])).x;
  }
}

inline int row_blocks(int M) {
  constexpr int rows = ROW_THREADS / 32;
  return (M + rows - 1) / rows;
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Calls CALL(VECS) for VECS = ceil(dim / 256), the instance of a row kernel
// for dim.
#define PIGEON_ELT_VECS(CALL) \
  switch ((dim + 255) / 256) { \
    case 1: CALL(1); break; \
    case 2: CALL(2); break; \
    case 3: CALL(3); break; \
    case 4: CALL(4); break; \
    case 5: CALL(5); break; \
    case 6: CALL(6); break; \
    case 7: CALL(7); break; \
    case 8: CALL(8); break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// x (rows, dim) bf16, ln_scale/ln_bias (dim,) f32 -> out (rows, dim) bf16
// on `stream`, and where `stats` is not null each row's f32 mean and rstd
// to stats (2, rows). Returns the launch's cudaError_t (0 on success).
int pigeon_layer_norm_bf16(const void* x, const void* ln_scale,
                           const void* ln_bias, void* out, int rows, int dim,
                           float eps, void* stats, void* stream) {
  if (rows < 1 || dim < 8 || dim % 8 || dim > 8 * 32 * MAX_VECS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIGEON_LN(V)                                                      \
  layer_norm_bf16_kernel<EltLayerNorm, V>                                 \
      <<<row_blocks(rows), ROW_THREADS, 0, st>>>(                         \
          static_cast<const bf16*>(x), static_cast<const float*>(ln_scale), \
          static_cast<const float*>(ln_bias), static_cast<bf16*>(out),    \
          static_cast<float*>(stats), rows, dim, eps)
  PIGEON_ELT_VECS(PIGEON_LN)
#undef PIGEON_LN
  return static_cast<int>(cudaGetLastError());
}

// x, a (rows, dim) bf16, ln_scale/ln_bias (dim,) f32 -> sum = x + a and
// out = LN(sum), both (rows, dim) bf16, on `stream`; `stats` as above.
int pigeon_add_layer_norm_bf16(const void* x, const void* a,
                               const void* ln_scale, const void* ln_bias,
                               void* sum, void* out, int rows, int dim,
                               float eps, void* stats, void* stream) {
  if (rows < 1 || dim < 8 || dim % 8 || dim > 8 * 32 * MAX_VECS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIGEON_ADD_LN(V)                                                  \
  add_layer_norm_bf16_kernel<EltAddLayerNorm, V>                          \
      <<<row_blocks(rows), ROW_THREADS, 0, st>>>(                         \
          static_cast<const bf16*>(x), static_cast<const bf16*>(a),       \
          static_cast<const float*>(ln_scale),                            \
          static_cast<const float*>(ln_bias), static_cast<bf16*>(sum),    \
          static_cast<bf16*>(out), static_cast<float*>(stats), rows, dim, \
          eps)
  PIGEON_ELT_VECS(PIGEON_ADD_LN)
#undef PIGEON_ADD_LN
  return static_cast<int>(cudaGetLastError());
}

// x, a (rows, dim) bf16, gamma/ln_scale/ln_bias (dim,) f32 -> sum = x +
// gamma a and out = LN(sum), both (rows, dim) bf16, on `stream`.
int pigeon_scale_add_layer_norm_bf16(const void* x, const void* a,
                                     const void* gamma, const void* ln_scale,
                                     const void* ln_bias, void* sum,
                                     void* out, int rows, int dim, float eps,
                                     void* stream) {
  if (rows < 1 || dim < 8 || dim % 8 || dim > 8 * 32 * MAX_VECS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PIGEON_SCALE_ADD_LN(V)                                            \
  scale_add_layer_norm_bf16_kernel<EltScaleAddLayerNorm, V>               \
      <<<row_blocks(rows), ROW_THREADS, 0, st>>>(                         \
          static_cast<const bf16*>(x), static_cast<const bf16*>(a),       \
          static_cast<const float*>(gamma),                               \
          static_cast<const float*>(ln_scale),                            \
          static_cast<const float*>(ln_bias), static_cast<bf16*>(sum),    \
          static_cast<bf16*>(out), rows, dim, eps)
  PIGEON_ELT_VECS(PIGEON_SCALE_ADD_LN)
#undef PIGEON_SCALE_ADD_LN
  return static_cast<int>(cudaGetLastError());
}

// u (rows, 2 inter) bf16 -> out (rows, inter) bf16 = silu(u[:, :inter]) *
// u[:, inter:] on `stream`.
int pigeon_swiglu_bf16(const void* u, void* out, int rows, int inter,
                       void* stream) {
  if (rows < 1 || inter < 8 || inter % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int per_block = SWIGLU_THREADS * SWIGLU_VECS;
  const int chunks = (inter / 8 + per_block - 1) / per_block;
  if (static_cast<int64_t>(rows) * chunks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swiglu_bf16_kernel<EltSwiGlu>
      <<<rows * chunks, SWIGLU_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(u),
                                              static_cast<bf16*>(out), inter,
                                              chunks);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, dim) bf16, the forward's stats (2, rows) f32, dy (rows, dim) bf16
// and ln_scale (dim,) f32 -> dx (rows, dim) bf16, the LayerNorm's input
// gradient, on `stream`. Where `ds` (rows, dim) bf16 is not null, dx = ds +
// that, rounded as autograd's sum. Where `partial` is not null, `blocks`
// blocks take the rows, write their column sums to partial (blocks, 2, dim)
// f32, and a second launch sums those to dgamma and dbeta (dim,) f32;
// else one warp a row.
int pigeon_layer_norm_bwd_bf16(const void* x, const void* dy, const void* ds,
                               const void* stats, const void* ln_scale,
                               void* dx, void* partial, void* dgamma,
                               void* dbeta, int rows, int dim, int blocks,
                               void* stream) {
  if (rows < 1 || dim < 8 || dim % 8 || dim > 8 * 32 * MAX_VECS ||
      (partial != nullptr && blocks < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = partial != nullptr ? blocks : row_blocks(rows);
#define PIGEON_LN_BWD_ARGS                                                \
  <<<grid, ROW_THREADS, 0, st>>>(                                         \
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),          \
      static_cast<const bf16*>(ds), static_cast<const float*>(stats),     \
      static_cast<const float*>(ln_scale), static_cast<bf16*>(dx),        \
      static_cast<float*>(partial), rows, dim)
#define PIGEON_LN_BWD(V)                                                  \
  if (ds == nullptr && partial == nullptr) {                              \
    layer_norm_bwd_bf16_kernel<EltLayerNormBwd, V, false, false>          \
        PIGEON_LN_BWD_ARGS;                                               \
  } else if (ds == nullptr) {                                             \
    layer_norm_bwd_bf16_kernel<EltLayerNormBwd, V, false, true>           \
        PIGEON_LN_BWD_ARGS;                                               \
  } else if (partial == nullptr) {                                        \
    layer_norm_bwd_bf16_kernel<EltAddLayerNormBwd, V, true, false>        \
        PIGEON_LN_BWD_ARGS;                                               \
  } else {                                                                \
    layer_norm_bwd_bf16_kernel<EltAddLayerNormBwd, V, true, true>         \
        PIGEON_LN_BWD_ARGS;                                               \
  }
  PIGEON_ELT_VECS(PIGEON_LN_BWD)
#undef PIGEON_LN_BWD
#undef PIGEON_LN_BWD_ARGS
  if (partial != nullptr) {
    ln_param_grad_kernel<EltLayerNormParamGrad>
        <<<(dim + 31) / 32, ROW_THREADS, 0, st>>>(
            static_cast<const float*>(partial), static_cast<float*>(dgamma),
            static_cast<float*>(dbeta), blocks, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

// u, dy (n,) bf16 -> du (n,) bf16, quick-GELU's gradient, on `stream`.
int pigeon_quick_gelu_bwd_bf16(const void* u, const void* dy, void* du,
                               int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(GELU_THREADS) * GELU_VECS;
  const int64_t blocks = (n / 8 + per_block - 1) / per_block;
  quick_gelu_bwd_bf16_kernel<EltQuickGeluBwd>
      <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), GELU_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(u), static_cast<const bf16*>(dy),
          static_cast<bf16*>(du), n);
  return static_cast<int>(cudaGetLastError());
}

// x (n,) bf16 -> out (n,) bf16 = quick_gelu(x) on `stream`.
int pigeon_quick_gelu_bf16(const void* x, void* out, int64_t n,
                           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(GELU_THREADS) * GELU_VECS;
  const int64_t blocks = (n / 8 + per_block - 1) / per_block;
  quick_gelu_bf16_kernel<EltQuickGelu>
      <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), GELU_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x),
                                              static_cast<bf16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
