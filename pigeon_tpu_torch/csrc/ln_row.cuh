// Flax's fast-variance LayerNorm (flash_attention.py::_layer_norm_f32) in
// its association order, one warp a row of bf16 x:
//
//     mean = E[x],  rs = rsqrt(max(E[x^2] - mean^2, 0) + eps)     (f32)
//     xn   = bf16((x - mean) * (rs * ln_scale) + ln_bias)          (f32)
//
// each product and sum rounded on its own (__fmul_rn, __fadd_rn), as the
// plain version's separate f32 ops: contracted into an FMA, xn could sit
// one ulp apart, and K7 quantizes it.
//
// The one copy of this arithmetic, and the LayerNorm kernel that writes xn
// (M, D) to a workspace, one warp a row: K5, K6 and K9
// (fused_ln_qkv_attention.cu, fused_block_attention.cu, fused_mlp.cu) each
// launch it under a tag of their own (K5LayerNorm, K6LayerNorm,
// K9LayerNorm) with the bf16 output policy, K7 (fused_block_attention_int8.cu,
// K7LayerNorm) with a policy that quantizes the bf16 xn to int8, so all
// round xn alike and a profile tells them apart. No other header is
// needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct LnStats {
  float mean;
  float rs;  // rsqrt(var + eps)
};

// The statistics of `row` (D bf16, D a multiple of 8, 16-byte aligned):
// the 32 lanes of a warp sum x and x^2 in f32 over 16-byte vectors, then a
// butterfly of shuffles gives every lane the totals. All 32 lanes call it.
__device__ __forceinline__ LnStats ln_warp_stats(
    const __nv_bfloat16* __restrict__ row, int D, float eps) {
  const int lane = threadIdx.x % 32;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
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
  const float mean = __fdiv_rn(s1, static_cast<float>(D));
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, static_cast<float>(D)),
                                    __fmul_rn(mean, mean)),
                          0.0f);
  return {mean, rsqrtf(__fadd_rn(var, eps))};
}

// Eight consecutive elements of a row (one 16-byte vector `raw`),
// normalised with the row's mean and rs, scaled and shifted by ls[0:8] and
// lb[0:8] (the LayerNorm's f32 parameters at the same columns) in f32, each
// rounded once to bf16.
__device__ __forceinline__ uint4 ln_normalise8(uint4 raw, float mean,
                                               float rs, const float* ls,
                                               const float* lb) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint4 packed;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j] = __float2bfloat16(__fadd_rn(
        __fmul_rn(__fsub_rn(__bfloat162float(e[j]), mean),
                  __fmul_rn(rs, ls[j])),
        lb[j]));
  }
  return packed;
}

constexpr int LN_THREADS = 256;  // eight warps, one row each

// The output policy of the bf16 LayerNorm: xn itself. `store8` takes eight
// bf16 of xn packed in `xn8` and the policy's scale (unused here).
struct LnOutBf16 {
  typedef __nv_bfloat16 T;
  static constexpr bool SCALED = false;
  __device__ static __forceinline__ void store8(T* dst, uint4 xn8, float) {
    *reinterpret_cast<uint4*>(dst) = xn8;
  }
};

// out[r] = Out(bf16((x[r] - mean) * (rs * ls) + lb)), rs = rsqrt(max(E[x^2]
// - E[x]^2, 0) + eps), over the M rows of x (M, D), D a multiple of 8;
// `out_scale` points to the f32 scale of a SCALED policy (else null).
// `Tag` names the user's instance.
template <class Tag, class Out>
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ ls, const float* __restrict__ lb,
                  typename Out::T* __restrict__ out,
                  const float* __restrict__ out_scale, int M, int D,
                  float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  if (r >= M) return;
  const __nv_bfloat16* row = x + static_cast<size_t>(r) * D;
  const LnStats stats = ln_warp_stats(row, D, eps);
  const float a = Out::SCALED ? *out_scale : 0.0f;
  typename Out::T* dst = out + static_cast<size_t>(r) * D;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    Out::store8(dst + c,
                ln_normalise8(*reinterpret_cast<const uint4*>(row + c),
                              stats.mean, stats.rs, ls + c, lb + c),
                a);
  }
}

// x (M, D) bf16 and ls/lb (D,) f32 to out (M, D) of the policy's type on
// `stream`, D a multiple of 8, all 16-byte aligned; `out_scale` a device
// pointer to the f32 scale of a SCALED policy. Returns the launch's error.
template <class Tag, class Out = LnOutBf16>
inline cudaError_t launch_layer_norm(const void* x, const void* ls,
                                     const void* lb, void* out, int M, int D,
                                     float eps, cudaStream_t stream,
                                     const float* out_scale = nullptr) {
  constexpr int rows = LN_THREADS / 32;
  layer_norm_kernel<Tag, Out><<<(M + rows - 1) / rows, LN_THREADS, 0,
                                stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<typename Out::T*>(out),
      out_scale, M, D, eps);
  return cudaGetLastError();
}

}  // namespace
