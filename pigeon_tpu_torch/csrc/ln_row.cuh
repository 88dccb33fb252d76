// Flax's fast-variance LayerNorm (flash_attention.py::_layer_norm_f32) in
// its association order, one warp a row of bf16 x:
//
//     mean = E[x],  rs = rsqrt(max(E[x^2] - mean^2, 0) + eps)     (f32)
//     xn   = bf16((x - mean) * (rs * ln_scale) + ln_bias)          (f32)
//
// The one copy of this arithmetic: K5's LayerNorm kernel
// (fused_ln_qkv_attention.cu), K6's staging (ln_qkv_attention_tile.cuh) and
// K9's statistics and fc1 staging (fused_mlp.cu) all call it, so the three
// round xn alike. No other header is needed.

#pragma once

#include <cuda_bf16.h>
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
  const float mean = s1 / D;
  return {mean, rsqrtf(fmaxf(s2 / D - mean * mean, 0.0f) + eps)};
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
    o[j] = __float2bfloat16((__bfloat162float(e[j]) - mean) * (rs * ls[j]) +
                            lb[j]);
  }
  return packed;
}

}  // namespace
