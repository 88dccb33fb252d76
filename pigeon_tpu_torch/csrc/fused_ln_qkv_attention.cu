// LayerNorm + fused QKV projection + softmax attention forward, for Hopper
// (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_ln_qkv_kernel
// (launcher `_fused_ln_qkv_forward`, reached through `fused_ln_qkv_mha` on
// the `flash_fused_ln` and `flash_fused_mlp` routes): K1 with the
// pre-attention LayerNorm folded in. x arrives raw (before LN1); for each
// (batch, head) it computes
//
//     xn = bf16((x - mean) * (rsqrt(var + eps) * ln_scale) + ln_bias),
//          mean, var = E[x], max(E[x^2] - E[x]^2, 0) over D in f32
//     q, k, v = bf16(xn @ W*_h^T + b*_h)                (f32 accumulate)
//     out[:, h*64:(h+1)*64] = bf16((bf16(p) @ v) / sum(p))
//
// Flax's fast-variance LayerNorm, in its association order
// (flash_attention.py::_layer_norm_f32), with xn never written to device
// memory, as on the TPU.
//
// What bounds it on the H100: K1's work (~20 GFLOP of bf16 tensor-core
// products over ~16 MB at the serving shape B=4, S=577, D=1024, H=16)
// plus the LayerNorm, ~4 FLOP per element of x: the tensor cores bound it.
// The design is K1's (`fused_qkv_attention_block` of attention_tile.cuh:
// one block per (head, batch), that head's K and V resident in shared
// memory, x streamed in 64 x 64 tiles) with two changes. A prologue takes
// each row's mean and rsqrt(var + eps) over D in f32, one warp a row, into
// shared memory (2 x S_pad floats, 5 KB at S=577, after K1's 215 KB); and
// each streamed x tile is normalised, scaled and biased in f32 as it is
// staged, then rounded to bf16. Each of a batch's H blocks recomputes its
// rows' statistics (16 reads of x from L2 at H=16), the TPU kernel's
// per-group redundancy.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// D a multiple of 64, S <= pigeon_fused_ln_qkv_attention_max_seq(), x,
// weights and biases bf16, ln_scale and ln_bias f32, all contiguous and
// 16-byte aligned. Ragged S is masked as in K1: tiles past S are staged as
// zeros, excluded from the softmax and never written.

#include "attention_tile.cuh"

namespace {

// Shared memory: K1's resident K/V and work area, then the row statistics.
__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, QKV_WORK_BYTES) + 2 * s_pad * 4;
}

// Stage x[0:64, 0:64] (global row stride `ld`) normalised: row r gets
// (x - mu[r]) * (rs[r] * ls[c]) + lb[c] in f32, rounded to bf16; rows at
// or past `rows` are zeros.
__device__ __forceinline__ void stage_ln_tile(bf16* dst, const bf16* src,
                                              int ld, int rows,
                                              const float* mu,
                                              const float* rs,
                                              const float* ls,
                                              const float* lb) {
  constexpr int VEC = 64 / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < TILE * VEC; i += THREADS) {
    const int r = i / VEC;
    const int c = (i % VEC) * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      bf16* o = reinterpret_cast<bf16*>(&packed);
      const float m = mu[r], s = rs[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16(
            (__bfloat162float(e[j]) - m) * (s * ls[c + j]) + lb[c + j]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = packed;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ln_qkv_attention_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const bf16* __restrict__ wq,
                              const bf16* __restrict__ wk,
                              const bf16* __restrict__ wv,
                              const bf16* __restrict__ bq,
                              const bf16* __restrict__ bk,
                              const bf16* __restrict__ bv,
                              bf16* __restrict__ out, int S, int D, int H,
                              float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_pad = ((S + TILE - 1) / TILE) * TILE;
  float* mu = reinterpret_cast<float*>(
      smem + resident_smem_bytes(s_pad, QKV_WORK_BYTES));
  float* rs = mu + s_pad;
  const bf16* xb = x + (size_t)blockIdx.y * S * D;

  // Row statistics, one warp a row: f32 sums of x and x^2 over D.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < S; r += THREADS / 32) {
    const bf16* row = xb + (size_t)r * D;
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
      mu[r] = mean;
      rs[r] = rsqrtf(fmaxf(s2 / D - mean * mean, 0.0f) + eps);
    }
  }
  __syncthreads();

  fused_qkv_attention_block(
      smem,
      [&](bf16* dst, int r0, int d0, int rows) {
        stage_ln_tile(dst, xb + (size_t)r0 * D + d0, D, rows, mu + r0,
                      rs + r0, ln_scale + d0, ln_bias + d0);
      },
      wq, wk, wv, bq, bk, bv, out, S, D, H, scale);
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V and row statistics fit one block's
// shared memory.
int pigeon_fused_ln_qkv_attention_max_seq() {
  int s_pad = TILE;
  while (smem_bytes(s_pad + TILE) <= MAX_SMEM) s_pad += TILE;
  return s_pad;
}

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D) bf16 raw; ln_scale/ln_bias (D,) f32; wq/wk/wv (H*64, D) in
// torch Linear layout and bq/bk/bv (H*64,), bf16; out (B, S, H*64) bf16.
// All contiguous. Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
int pigeon_fused_ln_qkv_attention(const void* x, const void* ln_scale,
                                  const void* ln_bias, const void* wq,
                                  const void* wk, const void* wv,
                                  const void* bq, const void* bk,
                                  const void* bv, void* out, int batch,
                                  int seq, int dim, int heads, float eps,
                                  void* stream) {
  const int s_pad = ((seq + TILE - 1) / TILE) * TILE;
  const int smem = smem_bytes(s_pad);
  if (batch < 1 || seq < 1 || heads < 1 || dim % QKV_KC != 0 ||
      smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_ln_qkv_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  fused_ln_qkv_attention_kernel<<<grid, THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
      static_cast<const bf16*>(bv), static_cast<bf16*>(out), seq, dim, heads,
      1.0f / sqrtf(static_cast<float>(DH)), eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
