// Int8 attention half of a transformer block in one call, for Hopper
// (sm_90a): LayerNorm + shared-scale quantize + int8 QKV projection + bf16
// softmax attention + quantize + int8 output projection + residual.
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_block_attn_int8_kernel
// (launcher and entry `fused_block_attention_int8`, reached on a static
// int8 tower under PIGEON_QUANT_ATTN_IMPL=flash_fused_block). For x (B, S,
// D) raw, the per-tensor activation scales a_qkv (of q/k/v's shared input)
// and ao (of the out-projection's input), int8 weights in torch Linear
// layout with per-channel scales, it computes, at the TPU kernel's
// rounding points:
//
//     xn  = bf16(LN_f32(x))                 Flax's fast variance
//     xq  = clip(rint(f32(xn) / a_qkv), +-127)                     int8
//     q,k,v = bf16(f32(xq @ W*^T) * (a_qkv s*) + b*)  (int32 accumulate)
//     o   = K8's attention body                                    bf16
//     oq  = clip(rint(f32(o) / ao), +-127)                         int8
//     out = bf16((x + bo) + f32(oq @ Wo^T) * (ao so)) (int32 accumulate)
//
// Every rounding the JAX kernel has is kept and nothing is contracted into
// an FMA (__fmul_rn, __fadd_rn, __fdiv_rn): a one-ulp difference before a
// quantize flips round() (pigeon_tpu/cli/run.py:191-199), so the LayerNorm
// and both dequant epilogues take the plain version's order. Quantizes
// divide by the scale, as the JAX kernel does, and round half to even
// (rintf). The TPU kernel sums per-group f32 partials of the
// out-projection (po_g * svo); this kernel sums all of D in one int32
// accumulator (exact: |oq . wo| <= 127^2 * D < 2^24 up to D = 1040) and
// dequantizes once.
//
// What bounds it on the H100: at the serving shape (B=4 views, S=577,
// D=1024, H=16) the four int8 projections are ~19.4 G int8 operations
// (~0.0098 ms at 1,979 TOP/s) and the attention 5.45 GFLOP of bf16
// (~0.0055 ms); x, the four int8 weights and out are ~14 MB (~0.004 ms).
// The design is three launches behind one entry point:
//
//   1. LN + quantize: one warp a row takes the row's mean and rsqrt(var +
//      eps), then normalises, rounds to bf16 and quantizes by a_qkv into
//      an (M = B*S, D) int8 workspace (2.4 MB): x is normalised once, not
//      once for each of a batch's head blocks;
//   2. K8's block body (attention_tile.cuh's
//      `fused_qkv_attention_int8_block`: one block per (head, batch),
//      int8 x int8 -> int32 WMMA projections, that head's K and V resident
//      as bf16) writing the bf16 attention output o to an (M, D) workspace;
//   3. the int8 GEMM of gemm_tile.cuh (128 x 128 tiles, K in 64-byte
//      steps, Wo's tiles double-buffered by cp.async) whose A tiles are o
//      quantized by ao as they are staged, with the dequant, bo and
//      residual epilogue in f32.
//
// The activation scales arrive as device pointers to f32 scalars, so no
// launch waits for the host. The folded scales a_qkv s* and ao so are
// formed by the wrapper.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// H * 64 = D, D a multiple of 128, S <= pigeon_fused_block_attention_int8_max_seq();
// x and out bf16, weights int8, scales, biases and LN parameters f32, all
// contiguous and 16-byte aligned.

#include "attention_tile.cuh"
#include "gemm_tile.cuh"

namespace {

__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, INT8_WORK_BYTES);
}

// clip(rint(v / a), -127, 127) as int8: a true division, half to even.
__device__ __forceinline__ int8_t quantize(float v, float a) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(__fdiv_rn(v, a)), -127.0f), 127.0f));
}

// Launch 1: xq[m, :] = quantize(bf16(LN(x[m, :])), a_qkv), one warp a row.
__global__ void __launch_bounds__(THREADS)
ln_quantize_kernel(const bf16* __restrict__ x,
                   const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias,
                   const float* __restrict__ a_qkv, int8_t* __restrict__ xq,
                   int M, int D, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (THREADS / 32) + warp;
  if (m >= M) return;
  const bf16* row = x + (size_t)m * D;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s1 = __fadd_rn(s1, f);
      s2 = __fadd_rn(s2, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = __fdiv_rn(s1, static_cast<float>(D));
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn(s2, static_cast<float>(D)), __fmul_rn(mean, mean)),
      0.0f);
  const float rs = rsqrtf(__fadd_rn(var, eps));
  const float a = *a_qkv;
  int8_t* out = xq + (size_t)m * D;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    __align__(8) int8_t q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xn = __bfloat162float(__float2bfloat16(__fadd_rn(
          __fmul_rn(__fsub_rn(__bfloat162float(e[j]), mean),
                    __fmul_rn(rs, ln_scale[c + j])),
          ln_bias[c + j])));
      q[j] = quantize(xn, a);
    }
    *reinterpret_cast<uint2*>(out + c) = *reinterpret_cast<const uint2*>(q);
  }
}

// Launch 2: K8's block body on the quantized rows.
__global__ void __launch_bounds__(THREADS, 1)
attention_int8_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const int8_t* __restrict__ wk, const int8_t* __restrict__ wv,
    const float* __restrict__ fsq, const float* __restrict__ fsk,
    const float* __restrict__ fsv, const float* __restrict__ bq,
    const float* __restrict__ bk, const float* __restrict__ bv,
    bf16* __restrict__ o, int S, int D, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  fused_qkv_attention_int8_block(smem, xq + (size_t)blockIdx.y * S * D, wq,
                                 wk, wv, fsq, fsk, fsv, bq, bk, bv, o, S, D,
                                 H, scale);
}

// Launch 3: out[m, n] = bf16((x + bo) + f32(sum_k oq[m, k] wo[n, k]) *
// fso[n]) with oq = quantize(o, ao) formed while staging.
__global__ void __launch_bounds__(gemm::THREADS)
out_proj_int8_kernel(const bf16* __restrict__ o,
                     const float* __restrict__ ao,
                     const int8_t* __restrict__ wo,
                     const float* __restrict__ fso,
                     const float* __restrict__ bo,
                     const bf16* __restrict__ x, bf16* __restrict__ out,
                     int M, int D) {
  __shared__ __align__(128) unsigned char smem[gemm::SMEM_BYTES];
  const int m0 = blockIdx.x * gemm::BM;
  const int n0 = blockIdx.y * gemm::BN;
  const float a = *ao;
  auto load_a = [&](int8_t* as, int k0) {
    constexpr int VECS = gemm::BK8 / gemm::SUB;  // sub-tiles per row
    for (int i = threadIdx.x; i < gemm::BM * VECS; i += gemm::THREADS) {
      const int r = i / VECS;
      const int v = i % VECS;
      const int m = m0 + r;
      __align__(16) int8_t q[16] = {};
      if (m < M) {
        const uint4* src = reinterpret_cast<const uint4*>(
            o + (size_t)m * D + k0 + v * gemm::SUB);
        const uint4 raw[2] = {src[0], src[1]};
        const bf16* e = reinterpret_cast<const bf16*>(raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) q[j] = quantize(__bfloat162float(e[j]), a);
      }
      *reinterpret_cast<uint4*>(as + v * gemm::BM * gemm::SUB +
                                r * gemm::SUB) =
          *reinterpret_cast<const uint4*>(q);
    }
  };
  gemm::FragC8 acc[2][4];
  gemm::mma_int8(smem, load_a, wo, D, n0, acc);
  gemm::epilogue<int>(smem, acc, [&](int r, int c, const int* p) {
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M) return;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * D + n);
    const bf16* xe = reinterpret_cast<const bf16*>(&raw);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = __fadd_rn(__fadd_rn(__bfloat162float(xe[e]), bo[n + e]),
                       __fmul_rn(__int2float_rn(p[e]), fso[n + e]));
    }
    gemm::store8_bf16(out + (size_t)m * D + n, v);
  });
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V fit one block's shared memory.
int pigeon_fused_block_attention_int8_max_seq() {
  return resident_max_seq(INT8_WORK_BYTES);
}

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D) bf16 raw; ln_scale/ln_bias (D,) f32; a_qkv and ao f32
// scalars on the device; wq/wk/wv/wo (D, D) int8 in torch Linear layout;
// fsq/fsk/fsv (D,) = a_qkv * s*, fso (D,) = ao * so, bq/bk/bv/bo (D,), all
// f32; workspaces xq (B, S, D) int8 and o (B, S, D) bf16; out (B, S, D)
// bf16. All contiguous. Launches the three passes on `stream` and returns
// the first failing launch's cudaError_t (0 on success).
int pigeon_fused_block_attention_int8(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* a_qkv, const void* wq, const void* wk, const void* wv,
    const void* fsq, const void* fsk, const void* fsv, const void* bq,
    const void* bk, const void* bv, const void* ao, const void* wo,
    const void* fso, const void* bo, void* xq, void* o, void* out, int batch,
    int seq, int dim, int heads, float eps, void* stream) {
  const int s_pad = ((seq + TILE - 1) / TILE) * TILE;
  const int smem = smem_bytes(s_pad);
  if (batch < 1 || seq < 1 || heads < 1 || heads * DH != dim ||
      dim % gemm::BN != 0 || smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * seq;
  ln_quantize_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS,
                       0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(a_qkv),
      static_cast<int8_t*>(xq), rows, dim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_int8_kernel<<<dim3(heads, batch), THREADS, smem, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const int8_t*>(wk), static_cast<const int8_t*>(wv),
      static_cast<const float*>(fsq), static_cast<const float*>(fsk),
      static_cast<const float*>(fsv), static_cast<const float*>(bq),
      static_cast<const float*>(bk), static_cast<const float*>(bv),
      static_cast<bf16*>(o), seq, dim, heads,
      1.0f / sqrtf(static_cast<float>(DH)));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  out_proj_int8_kernel<<<dim3((rows + gemm::BM - 1) / gemm::BM,
                              dim / gemm::BN),
                         gemm::THREADS, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const float*>(ao),
      static_cast<const int8_t*>(wo), static_cast<const float*>(fso),
      static_cast<const float*>(bo), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), rows, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
