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
//     o   = K8's attention                                         bf16
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
// D=1024, H=16) the four int8 projections are 19.4 G int8 operations
// (0.0098 ms at 1,979 TOP/s) and the attention 5.45 GFLOP of bf16
// (0.0055 ms); x, the four int8 weights and out are ~14 MB (~0.004 ms).
// The design is K6's (fused_block_attention.cu) with int8 operands, four
// launches on the caller's stream:
//
//   1. LN1 + quantize (K7LayerNorm): ln_row.cuh's LayerNorm kernel, one
//      warp a row, with an output policy that quantizes the bf16 xn by
//      a_qkv into an (M = B*S, D) int8 workspace;
//   2. projection (K7Projection): q|k|v by gemm_sm90.cuh's persistent
//      wgmma GEMM on int8 operands with the dequant + bias epilogue, into
//      three (B, S, D) bf16 workspaces, and
//   3. attention (K7Attention): K3's streaming forward on them, its output
//      policy rounding o to bf16 and requantizing it by ao into the oq (B,
//      S, D) int8 workspace: K8's two stages (qkv_forward_sm90.cuh);
//   4. out-projection (K7OutProjection): the same GEMM on oq and Wo, its
//      epilogue adding x and bo and the dequantized sums, which prefetches
//      each tile's residual rows into L2 while the products run.
//
// The activation scales arrive as device pointers to f32 scalars, so no
// launch waits for the host. The folded scales a_qkv s* and ao so are
// formed by the wrapper. Each stage runs as its own grid over all rows;
// xq, q/k/v and oq make one round trip each through device memory. The
// attention rounds p against K3's running max over 128-key chunks, not
// the exact row max of the TPU kernel (K6's deviation).
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// H * 64 = D, D a multiple of 128, any S >= 1; x and out bf16, weights
// int8, scales, biases and LN parameters f32, all contiguous and 16-byte
// aligned; the workspaces xq and oq (B, S, D) int8, q/k/v (B, S, D) bf16.

#include "ln_row.cuh"
#include "qkv_forward_sm90.cuh"

namespace {

// This kernel's instances of the LayerNorm, the GEMMs and the attention.
struct K7LayerNorm {};
struct K7Projection {};
struct K7Attention {};
struct K7OutProjection {};

// The LayerNorm's output policy: xq = quantize(bf16 xn, a_qkv).
struct LnOutQuantized {
  typedef int8_t T;
  static constexpr bool SCALED = true;
  __device__ static __forceinline__ void store8(T* dst, uint4 xn8, float a) {
    const bf16* e = reinterpret_cast<const bf16*>(&xn8);
    __align__(8) int8_t q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = quantize_s8(__bfloat162float(e[j]), a);
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
  }
};

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D) bf16 raw; ln_scale/ln_bias (D,) f32; a_qkv and ao f32
// scalars on the device; wq/wk/wv/wo (D, D) int8 in torch Linear layout;
// fsq/fsk/fsv (D,) = a_qkv * s*, fso (D,) = ao * so, bq/bk/bv/bo (D,), all
// f32; out (B, S, D) bf16; the workspaces xq_ws and oq_ws (B, S, D) int8,
// q_ws/k_ws/v_ws (B, S, D) bf16. D = heads * 64. Launches the four stages
// on `stream` and returns the first failing call's cudaError_t (0 on
// success).
int pigeon_fused_block_attention_int8(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* a_qkv, const void* wq, const void* wk, const void* wv,
    const void* fsq, const void* fsk, const void* fsv, const void* bq,
    const void* bk, const void* bv, const void* ao, const void* wo,
    const void* fso, const void* bo, void* out, void* xq_ws, void* q_ws,
    void* k_ws, void* v_ws, void* oq_ws, int batch, int seq, int dim,
    int heads, float eps, void* stream) {
  if (heads * HD != dim || !qkv_forward_shape_ok(batch, seq, dim, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = batch * seq;

  // 1. xq = quantize(bf16(LN1(x)), a_qkv).
  cudaError_t err = launch_layer_norm<K7LayerNorm, LnOutQuantized>(
      x, ln_scale, ln_bias, xq_ws, M, dim, eps, st,
      static_cast<const float*>(a_qkv));
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2 and 3. oq = quantize(K8(xq), ao): the int8 projection GEMM, then
  // K3's streaming forward requantizing its output.
  const float* const scales[3] = {static_cast<const float*>(fsq),
                                  static_cast<const float*>(fsk),
                                  static_cast<const float*>(fsv)};
  err = launch_qkv_attention_forward<K7Projection, K7Attention,
                                     EpilogueDequantBias, AttnOutQuantized>(
      xq_ws, wq, wk, wv, bq, bk, bv, oq_ws, q_ws, k_ws, v_ws, batch, seq,
      dim, heads, st, scales, static_cast<const float*>(ao));
  if (err != cudaSuccess) return static_cast<int>(err);

  // 4. out = bf16((x + bo) + f32(oq Wo^T) * fso).
  const int8_t* const oq[1] = {static_cast<const int8_t*>(oq_ws)};
  const int8_t* const w[1] = {static_cast<const int8_t*>(wo)};
  const float* const bias[1] = {static_cast<const float*>(bo)};
  const float* const scale[1] = {static_cast<const float*>(fso)};
  bf16* const outs[1] = {static_cast<bf16*>(out)};
  const bf16* const residual[1] = {static_cast<const bf16*>(x)};
  return static_cast<int>(
      gemm_sm90<K7OutProjection, true, EpilogueResidualBiasDequant>(
          oq, w, bias, outs, M, dim, dim, dim, dim, st, residual, scale));
}

}  // extern "C"
