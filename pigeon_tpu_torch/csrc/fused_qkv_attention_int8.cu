// Int8 fused QKV projection + softmax attention forward, for Hopper
// (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_qkv_int8_kernel
// (reached through `fused_qkv_mha_int8`): the attention of every CLIP
// encoder layer on the int8 serving route (`serve --quant`). For each
// (batch, head), with x already quantized to int8 by the wrapper
// (x_q = clip(round(x / act_scale), +-127)):
//
//     q, k, v = bf16(f32(x_q @ W*_h^T) * fs*_h + b*_h)  (int32 accumulate)
//     out[:, h*64:(h+1)*64] = bf16((bf16(p) @ v) / sum(p)),
//     p = exp(s - max(s)),  s = (q k^T) * 64^-0.5        (f32 softmax)
//
// where fs* = act_scale * s* is the per-output-channel dequant scale with
// the activation scale folded in (by the wrapper, as the JAX wrapper
// does). The epilogue multiplies and then adds with two roundings
// (__fmul_rn, __fadd_rn: no contraction into an FMA), in the order XLA
// evaluates the JAX kernel's `y.astype(f32) * s + b`, so q/k/v equal the
// plain version's bit for bit; |x_q . w| <= 127^2 * D stays exact in f32
// up to D = 1040.
//
// What bounds it on the H100: at the serving shape (B=4 views, S=577,
// D=1024, H=16) the projections are 14.5 G int8 operations (0.0073 ms at
// 1,979 TOP/s) and the attention 5.5 GFLOP of bf16 (0.0055 ms) over ~10
// MB of operands (x_q 2.4 MB, the three int8 weights 3.1 MB, out 4.7 MB):
// far above the ridge, so the tensor cores bound it. The design is K1's
// (fused_qkv_attention.cu) with int8 operands, two launches on the
// caller's stream (qkv_forward_sm90.cuh):
//
//   1. projection (K8Projection): q|k|v by the persistent wgmma GEMM of
//      gemm_sm90.cuh on int8 operands ("A B^T", both K-major as 8-bit
//      wgmma wants them: x_q (B*S, D) row-major, [Wq; Wk; Wv] (3P, D) in
//      three N segments; m64n256k32 s8 products, s32 sums; TMA moves the
//      int8 tiles as UINT8, 128 values of K a 128-byte swizzled row) with
//      the dequant epilogue above, into three (B, S, P) bf16 workspaces;
//   2. attention (K8Attention): K3's streaming forward
//      (flash_fwd_sm90.cuh) on them.
//
// x_q is read once by the projection, not once for each head; every GEMM
// tile is full width, and the grid spans all SMs. q/k/v make one round
// trip through device memory (14 MB at 4 views). p is rounded to bf16
// against the running max over 128-key chunks, not the exact row max of
// _fused_qkv_int8_kernel, as K1: within 2e-2 of the output's magnitude of
// the exact-max plain version.
//
// Constraints (checked by the Python wrapper): head_dim 64, D and P
// multiples of 128 (the GEMM's tiles), any S >= 1; x_q and W int8, scales
// and biases f32, out and the workspaces q/k/v (B, S, P) bf16; all
// contiguous and 16-byte aligned. Ragged M = B x S: TMA reads rows past M
// as zeros and none is written; K3 masks keys past S and writes no row
// past S.

#include "qkv_forward_sm90.cuh"

namespace {
// This kernel's instances of the GEMM and of the attention forward.
struct K8Projection {};
struct K8Attention {};
}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xq (B, S, D) int8; wq/wk/wv (P, D) int8 in torch Linear layout;
// fsq/fsk/fsv (P,) f32 dequant scales (act_scale folded in); bq/bk/bv
// (P,) f32; out (B, S, P) bf16; q_ws/k_ws/v_ws (B, S, P) bf16 workspaces.
// P = heads * 64. Launches the two stages on `stream` and returns the
// first failing call's cudaError_t (0 on success).
int pigeon_fused_qkv_attention_int8(
    const void* xq, const void* wq, const void* wk, const void* wv,
    const void* fsq, const void* fsk, const void* fsv, const void* bq,
    const void* bk, const void* bv, void* out, void* q_ws, void* k_ws,
    void* v_ws, int batch, int seq, int dim, int heads, void* stream) {
  const float* const scales[3] = {static_cast<const float*>(fsq),
                                  static_cast<const float*>(fsk),
                                  static_cast<const float*>(fsv)};
  return static_cast<int>(
      launch_qkv_attention_forward<K8Projection, K8Attention,
                                   EpilogueDequantBias>(
          xq, wq, wk, wv, bq, bk, bv, out, q_ws, k_ws, v_ws, batch, seq,
          dim, heads, static_cast<cudaStream_t>(stream), scales));
}

}  // extern "C"
