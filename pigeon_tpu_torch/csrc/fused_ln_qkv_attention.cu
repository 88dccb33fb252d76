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
//     q, k, v = bf16(xn @ W*_h^T + b*_h)                (f32 sums, f32 bias)
//     out[:, h*64:(h+1)*64] = bf16((bf16(p) @ v) / sum(p))
//
// Flax's fast-variance LayerNorm, in its association order
// (flash_attention.py::_layer_norm_f32).
//
// What bounds it on the H100: K1's work (~20 GFLOP of bf16 tensor-core
// products over ~16 MB at the serving shape B=4, S=577, D=1024, H=16;
// ~160 GFLOP over ~82 MB at B=32) plus the LayerNorm, ~7 FLOP per element
// of x: the tensor cores bound it, 0.020 ms and 0.161 ms.
//
// The design is K1's (fused_qkv_attention.cu says why q/k/v go through
// device memory) behind a LayerNorm pass, three launches on the caller's
// stream:
//
//   1. LN1: ln_row.cuh's `layer_norm_kernel` reads raw x and writes xn
//      (B, S, D) bf16 to a workspace, one warp a row: f32 sums of x and
//      x^2 over the row in 16-byte vectors, a butterfly of shuffles, then
//      each element normalised, scaled and shifted in f32 and rounded
//      once (K6 and K9 launch the same kernel under their own tags);
//   2. projection: q|k|v = bf16(xn [Wq; Wk; Wv]^T + b), the wgmma GEMM of
//      gemm_sm90.cuh, and
//   3. attention: K3's streaming forward (flash_fwd_sm90.cuh) on q/k/v,
//      K1's two stages (qkv_forward_sm90.cuh) under this kernel's tags.
//
// The TPU kernel keeps xn in VMEM; here it costs one round trip through
// device memory (~75 MB at 32 views, ~0.025 ms at 3.35 TB/s). Folding the
// normalisation into the GEMM's A operand would put a pass through
// registers between TMA's shared-memory tile and wgmma, which reads its
// operands from shared memory as TMA wrote them; each of the 12 column
// tiles of a row block (3P = 3072 at D = 1024) would also normalise the
// same rows again. Each stage's kernel carries a tag of this kernel's
// (K5LayerNorm, K5Projection, K5Attention), so a profile tells them from
// K1's and K6's.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// D and P multiples of 128, any S >= 1, x, weights and biases bf16,
// ln_scale and ln_bias f32, all contiguous and 16-byte aligned; the
// workspaces xn (B, S, D) and q/k/v (B, S, P) bf16.

#include "ln_row.cuh"
#include "qkv_forward_sm90.cuh"

namespace {

// This kernel's instances of the LayerNorm, the GEMM and the attention.
struct K5LayerNorm {};
struct K5Projection {};
struct K5Attention {};

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D) bf16 raw; ln_scale/ln_bias (D,) f32; wq/wk/wv (P, D) in
// torch Linear layout and bq/bk/bv (P,), bf16; out (B, S, P) bf16; the
// workspaces xn (B, S, D) and q_ws/k_ws/v_ws (B, S, P) bf16. P = heads *
// 64. Launches the three stages on `stream` and returns the first failing
// call's cudaError_t (0 on success).
int pigeon_fused_ln_qkv_attention(const void* x, const void* ln_scale,
                                  const void* ln_bias, const void* wq,
                                  const void* wk, const void* wv,
                                  const void* bq, const void* bk,
                                  const void* bv, void* out, void* xn_ws,
                                  void* q_ws, void* k_ws, void* v_ws,
                                  int batch, int seq, int dim, int heads,
                                  float eps, void* stream) {
  if (!qkv_forward_shape_ok(batch, seq, dim, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = batch * seq;

  // 1. xn = bf16(LN1(x)).
  const cudaError_t err = launch_layer_norm<K5LayerNorm>(
      x, ln_scale, ln_bias, xn_ws, M, dim, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2 and 3. q|k|v = bf16(xn [Wq; Wk; Wv]^T + b), then K3's streaming
  // forward on them.
  return static_cast<int>(
      launch_qkv_attention_forward<K5Projection, K5Attention>(
          xn_ws, wq, wk, wv, bq, bk, bv, out, q_ws, k_ws, v_ws, batch, seq,
          dim, heads, st));
}

}  // extern "C"
