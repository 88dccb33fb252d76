// Fused QKV projection + softmax attention BACKWARD, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_qkv_bwd_kernel
// (launcher `_fused_qkv_backward`, the VJP of `fused_qkv_mha` on the
// training route of every CLIP encoder layer). Given x (B, S, D), the
// Linear-layout weights W* (P, D), biases b* (P,) and the output
// cotangent g (B, S, P), it returns dx (B, S, D) and the projection
// cotangents dq, dk, dv (B, S, P), at the rounding points of
// flash_attention.py:397-455:
//
//   q, k, v = bf16(x @ W*^T + b*)                       (f32 bias add)
//   s = (q k^T) * scale,  m = rowmax(s),  u = exp(s - m),  den = sum(u)
//   g_n = bf16(g / den),  dv = bf16(u)^T g_n
//   dp = g v^T (f32),     r = sum(dp * u) / den        (from f32 u)
//   dl = bf16(u * (dp - r) * scale / den)
//   dq = dl k,  dk = dl^T q,  dx = dq Wq + dk Wk + dv Wv  (f32 accumulate)
//
// The weight and bias gradients are left to the caller (cuBLAS), as the
// JAX package leaves them to XLA.
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// D=1024, H=16) the TPU kernel's work is ~341 GFLOP of bf16 tensor-core
// work: the q/k/v projection and the dx product ~116 GFLOP each, and five
// S x S x 64 products a head (~109 GFLOP), over ~300 MB of operands: far
// above the card's ~295 FLOP per byte, so the tensor cores bound it
// (~0.345 ms).
//
// The TPU kernel keeps q/k/v and two (S, S) f32 buffers per head in VMEM.
// On Hopper every query tile needs every key tile's q/k/v, so keeping them
// on chip would repeat the 116 GFLOP projection per tile; writing them
// once (113 MB) and reading them back costs ~0.1 ms. Folding dx into the
// gradient pass would need dq before it is final and atomics across heads.
// So the call is three stages on the caller's stream:
//
//   1. projection: q|k|v = bf16(x [Wq; Wk; Wv]^T + b) into (B, S, P)
//      workspaces, a wgmma GEMM (gemm_sm90.cuh, "A B^T", N = 3P in three
//      segments, each output tile inside one of q, k or v);
//   2. attention backward: K4's passes (flash_bwd_sm90.cuh) on the q/k/v
//      workspaces and g, whose (B, S, P) layout is K4's (B, S, H, 64): the
//      statistics pass, the key-major gradient pass with dq's f32 sums
//      bulk-reduced into a zeroed workspace, and the dq cast, writing dq,
//      dk and dv straight into K2's outputs;
//   3. dx = [dq|dk|dv] (M, 3P) @ [Wq; Wk; Wv] (3P, D), the same GEMM with
//      K = 3P in three segments and B read MN-major: one f32 sum over all
//      3P, rounded once, as the TPU kernel (bf16 dq/dk/dv read back from
//      its output blocks) and the plain version round.
//
// Each stage's kernels carry a tag of their own (K2Projection,
// K2Attention, K2Dx), so a profile tells them from K4's. dq's f32 sums
// land in the order the bulk reduces do, which changes from run to run,
// so dq, and dx through it, are not bitwise the same from run to run.
//
// Constraints (checked by the Python wrapper): head_dim 64, D and P
// multiples of 128, any S >= 1, all operands bf16, contiguous, 16-byte
// aligned; the workspaces: q/k/v (B, S, P) bf16, statistics (3, B, H, S)
// f32, g_n (B, S, H, 64) bf16 and dq_acc (B, H, ceil(S / 64), 4096) f32,
// zeroed.

#include "flash_bwd_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {
// This kernel's instances of the GEMM and of the attention passes.
struct K2Projection {};
struct K2Attention {};
struct K2Dx {};
}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D); wq/wk/wv (P, D) in torch Linear layout; bq/bk/bv (P,);
// g (B, S, P) -> dx (B, S, D), dq/dk/dv (B, S, P); the workspaces above.
// P = heads * 64. Launches the three stages on `stream` and returns the
// first failing call's cudaError_t (0 on success).
int pigeon_fused_qkv_attention_backward(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* bq, const void* bk, const void* bv, const void* g, void* dx,
    void* dq, void* dk, void* dv, void* q_ws, void* k_ws, void* v_ws,
    void* stats, void* g_n, void* dq_acc, int batch, int seq, int dim,
    int heads, void* stream) {
  const int P = heads * HD;
  if (batch < 1 || seq < 1 || heads < 1 || dim % 128 != 0 || P % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = batch * seq;
  const bf16* const w[3] = {static_cast<const bf16*>(wq),
                            static_cast<const bf16*>(wk),
                            static_cast<const bf16*>(wv)};

  // 1. q|k|v = bf16(x [Wq; Wk; Wv]^T + b).
  const bf16* const xs[1] = {static_cast<const bf16*>(x)};
  const bf16* const bias[3] = {static_cast<const bf16*>(bq),
                               static_cast<const bf16*>(bk),
                               static_cast<const bf16*>(bv)};
  bf16* const qkv[3] = {static_cast<bf16*>(q_ws), static_cast<bf16*>(k_ws),
                        static_cast<bf16*>(v_ws)};
  cudaError_t err = gemm_sm90<K2Projection, true>(xs, w, bias, qkv, M, 3 * P,
                                                  dim, dim, P, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. K4's attention backward on the projected q/k/v.
  float* f = static_cast<float*>(stats);
  const size_t n_rows = static_cast<size_t>(batch) * heads * seq;
  BwdArgs args = {};
  args.m = f;
  args.den = f + n_rows;
  args.r = f + 2 * n_rows;
  args.g_n = static_cast<bf16*>(g_n);
  args.dq_acc = static_cast<float*>(dq_acc);
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.S = seq;
  args.H = heads;
  args.scale = 1.0f / sqrtf(static_cast<float>(HD));
  args.scale_log2 = args.scale * LOG2E;
  err = launch_flash_backward<K2Attention>(q_ws, k_ws, v_ws, g, args, batch,
                                           st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. dx = [dq|dk|dv] [Wq; Wk; Wv].
  const bf16* const d[3] = {args.dq, args.dk, args.dv};
  bf16* const out[1] = {static_cast<bf16*>(dx)};
  return static_cast<int>(gemm_sm90<K2Dx, false>(d, w, nullptr, out, M, dim,
                                                  3 * P, P, dim, st));
}

}  // extern "C"
