// Fused QKV projection + softmax attention forward, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_qkv_kernel
// (launcher `_fused_qkv_forward`, the `flash_fused` routes of every CLIP
// encoder layer; K6's backward runs it again). For each (batch, head):
//
//     q, k, v = bf16(x @ W*_h^T + b*_h)                 (f32 sums, f32 bias)
//     out[:, h*64:(h+1)*64] = bf16((bf16(p) @ v) / sum(p)),
//     p = exp(s - max(s)),  s = (q k^T) * 64^-0.5        (f32 softmax)
//
// What bounds it on the H100: at the serving shape (B=4 views, S=577,
// D=1024, H=16) the call is ~20 GFLOP of bf16 tensor-core work (the three
// projections 14.5, QK^T and PV 5.5) over ~16 MB of operands (x 4.7 MB,
// the weights 6.3 MB, out 4.7 MB); at the training shape (B=32) ~160
// GFLOP over ~82 MB. Both are far above the card's ~295 FLOP per byte, so
// the tensor cores bound it: 0.020 ms and 0.161 ms.
//
// The TPU kernel keeps a head group's q/k/v in VMEM. On Hopper every
// 128-row query tile needs the K and V of every key, so keeping them on
// chip means either one block per (batch, head) holding all S rows (this
// kernel's first design, a resident WMMA block: 64 blocks for 132 SMs at
// 4 views, WMMA products at ~6% of the bf16 peak) or projecting K and V
// again for each query tile (the projection is 73% of the work; the
// reason K2 writes them out too). Splitting the
// query tiles of the resident design across blocks repeats that
// projection as well. So the call is two launches on the caller's stream
// (qkv_forward_sm90.cuh, which K5 runs too):
//
//   1. projection: q|k|v = bf16(x [Wq; Wk; Wv]^T + b) into three (B, S, P)
//      workspaces by the persistent wgmma GEMM of gemm_sm90.cuh ("A B^T",
//      N = 3P in three segments, 128 x 256 tiles, a 4-stage TMA ring),
//      K2's projection under this kernel's tag;
//   2. attention: K3's streaming forward (flash_fwd_sm90.cuh) on those
//      workspaces, whose (B, S, P) layout is K3's (B, S, H, 64): 128-row
//      query tiles, 128-key chunks by TMA, both products on wgmma, the
//      softmax online.
//
// Writing q/k/v costs one round trip through device memory (113 MB at 32
// views, ~0.07 ms at 3.35 TB/s), a third of the projection's time. p is
// rounded to bf16 against the running max over 128-key chunks, not the
// exact row max of _fused_qkv_kernel, as K3: within 2e-2 of the output's
// magnitude of the exact-max plain version.
//
// Constraints (checked by the Python wrapper): head_dim 64, D and P
// multiples of 128 (the GEMM's tiles), any S >= 1, all operands bf16,
// contiguous, 16-byte aligned; the workspaces q/k/v (B, S, P) bf16. Ragged
// M = B x S: TMA reads rows past M as zeros and none is written; K3 masks
// keys past S and writes no row past S.

#include "qkv_forward_sm90.cuh"

namespace {
// This kernel's instances of the GEMM and of the attention forward.
struct K1Projection {};
struct K1Attention {};
}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D); wq/wk/wv (P, D) in torch Linear layout; bq/bk/bv (P,);
// out (B, S, P); q_ws/k_ws/v_ws (B, S, P) workspaces. P = heads * 64.
// Launches the two stages on `stream` and returns the first failing call's
// cudaError_t (0 on success).
int pigeon_fused_qkv_attention(const void* x, const void* wq, const void* wk,
                               const void* wv, const void* bq, const void* bk,
                               const void* bv, void* out, void* q_ws,
                               void* k_ws, void* v_ws, int batch, int seq,
                               int dim, int heads, void* stream) {
  return static_cast<int>(
      launch_qkv_attention_forward<K1Projection, K1Attention>(
          x, wq, wk, wv, bq, bk, bv, out, q_ws, k_ws, v_ws, batch, seq, dim,
          heads, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
