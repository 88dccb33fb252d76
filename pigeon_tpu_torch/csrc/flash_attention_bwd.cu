// Softmax attention BACKWARD on (B, S, H, 64) q/k/v, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_flash_backward with its
// body _attn_bwd_kernel: the VJP of `mha` on the `flash` training route,
// and of `fused_qkv_mha` under PIGEON_FUSED_BWD=xla, where the q/k/v
// projections run outside the kernel. Given q, k, v and the output
// cotangent g it returns dq, dk and dv with the softmax recomputed and its
// denominator deferred (attention_bwd_tile.cuh states the arithmetic).
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// H=16) the TPU kernel's work is five S x S x 64 products a head (the
// scores, dp, dv, dq and dk), ~109 GFLOP of bf16 tensor-core work, over
// ~265 MB of q/k/v/g and dq/dk/dv: ~410 FLOP per byte, above the card's
// ~295, so the tensor cores bound it (~0.11 ms). This first form
// recomputes the scores four times and dp three times (~218 GFLOP) so
// that no (S, S) block leaves a 64-row tile: the dq pass and the dk/dv
// pass of attention_bwd_tile.cuh, the same two launches K2 runs after its
// projection, here on the caller's q/k/v/g directly. WMMA from shared
// memory without copy/compute overlap; keeping one tile's scores for both
// passes, cp.async/TMA staging and wgmma are the tuning steps left.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// q/k/v/g/dq/dk/dv bf16, (B, S, H, 64) contiguous, 16-byte aligned; the
// statistics workspace (3, B, H, S) f32.

#include "attention_bwd_tile.cuh"

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v/g, dq/dk/dv (B, S, H, 64) bf16; stats (3, B, H, S) f32. Launches
// the two passes on `stream` and returns the first failing call's
// cudaError_t (0 on success).
int pigeon_flash_attention_backward(const void* q, const void* k,
                                    const void* v, const void* g, void* dq,
                                    void* dk, void* dv, void* stats,
                                    int batch, int seq, int heads,
                                    void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* f = static_cast<float*>(stats);
  const size_t n_rows = (size_t)batch * heads * seq;
  AttnArgs args = {};
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.g = static_cast<const bf16*>(g);
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.m = f;
  args.den = f + n_rows;
  args.r = f + 2 * n_rows;
  args.S = seq;
  args.H = heads;
  args.scale = 1.0f / sqrtf(static_cast<float>(DH));
  return static_cast<int>(attention_backward_passes(
      args, batch, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
