// Softmax attention BACKWARD on (B, S, H, 64) q/k/v, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_flash_backward with its
// body _attn_bwd_kernel: the VJP of `mha` on the `flash` training route,
// and of `fused_qkv_mha` under PIGEON_FUSED_BWD=xla, where the q/k/v
// projections run outside the kernel. Given q, k, v and the output
// cotangent g it returns dq, dk and dv with the softmax recomputed and its
// denominator deferred (flash_bwd_sm90.cuh states the arithmetic).
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// H=16) the TPU kernel's work is five S x S x 64 products a head (the
// scores, dp, dv, dq and dk), ~109 GFLOP of bf16 tensor-core work, over
// ~265 MB of q/k/v/g and dq/dk/dv: ~410 FLOP per byte, above the card's
// ~295, so the tensor cores bound it (~0.11 ms). The TPU kernel's
// contract takes no forward statistics, so the design walks the products
// seven times (~153 GFLOP): a statistics pass by query tile (the scores
// and dp, for the row max, den and r, two walks) and one gradient pass by
// key tile in the FlashAttention-2 form (five walks), every product on
// wgmma with TMA-fed, 128-byte-swizzled operands (flash_bwd_sm90.cuh). dq
// is summed across key tiles by bulk f32 reduce-adds into a workspace,
// then cast to bf16.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// q/k/v/g/dq/dk/dv bf16, (B, S, H, 64) contiguous, 16-byte aligned; the
// workspaces: statistics (3, B, H, S) f32, g_n (B, S, H, 64) bf16 and
// dq_acc (B, H, ceil(S / 64), 4096) f32, zeroed.

#include "flash_bwd_sm90.cuh"

namespace {
struct K4Attention {};  // this kernel's instance of the passes
}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v/g, dq/dk/dv (B, S, H, 64) bf16; the workspaces above. Launches the
// three passes on `stream` and returns the first failing call's
// cudaError_t (0 on success).
int pigeon_flash_attention_backward(const void* q, const void* k,
                                    const void* v, const void* g, void* dq,
                                    void* dk, void* dv, void* stats,
                                    void* g_n, void* dq_acc, int batch,
                                    int seq, int heads, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* f = static_cast<float*>(stats);
  const size_t n_rows = (size_t)batch * heads * seq;
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
  return static_cast<int>(launch_flash_backward<K4Attention>(
      q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
