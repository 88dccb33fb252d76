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
// memory, x streamed in 64 x 64 tiles) with two changes, both in
// ln_qkv_attention_tile.cuh with the block itself, shared with K6. A prologue (`ln_row_stats`) takes
// each row's mean and rsqrt(var + eps) over D in f32, one warp a row, into
// shared memory (2 x S_pad floats, 5 KB at S=577, after K1's 215 KB); and
// each streamed x tile is normalised, scaled and biased in f32 as it is
// staged (`stage_ln_tile`), then rounded to bf16. Each of a batch's H blocks recomputes its
// rows' statistics (16 reads of x from L2 at H=16), the TPU kernel's
// per-group redundancy.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// D a multiple of 64, S <= pigeon_fused_ln_qkv_attention_max_seq(), x,
// weights and biases bf16, ln_scale and ln_bias f32, all contiguous and
// 16-byte aligned. Ragged S is masked as in K1: tiles past S are staged as
// zeros, excluded from the softmax and never written.

#include "ln_qkv_attention_tile.cuh"

extern "C" {

// Longest sequence whose resident K/V and row statistics fit one block's
// shared memory.
int pigeon_fused_ln_qkv_attention_max_seq() {
  return ln_qkv_attention_max_seq();
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
  return static_cast<int>(launch_ln_qkv_attention(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
      static_cast<const bf16*>(bv), static_cast<bf16*>(out), batch, seq,
      dim, heads, eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
