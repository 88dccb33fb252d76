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
// D=1024, H=16) the projections are ~14.5 G int8 operations and the
// attention ~5.5 GFLOP of bf16 (~2.7 more for the two-pass softmax's
// second QK^T) over ~13 MB of unique operands (x_q 2.4 MB, the three
// int8 weights 3.1 MB, out 4.7 MB): far above the ridge, so the tensor
// cores bound it. The design is K1's (fused_qkv_attention.cu) with int8
// operands: one block per (batch, head) projects that head's K and V for
// all S rows with int8 x int8 -> int32 WMMA, dequantizes in an f32
// epilogue, keeps them resident in shared memory as bf16 (2 x S_pad x 72
// bf16 = 184 KB at S=577), then walks 64-row query tiles: project the Q
// tile the same way and run `attend_tile` (attention_tile.cuh, the body
// K1 and K3 share). x and the weight slices stream through shared memory
// in 64-wide int8 chunks: half the bytes of K1's bf16 chunks.
//
// The block body is `fused_qkv_attention_int8_block` of attention_tile.cuh
// (shared with K7, which quantizes x in a launch of its own first).
// The int8 tiles are staged as four [64 rows][16 bytes] sub-tiles, one per
// WMMA k step, so every fragment starts on a 256-byte boundary with a
// 16-byte leading dimension (WMMA's alignment rules for 8-bit operands).
// B x H = 64 blocks leave half of the 132 SMs idle at the serving shape,
// as in K1; cp.async/TMA staging and wgmma are later tuning steps.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// D a multiple of 64, S <= pigeon_fused_qkv_attention_int8_max_seq();
// x_q and W int8, scales and biases f32, out bf16; all contiguous and
// 16-byte aligned. Rows past S are projected from zeros (giving the
// bias), excluded from the softmax and never written.

#include "attention_tile.cuh"

namespace {

__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, INT8_WORK_BYTES);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_qkv_attention_int8_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const int8_t* __restrict__ wk, const int8_t* __restrict__ wv,
    const float* __restrict__ fsq, const float* __restrict__ fsk,
    const float* __restrict__ fsv, const float* __restrict__ bq,
    const float* __restrict__ bk, const float* __restrict__ bv,
    bf16* __restrict__ out, int S, int D, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  fused_qkv_attention_int8_block(smem, xq + (size_t)blockIdx.y * S * D, wq,
                                 wk, wv, fsq, fsk, fsv, bq, bk, bv, out, S,
                                 D, H, scale);
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V fit one block's shared memory.
int pigeon_fused_qkv_attention_int8_max_seq() {
  return resident_max_seq(INT8_WORK_BYTES);
}

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xq (B, S, D) int8; wq/wk/wv (H*64, D) int8 in torch Linear layout;
// fsq/fsk/fsv (H*64,) f32 dequant scales (act_scale folded in); bq/bk/bv
// (H*64,) f32; out (B, S, H*64) bf16. All contiguous. Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
int pigeon_fused_qkv_attention_int8(
    const void* xq, const void* wq, const void* wk, const void* wv,
    const void* fsq, const void* fsk, const void* fsv, const void* bq,
    const void* bk, const void* bv, void* out, int batch, int seq, int dim,
    int heads, void* stream) {
  const int s_pad = ((seq + TILE - 1) / TILE) * TILE;
  const int smem = smem_bytes(s_pad);
  if (batch < 1 || seq < 1 || heads < 1 || dim % KC8 != 0 || smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_qkv_attention_int8_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  fused_qkv_attention_int8_kernel<<<grid, THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const int8_t*>(wk), static_cast<const int8_t*>(wv),
      static_cast<const float*>(fsq), static_cast<const float*>(fsk),
      static_cast<const float*>(fsv), static_cast<const float*>(bq),
      static_cast<const float*>(bk), static_cast<const float*>(bv),
      static_cast<bf16*>(out), seq, dim, heads,
      1.0f / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
