// Fused QKV projection + softmax attention forward, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_qkv_kernel (the
// `flash_fused` serving route of every CLIP encoder layer). For each
// (batch, head) it computes
//
//     q, k, v = bf16(x @ W*_h^T + b*_h)                 (f32 accumulate)
//     out[:, h*64:(h+1)*64] = bf16((bf16(p) @ v) / sum(p)),
//     p = exp(s - max(s)),  s = (q k^T) * 64^-0.5        (f32 softmax)
//
// with q, k and v never written to device memory.
//
// What bounds it on the H100: at the serving shape (B=4 views, S=577,
// D=1024, H=16) the call is ~20 GFLOP of bf16 tensor-core work (the three
// projections are ~73% of it; the two-pass softmax below adds ~2.7 GFLOP
// of recomputed scores) over ~16 MB of unique operands (x 4.7 MB, the
// three weights 6.3 MB, out 4.7 MB): ~1,250 FLOP per byte, far above the
// card's ~295, so the tensor cores' rate bounds it, not HBM. The design
// keeps the operands on chip: one block per (batch, head) projects that
// head's K and V for all
// S rows once and keeps them resident in shared memory (2 x S_pad x 72
// bf16 = 184 KB at S=577), then walks 64-row query tiles: project the Q
// tile, score it against the resident K twice (pass 1: exact row max;
// pass 2: exp, bf16 P tile, P @ V accumulated in registers), normalise and
// write. x and the head's weight slices stream through shared memory in
// 64-wide chunks and are re-read from L2, not HBM.
//
// The block body is `fused_qkv_attention_block` of attention_tile.cuh
// (shared with K5, which normalises x as it stages it) and its attention
// passes are `attend_tile` (shared with K3, K5 and K8). Matrix products
// are WMMA 16x16x16 bf16 fragments with f32 accumulation (mma.sync
// underneath); loads into shared memory are plain 16-byte vectors with no
// pipelining. B x H = 64 blocks leave half of the 132 SMs idle at the
// serving shape: splitting the query tiles of one head across blocks
// (re-projecting K/V), cp.async/TMA staging and wgmma are the tuning steps
// this simple, correct form leaves for later.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// D a multiple of 64, S <= pigeon_fused_qkv_attention_max_seq(), all
// operands bf16, contiguous and 16-byte aligned. Ragged S is masked: rows
// past S are projected from zeros, excluded from the softmax and never
// written.

#include "attention_tile.cuh"

namespace {

__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, QKV_WORK_BYTES);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_qkv_attention_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ wq,
                           const bf16* __restrict__ wk,
                           const bf16* __restrict__ wv,
                           const bf16* __restrict__ bq,
                           const bf16* __restrict__ bk,
                           const bf16* __restrict__ bv,
                           bf16* __restrict__ out, int S, int D, int H,
                           float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* xb = x + (size_t)blockIdx.y * S * D;
  fused_qkv_attention_block(
      smem,
      [&](bf16* dst, int r0, int d0, int rows) {
        stage_tile(dst, xb + (size_t)r0 * D + d0, D, rows);
      },
      wq, wk, wv, bq, bk, bv, out, S, D, H, scale);
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V fit one block's shared memory.
int pigeon_fused_qkv_attention_max_seq() {
  return resident_max_seq(QKV_WORK_BYTES);
}

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D); wq/wk/wv (H*64, D) in torch Linear layout; bq/bk/bv (H*64,);
// out (B, S, H*64). All bf16, contiguous. Launches on `stream` and returns
// the launch's cudaError_t (0 on success).
int pigeon_fused_qkv_attention(const void* x, const void* wq, const void* wk,
                               const void* wv, const void* bq, const void* bk,
                               const void* bv, void* out, int batch, int seq,
                               int dim, int heads, void* stream) {
  const int s_pad = ((seq + TILE - 1) / TILE) * TILE;
  const int smem = smem_bytes(s_pad);
  if (batch < 1 || seq < 1 || heads < 1 || dim % QKV_KC != 0 ||
      smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_qkv_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  fused_qkv_attention_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
      static_cast<const bf16*>(bv), static_cast<bf16*>(out), seq, dim, heads,
      1.0f / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
