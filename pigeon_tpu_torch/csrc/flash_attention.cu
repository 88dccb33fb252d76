// Softmax attention forward on (B, S, H, 64) q/k/v, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_flash_forward with its
// default body _attn_kernel (reached through `mha`): the `flash` route and
// the dynamic-quant calibration forward of `serve --quant`, where the
// q/k/v projections ran outside the kernel. For each (batch, head):
//
//     out = bf16((bf16(p) @ v) / sum(p)),
//     p = exp(s - max(s)),  s = (q k^T) * 64^-0.5        (f32 softmax)
//
// What bounds it on the H100: at the calibration shape (B=80 views,
// S=577, H=16) the call is ~109 GFLOP of bf16 tensor-core work (QK^T and
// PV; the two-pass softmax below adds another QK^T, ~164 GFLOP in all)
// over ~378 MB of q/k/v/out: ~290 FLOP per byte, at the card's ridge
// (~295), so neither HBM nor the tensor cores leave slack if K and V are
// read once per head and the S x S scores never leave the chip. The
// design keeps them on chip: a block stages one head's K and V for all S
// rows into shared memory (2 x S_pad x 72 bf16 = 184 KB at S=577) and
// walks its share of that head's 64-row query tiles through `attend_tile`
// (attention_tile.cuh, the body K1 and K8 share): pass 1 takes the exact
// row max over the resident K, pass 2 forms exp, the f32 row sum and
// bf16(P) @ V. The kernel reads q/k/v in the model's (B, S, H, dh) layout
// (row stride H*64), so no transpose runs before or after it.
//
// Grid: (B*H, splits). Each head's query tiles are split over `splits`
// blocks only when B*H alone would not cover the SMs (each split re-reads
// K/V); at the calibration shape B*H = 1,280 blocks, one per SM at a time
// (the resident K/V take the SM's shared memory), ~10 waves on 132 SMs.
// WMMA from shared memory without copy/compute overlap is the simple form
// this first version takes; cp.async/TMA and wgmma come later.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// S <= pigeon_flash_attention_max_seq(), q/k/v/out bf16, contiguous,
// 16-byte aligned. Rows of K/V past S are zero-filled and masked; query
// rows past S are never written.

#include "attention_tile.cuh"

namespace {

__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, ATTN_WORK_BYTES);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int S, int H, int tiles_per_block, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int s_pad = n_tiles * TILE;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = min(n_tiles, t0 + tiles_per_block);
  const int ld = H * DH;  // row stride of (B, S, H, 64)
  const size_t head = (size_t)b * S * ld + (size_t)h * DH;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + s_pad * LDB;
  unsigned char* work = smem + 2 * s_pad * LDB * 2;
  bf16* qs = reinterpret_cast<bf16*>(work);
  float* sf = reinterpret_cast<float*>(work + TILE_B);
  bf16* ps = reinterpret_cast<bf16*>(work + TILE_B + TILE_F);

  // This head's K and V, all S rows, zero past S.
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * TILE;
    const int rows = min(TILE, S - r0);
    stage_tile(ks + r0 * LDB, k + head + (size_t)r0 * ld, ld, rows);
    stage_tile(vs + r0 * LDB, v + head + (size_t)r0 * ld, ld, rows);
  }
  for (int t = t0; t < t1; ++t) {
    const int q0 = t * TILE;
    const int rows = min(TILE, S - q0);
    stage_tile(qs, q + head + (size_t)q0 * ld, ld, rows);
    __syncthreads();
    attend_tile(qs, ks, vs, sf, ps, S, scale, out + head + (size_t)q0 * ld,
                ld, rows);
  }
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V fit one block's shared memory.
int pigeon_flash_attention_max_seq() {
  return resident_max_seq(ATTN_WORK_BYTES);
}

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v/out (B, S, H, 64), bf16, contiguous. Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
int pigeon_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int batch, int seq, int heads,
                           void* stream) {
  const int n_tiles = (seq + TILE - 1) / TILE;
  const int smem = smem_bytes(n_tiles * TILE);
  if (batch < 1 || seq < 1 || heads < 1 || smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Split the query tiles of each head only as far as needed to give
  // every SM a block; then drop empty splits.
  const int bh = batch * heads;
  const int want = min(n_tiles, max(1, (sms + bh - 1) / bh));
  const int tiles_per_block = (n_tiles + want - 1) / want;
  const int splits = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const dim3 grid(bh, splits);
  flash_attention_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seq, heads,
      tiles_per_block, 1.0f / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
