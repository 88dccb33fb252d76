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
// The attention passes are `attend_tile` of attention_tile.cuh, shared
// with K3 and K8. Matrix products are WMMA 16x16x16 bf16 fragments with
// f32 accumulation (mma.sync underneath); loads into shared memory are plain 16-byte
// vectors with no pipelining. B x H = 64 blocks leave half of the 132 SMs
// idle at the serving shape: splitting the query tiles of one head across
// blocks (re-projecting K/V), cp.async/TMA staging and wgmma are the
// tuning steps this simple, correct form leaves for later.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// D a multiple of 64, S <= pigeon_fused_qkv_attention_max_seq(), all
// operands bf16, contiguous and 16-byte aligned. Ragged S is masked: rows
// past S are projected from zeros, excluded from the softmax and never
// written.

#include "attention_tile.cuh"

namespace {

constexpr int KC = 64;  // D columns staged per step
// Work area after the resident K/V. Phase 1 uses it for three staged
// bf16 tiles, then two f32 tiles; phase 2 for Q (bf16) + S (f32) + P
// (bf16), with the Q-projection staging overlaid on S and P.
constexpr int WORK_BYTES = ATTN_WORK_BYTES;
static_assert(3 * TILE_B <= WORK_BYTES, "phase-1 staging overflows");
static_assert(2 * TILE_F <= WORK_BYTES, "phase-1 epilogue overflows");

__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, WORK_BYTES);
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
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int P = H * DH;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int s_pad = n_tiles * TILE;
  const int warp = threadIdx.x / 32;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + s_pad * LDB;
  unsigned char* work = smem + 2 * s_pad * LDB * 2;

  const bf16* xb = x + (size_t)b * S * D;
  // Linear layout (P, D): head h owns the contiguous rows h*64 .. h*64+63.
  const bf16* wq_h = wq + (size_t)h * DH * D;
  const bf16* wk_h = wk + (size_t)h * DH * D;
  const bf16* wv_h = wv + (size_t)h * DH * D;
  const bf16* bq_h = bq + h * DH;
  const bf16* bk_h = bk + h * DH;
  const bf16* bv_h = bv + h * DH;

  // ---- Phase 1: K and V of this head for all S rows, kept resident. ----
  {
    bf16* xs = reinterpret_cast<bf16*>(work);
    bf16* wks = xs + TILE * LDB;
    bf16* wvs = wks + TILE * LDB;
    float* fk = reinterpret_cast<float*>(work);
    float* fv = fk + TILE * LDF;
    const int mat = warp / 4;  // warps 0-3 project K, 4-7 project V
    const int rf = warp % 4;   // this warp's 16-row strip
    const bf16* ws = mat ? wvs : wks;
    float* f = mat ? fv : fk;

    for (int t = 0; t < n_tiles; ++t) {
      const int r0 = t * TILE;
      const int rows = min(TILE, S - r0);
      FragC acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
      for (int d0 = 0; d0 < D; d0 += KC) {
        stage_tile(xs, xb + (size_t)r0 * D + d0, D, rows);
        stage_tile(wks, wk_h + d0, D, TILE);
        stage_tile(wvs, wv_h + d0, D, TILE);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, xs + rf * 16 * LDB + kk, LDB);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragBCol bm;
            wmma::load_matrix_sync(bm, ws + j * 16 * LDB + kk, LDB);
            wmma::mma_sync(acc[j], a, bm, acc[j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(f + rf * 16 * LDF + j * 16, acc[j], LDF,
                                wmma::mem_row_major);
      }
      __syncthreads();
      // Bias in f32, then round to bf16 (flash_attention.py:319-323).
      for (int i = threadIdx.x; i < 2 * TILE * DH; i += THREADS) {
        const int m = i / (TILE * DH);
        const int r = (i % (TILE * DH)) / DH;
        const int c = i % DH;
        const float y = (m ? fv : fk)[r * LDF + c] +
                        __bfloat162float((m ? bv_h : bk_h)[c]);
        (m ? vs : ks)[(r0 + r) * LDB + c] = __float2bfloat16(y);
      }
      __syncthreads();
    }
  }

  // ---- Phase 2: query tiles against the resident K/V. ----
  {
    bf16* qs = reinterpret_cast<bf16*>(work);
    float* sf = reinterpret_cast<float*>(work + TILE_B);
    bf16* ps = reinterpret_cast<bf16*>(work + TILE_B + TILE_F);
    // Q-projection staging reuses the S/P area (free until scoring).
    bf16* xs = reinterpret_cast<bf16*>(work + TILE_B);
    bf16* wqs = xs + TILE * LDB;
    const int rf = warp / 2;        // 16-row strip
    const int cf = (warp % 2) * 2;  // first of two 16-column fragments

    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = t * TILE;
      const int rows = min(TILE, S - q0);

      // Q tile = bf16(x[q0:q0+64] @ Wq_h^T + bq_h).
      {
        FragC acc[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
        for (int d0 = 0; d0 < D; d0 += KC) {
          stage_tile(xs, xb + (size_t)q0 * D + d0, D, rows);
          stage_tile(wqs, wq_h + d0, D, TILE);
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, xs + rf * 16 * LDB + kk, LDB);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              FragBCol bm;
              wmma::load_matrix_sync(bm, wqs + (cf + j) * 16 * LDB + kk, LDB);
              wmma::mma_sync(acc[j], a, bm, acc[j]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(sf + rf * 16 * LDF + (cf + j) * 16, acc[j],
                                  LDF, wmma::mem_row_major);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < TILE * DH; i += THREADS) {
          const int r = i / DH;
          const int c = i % DH;
          qs[r * LDB + c] = __float2bfloat16(sf[r * LDF + c] +
                                             __bfloat162float(bq_h[c]));
        }
        __syncthreads();
      }

      attend_tile(qs, ks, vs, sf, ps, S, scale,
                  out + ((size_t)b * S + q0) * P + h * DH, P, rows);
    }
  }
}

}  // namespace

extern "C" {

// Longest sequence whose resident K/V fit one block's shared memory.
int pigeon_fused_qkv_attention_max_seq() {
  return resident_max_seq(WORK_BYTES);
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
  if (batch < 1 || seq < 1 || heads < 1 || dim % KC != 0 || smem > MAX_SMEM) {
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
