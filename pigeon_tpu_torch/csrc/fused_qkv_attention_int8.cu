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

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major>
    FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major>
    FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC8;

constexpr int KC = 64;     // D columns (bytes) staged per step
constexpr int SUB = 16;    // bytes per row of one sub-tile (one k step)
constexpr int TILE_I8 = TILE * KC;  // one staged 64 x 64 int8 tile: 4 KB
// Work area after the resident K/V: Q (bf16) + S (f32) + P (bf16) for the
// attention. Phase 1 stages three int8 tiles, then holds two int32
// accumulator tiles; phase 2 stages two int8 tiles in the S/P area and
// its int32 accumulator tile overlays S.
constexpr int WORK_BYTES = ATTN_WORK_BYTES;
static_assert(3 * TILE_I8 <= WORK_BYTES, "phase-1 staging overflows");
static_assert(2 * TILE_F <= WORK_BYTES, "phase-1 epilogue overflows");
static_assert(2 * TILE_I8 <= TILE_F + TILE_B, "phase-2 staging overflows");
static_assert(THREADS == TILE * (KC / SUB), "one 16-byte vector a thread");

__host__ __device__ constexpr int smem_bytes(int s_pad) {
  return resident_smem_bytes(s_pad, WORK_BYTES);
}

// Copy a 64 x 64 int8 block (global row stride `ld` bytes) into shared
// memory as four [64][16] sub-tiles, zero-filling rows at or past `rows`.
__device__ __forceinline__ void stage_tile_i8(int8_t* dst, const int8_t* src,
                                              int ld, int rows) {
  const int r = threadIdx.x / (KC / SUB);
  const int v = threadIdx.x % (KC / SUB);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (r < rows) {
    val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + v * SUB);
  }
  *reinterpret_cast<uint4*>(dst + v * TILE * SUB + r * SUB) = val;
}

// f32(acc) * fs + b with two roundings, in the JAX kernel's order.
__device__ __forceinline__ bf16 dequant(int acc, float fs, float b) {
  return __float2bfloat16(__fadd_rn(__fmul_rn(__int2float_rn(acc), fs), b));
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
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int P = H * DH;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int s_pad = n_tiles * TILE;
  const int warp = threadIdx.x / 32;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + s_pad * LDB;
  unsigned char* work = smem + 2 * s_pad * LDB * 2;

  const int8_t* xb = xq + (size_t)b * S * D;
  // Linear layout (P, D): head h owns the contiguous rows h*64 .. h*64+63.
  const int8_t* wq_h = wq + (size_t)h * DH * D;
  const int8_t* wk_h = wk + (size_t)h * DH * D;
  const int8_t* wv_h = wv + (size_t)h * DH * D;
  const int c_h = h * DH;  // this head's first channel

  // ---- Phase 1: K and V of this head for all S rows, kept resident. ----
  {
    int8_t* xs = reinterpret_cast<int8_t*>(work);
    int8_t* wks = xs + TILE_I8;
    int8_t* wvs = wks + TILE_I8;
    int* ik = reinterpret_cast<int*>(work);
    int* iv = ik + TILE * LDF;
    const int mat = warp / 4;  // warps 0-3 project K, 4-7 project V
    const int rf = warp % 4;   // this warp's 16-row strip
    const int8_t* ws = mat ? wvs : wks;
    int* acc_tile = mat ? iv : ik;

    for (int t = 0; t < n_tiles; ++t) {
      const int r0 = t * TILE;
      const int rows = min(TILE, S - r0);
      FragC8 acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0);
      for (int d0 = 0; d0 < D; d0 += KC) {
        stage_tile_i8(xs, xb + (size_t)r0 * D + d0, D, rows);
        stage_tile_i8(wks, wk_h + d0, D, TILE);
        stage_tile_i8(wvs, wv_h + d0, D, TILE);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC / SUB; ++kk) {
          FragA8 a;
          wmma::load_matrix_sync(a, xs + kk * TILE * SUB + rf * 16 * SUB,
                                 SUB);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB8 bm;
            wmma::load_matrix_sync(bm, ws + kk * TILE * SUB + j * 16 * SUB,
                                   SUB);
            wmma::mma_sync(acc[j], a, bm, acc[j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(acc_tile + rf * 16 * LDF + j * 16, acc[j],
                                LDF, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * TILE * DH; i += THREADS) {
        const int m = i / (TILE * DH);
        const int r = (i % (TILE * DH)) / DH;
        const int c = i % DH;
        (m ? vs : ks)[(r0 + r) * LDB + c] =
            dequant((m ? iv : ik)[r * LDF + c], (m ? fsv : fsk)[c_h + c],
                    (m ? bv : bk)[c_h + c]);
      }
      __syncthreads();
    }
  }

  // ---- Phase 2: query tiles against the resident K/V. ----
  {
    bf16* qs = reinterpret_cast<bf16*>(work);
    float* sf = reinterpret_cast<float*>(work + TILE_B);
    bf16* ps = reinterpret_cast<bf16*>(work + TILE_B + TILE_F);
    // Q-projection staging and its accumulator reuse the S/P area (free
    // until scoring).
    int8_t* xs = reinterpret_cast<int8_t*>(work + TILE_B);
    int8_t* wqs = xs + TILE_I8;
    int* iq = reinterpret_cast<int*>(work + TILE_B);
    const int rf = warp / 2;        // 16-row strip
    const int cf = (warp % 2) * 2;  // first of two 16-column fragments

    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = t * TILE;
      const int rows = min(TILE, S - q0);

      // Q tile = bf16(f32(x_q[q0:q0+64] @ Wq_h^T) * fsq_h + bq_h).
      {
        FragC8 acc[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0);
        for (int d0 = 0; d0 < D; d0 += KC) {
          stage_tile_i8(xs, xb + (size_t)q0 * D + d0, D, rows);
          stage_tile_i8(wqs, wq_h + d0, D, TILE);
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KC / SUB; ++kk) {
            FragA8 a;
            wmma::load_matrix_sync(a, xs + kk * TILE * SUB + rf * 16 * SUB,
                                   SUB);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              FragB8 bm;
              wmma::load_matrix_sync(
                  bm, wqs + kk * TILE * SUB + (cf + j) * 16 * SUB, SUB);
              wmma::mma_sync(acc[j], a, bm, acc[j]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(iq + rf * 16 * LDF + (cf + j) * 16, acc[j],
                                  LDF, wmma::mem_row_major);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < TILE * DH; i += THREADS) {
          const int r = i / DH;
          const int c = i % DH;
          qs[r * LDB + c] = dequant(iq[r * LDF + c], fsq[c_h + c],
                                    bq[c_h + c]);
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
int pigeon_fused_qkv_attention_int8_max_seq() {
  return resident_max_seq(WORK_BYTES);
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
  if (batch < 1 || seq < 1 || heads < 1 || dim % KC != 0 || smem > MAX_SMEM) {
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
