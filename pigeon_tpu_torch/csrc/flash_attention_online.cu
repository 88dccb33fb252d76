// Online-softmax attention forward on (B, S, H, 64) q/k/v, for Hopper
// (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_attn_kernel_online, the
// body `_flash_forward` takes under PIGEON_FLASH_FWD=online (reached through
// `mha`: the `flash` route and the int8 calibration forward). Exact
// attention with a running max: for each 64-row query tile and each chunk
// of ONLINE_CHUNK = 128 keys (the last one ragged, 65 keys at S = 577),
//
//     s     = (q k_c^T) * 64^-0.5                          (f32)
//     m_new = max(m, max_c(s));  p = exp(s - m_new);  corr = exp(m - m_new)
//     l     = l * corr + sum(p)                             (f32 p)
//     acc   = acc * corr + bf16(p) @ v_c                    (f32)
//
// and out = bf16(acc / l). bf16(p) is taken relative to the RUNNING max, so
// this is a different function from K3's in bf16, as on the TPU.
//
// What bounds it on the H100: at the calibration shape (B=80 views, S=577,
// H=16) ~109 GFLOP of bf16 tensor-core work (QK^T and PV once each) over
// ~378 MB of q/k/v/out: ~290 FLOP per byte, at the card's ridge, so the
// bytes bound it (~0.113 ms) if K and V come from HBM once per head. The
// design streams: one block per (64-row query tile, batch, head) keeps its
// Q tile, one 128-key chunk of K and V, the f32 score tile (with the bf16
// P tile written over it) and the f32 output accumulator in shared memory
// (95 KB), nothing resident for the whole sequence, so two blocks fit an
// SM (K3's resident K/V allow one). The ten query tiles of a head re-read
// its K and V, mostly from L2. Matrix products are WMMA 16x16x16 bf16
// fragments with f32 accumulation; the accumulator is corrected in shared
// memory by four threads a row, which also hold the row's running max and
// denominator. Staging has no copy/compute overlap yet (cp.async/TMA and
// wgmma are later work).
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// q/k/v/out bf16, contiguous, 16-byte aligned. Keys past S are staged as
// zeros and masked; query rows past S are never written.

#include "attention_tile.cuh"

namespace {

constexpr int CHUNK = 128;     // keys per step (ONLINE_CHUNK)
constexpr int LDS = CHUNK + 4;  // f32 score row stride
constexpr int LDP = 2 * LDS;    // bf16 P row stride: row r overlays S row r
constexpr int CHUNK_B = CHUNK * LDB * 2;  // one staged K or V chunk
constexpr int SMEM = TILE_B + 2 * CHUNK_B + TILE * LDS * 4 + TILE_F;
static_assert(2 * SMEM <= 228 * 1024 - 2 * 1024, "two blocks an SM");

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_online_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ out, int S, int H,
                              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * TILE;
  const int rows = min(TILE, S - q0);
  const int ld = H * DH;  // row stride of (B, S, H, 64)
  const size_t head = (size_t)b * S * ld + (size_t)h * DH;

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + TILE_B);
  bf16* vs = reinterpret_cast<bf16*>(smem + TILE_B + CHUNK_B);
  float* sf = reinterpret_cast<float*>(smem + TILE_B + 2 * CHUNK_B);
  bf16* ps = reinterpret_cast<bf16*>(sf);
  float* acc = reinterpret_cast<float*>(smem + TILE_B + 2 * CHUNK_B +
                                        TILE * LDS * 4);

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;             // 16-row strip of the tile
  const int row = threadIdx.x / 4;     // softmax: 4 threads a row ...
  const int quarter = threadIdx.x % 4;  // ... 32 keys, 16 outputs each

  stage_tile(qs, q + head + (size_t)q0 * ld, ld, rows);
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[row * LDF + quarter * 16 + j] = 0.0f;
  float m = -INFINITY;  // running max of the row
  float l = 0.0f;       // running denominator

  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int kv = min(CHUNK, S - c0);
    for (int half = 0; half < CHUNK / TILE; ++half) {
      const int r0 = c0 + half * TILE;
      const int n = max(0, min(TILE, S - r0));
      stage_tile(ks + half * TILE * LDB, k + head + (size_t)r0 * ld, ld, n);
      stage_tile(vs + half * TILE * LDB, v + head + (size_t)r0 * ld, ld, n);
    }
    __syncthreads();

    // s = Q K_c^T: warp (rf, half) computes a 16 x 64 strip.
    {
      const int cf = (warp % 2) * 4;
      FragC sacc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(sacc[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, qs + rf * 16 * LDB + kk, LDB);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBCol bm;
          wmma::load_matrix_sync(bm, ks + (cf + j) * 16 * LDB + kk, LDB);
          wmma::mma_sync(sacc[j], a, bm, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(sf + rf * 16 * LDS + (cf + j) * 16, sacc[j],
                                LDS, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // The row's max, p, denominator and correction; the accumulator rows
    // scaled by the correction.
    float p[32];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = quarter * 32 + j;
      p[j] = c < kv ? sf[row * LDS + c] * scale : -INFINITY;
      cmax = fmaxf(cmax, p[j]);
    }
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = quarter * 32 + j < kv ? expf(p[j] - m_new) : 0.0f;
      psum += p[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[row * LDF + quarter * 16 + j] *= corr;
    __syncthreads();  // every score read before P overwrites the scores
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(ps + row * LDP + quarter * 32 + j) =
          __floats2bfloat162_rn(p[j], p[j + 1]);
    }
    __syncthreads();

    // acc += bf16(P) @ V_c: warp (rf, half) updates a 16 x 32 strip.
    {
      const int cf = (warp % 2) * 2;
      FragC oacc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(oacc[j], acc + rf * 16 * LDF + (cf + j) * 16,
                               LDF, wmma::mem_row_major);
      }
#pragma unroll
      for (int kk = 0; kk < CHUNK; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ps + rf * 16 * LDP + kk, LDP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBRow bm;
          wmma::load_matrix_sync(bm, vs + kk * LDB + (cf + j) * 16, LDB);
          wmma::mma_sync(oacc[j], a, bm, oacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(acc + rf * 16 * LDF + (cf + j) * 16, oacc[j],
                                LDF, wmma::mem_row_major);
      }
    }
    __syncthreads();  // before K/V, S and P are restaged
  }

  if (row < rows) {
    bf16* dst = out + head + (size_t)(q0 + row) * ld + quarter * 16;
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(
          acc[row * LDF + quarter * 16 + j] / l,
          acc[row * LDF + quarter * 16 + j + 1] / l);
    }
  }
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v/out (B, S, H, 64), bf16, contiguous. Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
int pigeon_flash_attention_online(const void* q, const void* k,
                                  const void* v, void* out, int batch,
                                  int seq, int heads, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_online_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + TILE - 1) / TILE, batch * heads);
  flash_attention_online_kernel<<<grid, THREADS, SMEM,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seq, heads,
      1.0f / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
