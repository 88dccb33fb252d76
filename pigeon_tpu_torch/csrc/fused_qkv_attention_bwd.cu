// Fused QKV projection + softmax attention BACKWARD, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_fused_qkv_bwd_kernel
// (launcher `_fused_qkv_backward`, the VJP of `fused_qkv_mha` on the
// training route of every CLIP encoder layer). Given x (B, S, D), the
// Linear-layout weights W* (P, D), biases b* (P,) and the output
// cotangent g (B, S, P), it returns dx (B, S, D) and the projection
// cotangents dq, dk, dv (B, S, P), at the rounding points of
// flash_attention.py:397-455:
//
//   q, k, v = bf16(x @ W*^T + b*)                       (f32 bias add)
//   s = (q k^T) * scale,  m = rowmax(s),  u = exp(s - m),  den = sum(u)
//   g_n = bf16(g / den),  dv = bf16(u)^T g_n
//   dp = g v^T (f32),     r = sum(dp * u) / den        (from f32 u)
//   dl = bf16(u * (dp - r) * scale / den)
//   dq = dl k,  dk = dl^T q,  dx = dq Wq + dk Wk + dv Wv  (f32 accumulate)
//
// The weight and bias gradients are left to the caller (cuBLAS), as the
// JAX package leaves them to XLA.
//
// What bounds it on the H100: at the training shape (B=32 views, S=577,
// D=1024, H=16) the call is ~450 GFLOP of bf16 tensor-core work: the
// q/k/v projection and the dx product are ~116 GFLOP each, and the
// attention part recomputes the scores four times and dp three times
// (~218 GFLOP), over ~300 MB of operands and workspace, far above the
// card's ~295 FLOP per byte. The tensor cores bound it, and this first
// form feeds them with WMMA (mma.sync) from shared memory.
//
// The TPU kernel keeps two (S, S) f32 buffers per head in VMEM; a Hopper
// block has 227 KB. So the work is four launches, none with atomics, each
// giving the same sums in every run (passes 2 and 3 are the attention
// backward of attention_bwd_tile.cuh, which K4 launches alone):
//
//   1. proj:  q/k/v = bf16(x W*^T + b*) into a bf16 workspace (B, S, P)
//             each (113 MB at B=32): a tiled GEMM, 128 x 128 block tiles,
//             K in 32-wide steps double-buffered with cp.async. Keeping
//             q/k/v on chip, as the TPU kernel does, is later work.
//   2. dq:    one block per (query tile, head, batch) holds its Q and G
//             tiles and walks the key tiles three times: the row max m;
//             den and sum(dp * u) (so r comes from f32 u, not from the
//             forward's bf16 output); then dl and dq += dl k. It writes
//             m, den and r for pass 3.
//   3. dk/dv: one block per (key tile, head, batch) holds its K and V
//             tiles and walks the query tiles: dv += bf16(u)^T g_n and
//             dk += dl^T q, with the row statistics from pass 2.
//   4. dx:    [dq|dk|dv] (B*S, 3P) @ [Wq;Wk;Wv] (3P, D), the head
//             reduction the TPU kernel did in a VMEM scratch across its
//             in-order group sweep; here a tiled GEMM, K = 3P, f32
//             accumulation.
//
// At the training shape passes 2 and 3 run 32 x 16 x 10 = 5,120 blocks
// each. Ragged S is masked as in K1: rows past S are staged as zeros,
// get u = 0 and are never written.
//
// Constraints (checked by the Python wrapper): head_dim 64, D and P
// multiples of 128, all operands bf16, contiguous, 16-byte aligned.

#include "attention_bwd_tile.cuh"

namespace {

// GEMM tiling: 128 x 128 block tile, 32-deep K steps, 8 warps as 4 (M)
// x 2 (N), each warp 32 x 64 (2 x 4 fragments).
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDK = BK + 8;   // a tile stored (row, k): 40
constexpr int LDN = BN + 8;   // a tile stored (k, col): 136
constexpr int STAGE = BM * LDK * 2;  // 10240 B, >= BK * LDN * 2 = 8704 B
constexpr int EPI_LD = 20;    // per-warp 16 x 16 f32 epilogue, row stride

// ---------------------------------------------------------------------
// Passes 1 and 4: tiled GEMMs.
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct GemmArgs {
  const bf16* a[3];     // proj: a[0] = x (M, D); dx: dq, dk, dv (M, P)
  const bf16* w[3];     // Wq, Wk, Wv (P, D)
  const bf16* bias[3];  // proj: bq, bk, bv
  bf16* out[3];         // proj: q, k, v (M, P); dx: out[0] = dx (M, D)
  int M, D, P;
};

// PROJ: out_t[m, n] = bf16(sum_k x[m, k] W_t[n, k] + b_t[n]) for the
//       three matrices t laid side by side along N (N = 3P, K = D).
// DX:   out[m, n] = bf16(sum_t sum_k d_t[m, k] W_t[k, n]) with the three
//       products laid end to end along K (K = 3P, N = D).
template <bool PROJ>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(GemmArgs args) {
  __shared__ __align__(128) unsigned char smem[4 * STAGE];
  const int M = args.M, D = args.D, P = args.P;
  const int K = PROJ ? D : 3 * P;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // 32-row strip of the block tile
  const int wn = warp % 2;  // 64-column strip
  // PROJ: the block's 128 columns lie inside one of the three matrices.
  const int t_out = PROJ ? n0 / P : 0;

  auto load_stage = [&](int buf, int k0) {
    bf16* as = reinterpret_cast<bf16*>(smem + buf * 2 * STAGE);
    bf16* bs = reinterpret_cast<bf16*>(smem + buf * 2 * STAGE + STAGE);
    const int t = PROJ ? 0 : k0 / P;
    const bf16* a = args.a[t];
    const int lda = PROJ ? D : P;
    const int ka = PROJ ? k0 : k0 - t * P;
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(as + r * LDK + c,
                 a + (size_t)(ok ? m : 0) * lda + ka + c, ok);
    }
    if constexpr (PROJ) {
      // W_t rows n (the output columns), K contiguous: stored (n, k).
      const bf16* w = args.w[t_out] + (size_t)(n0 - t_out * P) * D;
      for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        cp_async16(bs + r * LDK + c, w + (size_t)r * D + k0 + c, true);
      }
    } else {
      // W_t rows k, the output columns n contiguous: stored (k, n).
      const bf16* w = args.w[t] + (size_t)(k0 - t * P) * D;
      for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
        const int r = i / (BN / 8);
        const int c = (i % (BN / 8)) * 8;
        cp_async16(bs + r * LDN + c, w + (size_t)r * D + n0 + c, true);
      }
    }
  };

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_stage((s + 1) & 1, (s + 1) * BK);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const bf16* as = reinterpret_cast<const bf16*>(smem + (s & 1) * 2 * STAGE);
    const bf16* bs =
        reinterpret_cast<const bf16*>(smem + (s & 1) * 2 * STAGE + STAGE);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDK + kk,
                               LDK);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (PROJ) {
          FragBCol fb;
          wmma::load_matrix_sync(fb, bs + (wn * 64 + j * 16) * LDK + kk, LDK);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                     acc[i][j]);
        } else {
          FragBRow fb;
          wmma::load_matrix_sync(fb, bs + kk * LDN + wn * 64 + j * 16, LDN);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                     acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16 x 16 f32 patch (overlaying the now
  // idle staging buffers): each lane converts 8 values of one row and
  // writes them as one 16-byte vector.
  float* patch = reinterpret_cast<float*>(smem) + warp * 16 * EPI_LD;
  const int pr = lane / 2;
  const int pc = (lane % 2) * 8;
  bf16* out = args.out[t_out];
  const int ldo = PROJ ? P : D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], EPI_LD, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + pr;
      const int n = n0 + wn * 64 + j * 16 + pc - t_out * P;
      if (m < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = patch[pr * EPI_LD + pc + e];
          if constexpr (PROJ) v[e] += __bfloat162float(args.bias[t_out][n + e]);
        }
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          packed[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(out + (size_t)m * ldo + n) =
            *reinterpret_cast<const uint4*>(packed);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, D); wq/wk/wv (P, D) in torch Linear layout; bq/bk/bv (P,);
// g (B, S, P) -> dx (B, S, D), dq/dk/dv (B, S, P). Workspace: q/k/v
// (B, S, P) bf16 each and stats (3, B, H, S) f32. All bf16 operands
// contiguous, P = heads * 64. Launches the four passes on `stream` and
// returns the first failing launch's cudaError_t (0 on success).
int pigeon_fused_qkv_attention_backward(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* bq, const void* bk, const void* bv, const void* g, void* dx,
    void* dq, void* dk, void* dv, void* q_ws, void* k_ws, void* v_ws,
    void* stats, int batch, int seq, int dim, int heads, void* stream) {
  const int P = heads * DH;
  if (batch < 1 || seq < 1 || heads < 1 || dim % BN != 0 || P % BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = batch * seq;
  const int m_blocks = (M + BM - 1) / BM;
  cudaError_t err;

  GemmArgs proj = {};
  proj.a[0] = static_cast<const bf16*>(x);
  proj.w[0] = static_cast<const bf16*>(wq);
  proj.w[1] = static_cast<const bf16*>(wk);
  proj.w[2] = static_cast<const bf16*>(wv);
  proj.bias[0] = static_cast<const bf16*>(bq);
  proj.bias[1] = static_cast<const bf16*>(bk);
  proj.bias[2] = static_cast<const bf16*>(bv);
  proj.out[0] = static_cast<bf16*>(q_ws);
  proj.out[1] = static_cast<bf16*>(k_ws);
  proj.out[2] = static_cast<bf16*>(v_ws);
  proj.M = M;
  proj.D = dim;
  proj.P = P;
  gemm_kernel<true><<<dim3(m_blocks, 3 * P / BN), THREADS, 0, st>>>(proj);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* f = static_cast<float*>(stats);
  const size_t n_rows = (size_t)batch * heads * seq;
  AttnArgs attn = {};
  attn.q = static_cast<const bf16*>(q_ws);
  attn.k = static_cast<const bf16*>(k_ws);
  attn.v = static_cast<const bf16*>(v_ws);
  attn.g = static_cast<const bf16*>(g);
  attn.dq = static_cast<bf16*>(dq);
  attn.dk = static_cast<bf16*>(dk);
  attn.dv = static_cast<bf16*>(dv);
  attn.m = f;
  attn.den = f + n_rows;
  attn.r = f + 2 * n_rows;
  attn.S = seq;
  attn.H = heads;
  attn.scale = 1.0f / sqrtf(static_cast<float>(DH));
  if ((err = attention_backward_passes(attn, batch, st)) != cudaSuccess) {
    return static_cast<int>(err);
  }

  GemmArgs back = {};
  back.a[0] = static_cast<const bf16*>(dq);
  back.a[1] = static_cast<const bf16*>(dk);
  back.a[2] = static_cast<const bf16*>(dv);
  back.w[0] = proj.w[0];
  back.w[1] = proj.w[1];
  back.w[2] = proj.w[2];
  back.out[0] = static_cast<bf16*>(dx);
  back.M = M;
  back.D = dim;
  back.P = P;
  gemm_kernel<false><<<dim3(m_blocks, dim / BN), THREADS, 0, st>>>(back);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
