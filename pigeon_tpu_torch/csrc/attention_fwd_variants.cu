// The attention-forward tuning variants of scripts/bench_attn_fwd_diag.py
// on (B, S, H, 64) q/k/v, for Hopper (sm_90a). Each replaces one Pallas
// body of that script (named at its entry point below); on the card they
// answer what bounds K3 (flash_attention.cu) and K3′
// (flash_attention_online.cu):
//
//   V10 online_c256  exact attention, online softmax over 256-key chunks
//                    (p rounded to bf16 against the running max, l from
//                    f32 p): K3′'s function at chunk 256. It runs K3's
//                    streaming wgmma forward (flash_fwd_sm90.cuh) at
//                    STEP = 256 under its own tag, V10OnlineForward: TMA
//                    keeps loading 128-key K/V tiles into the four-stage
//                    ring and a step consumes two of them, s of both
//                    halves in registers (2 x four m64n128k16), one max
//                    over both before any exp, then 16 m64n64k16 P V
//                    steps from registers, the first half's under the
//                    second half's exps. Against K3′ (128-key steps, the
//                    next chunk's s overlapped with this one's P V) it
//                    takes half the max shuffles and rescales of o, and
//                    gives up the overlap of Q K^T with the softmax. Its
//                    exponent is K3′'s, 2^(s c2 - m c2) by one FFMA and
//                    ex2.approx, c2 = 64^-0.5 log2(e); the TPU body takes
//                    exp of the scaled f32 scores (a few f32 ulps apart
//                    before the bf16 rounding).
//   V6 dots_only     diagnostic: bf16(q k^T) v, no scale, no softmax. K3's
//                    streaming forward at 128-key steps under CastChain
//                    and its own tag, V6Attention: s = Q K_c^T by four
//                    m64n128k16 steps, bf16(s) packed straight into the A
//                    fragments, eight m64n64k16 P V steps, the next
//                    chunk's s issued with this chunk's P V as in K3; no
//                    mask (keys past S score 0 on zero-filled K rows and
//                    meet zero V rows), max, exp or l; o stored undivided.
//                    K3's time less V6's is what the softmax chain costs
//                    K3 with the products' schedule kept.
//   V7 softmax_only  diagnostic: the scaled scores' softmax with the PV
//                    product removed: out = p[:, :64] / den + v, v the
//                    query row's own V row. K3's forward with PV = false
//                    under V7Attention: V never loaded, no P V product;
//                    after chunk 0's exps o takes p of keys 0-63 (the
//                    first 32 score registers are in o's m64n64 layout),
//                    is rescaled by corr at every later chunk as K3
//                    rescales o, and is written as o / l + v by the
//                    output policy AttnOutPlusBf16. The kernel reads
//                    the thread's v pairs when the tile starts, so the
//                    load waits under the chunks, not in the epilogue,
//                    where it would add to V7 a wait that K3 does not
//                    have. p of chunk 0 is taken against chunk 0's max
//                    and corrected, a few f32 ulps from the TPU body's
//                    exp(s scale - max s). K3's time less V7's is what
//                    the P V walk costs K3.
//   V8 qk_only       diagnostic: out = bf16(q k^T)[:, :64] + v.
//   V9 qk_chunked    diagnostic: out = sum over keys of q k^T, plus v.
//
// V8 and V9 take a block per (64-row query tile, head, batch) and walk the
// key tiles through shared memory (K staged 64 rows at a time, WMMA
// 16x16x16 bf16 fragments from attention_tile.cuh, f32 accumulation), the
// design the attention kernels had before wgmma.
//
// What bounds them on the H100, at the tuning shape (B = 32 views,
// S = 577, H = 16): q/k/v and the output are ~151 MB (~0.045 ms at
// 3.35 TB/s); one S x S x 64 product is ~22 GFLOP (~0.022 ms at 989
// TFLOP/s). V10 and V6 do two products, V7, V8 and V9 one; V10's and
// V7's softmax adds ~5 f32 operations and an exp an S x S element (~1 G,
// ~0.015 ms). The bytes and the products are within a factor two of each
// other: neither leaves room, and the diagnostics' times against K3's say
// which part of K3's time is which.
//
// Keeping the measured work alive: nvcc deletes what never reaches
// memory. V8 stores only 64 score columns; every other score goes into a
// per-row f32 side output, the row's sum of q k^T over all S keys, which
// the plain version computes too. V7 stores only p's first 64 columns,
// but every p enters l, which every output reads. V6 and V9 read every
// product into their outputs. Checked in the SASS (cuobjdump -sass of the
// sm_90a build; chip_smoke.py's [sass] lines): V6 24 HGMMA, as K3's
// instance, and no MUFU.EX2; V7 8 HGMMA (K3's less the 16 of P V) and
// K3's 132 MUFU.EX2; V8 and V9 16 HMMA each (the score tile of every
// key tile).
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// bf16, (B, S, H, 64) contiguous and 16-byte aligned; V7 and V8 need
// S >= 64. Rows of K/V past S are zero-filled (and masked where a
// softmax runs); query rows past S are never written.

#include "attention_tile.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

struct V10OnlineForward {};  // V10's instance of the streaming forward
struct V6Attention {};       // V6's: CastChain
struct V7Attention {};       // V7's: no P V

// V7's output, bf16(o / l + v): v the query row's own V row, at the
// output's offset of the same (B, S, H, 64) layout.
struct AttnOutPlusBf16 {
  typedef bf16 T;
  static constexpr bool SCALED = false;
  static constexpr bool ADDS = true;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float, uint32_t add) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&add));
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0 + v.x, o1 + v.y);
  }
};

constexpr int DIAG_SMEM = 2 * TILE_B + TILE_F;  // 35,840 B

// Numbered as when V6 and V7 were 0 and 1, so that fwd_diag_kernel's
// instances keep their names (scripts/compare_torch_sass.py pairs kernels
// across checkouts by name and first template argument).
enum Diag { QK_ONLY = 2, QK_CHUNKED = 3 };

struct FwdArgs {
  const bf16 *q, *k, *v;  // (B, S, P)
  bf16* out;              // (B, S, P)
  float* rowsum;          // (B, H, S), V8's side output
  int S, H;
};

template <int KIND>
__global__ void __launch_bounds__(THREADS) fwd_diag_kernel(FwdArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = args.S, H = args.H, P = H * DH;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int q0 = qt * TILE;
  const int rows = min(TILE, S - q0);

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TILE * LDB;
  float* sf = reinterpret_cast<float*>(smem + 2 * TILE_B);

  const int warp = threadIdx.x / 32;
  const int rf = warp / 2;
  const int cf = (warp % 2) * 2;
  const int row = threadIdx.x / 4;
  const int c0 = (threadIdx.x % 4) * 16;

  const size_t head = (size_t)b * S * P + h * DH;
  stage_tile(qs, args.q + head + (size_t)q0 * P, P, rows);

  float sum = 0.0f;  // the row's sum of the scores
  float first[16];   // V8: the scores of the first 64 keys
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv = min(TILE, S - kt * TILE);
    stage_tile(ks, args.k + head + (size_t)kt * TILE * P, P, kv);
    __syncthreads();
    score_tile(sf, qs, ks, rf, cf);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      const float s = c < kv ? sf[row * LDF + c] : 0.0f;
      sum += s;
      if (kt == 0) first[j] = s;
    }
  }

  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (row >= rows) return;
  const size_t at = head + (size_t)(q0 + row) * P + c0;
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    float o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = __bfloat162float(args.v[at + j + i]);
      if (KIND == QK_ONLY) {
        o[i] = __bfloat162float(__float2bfloat16(first[j + i])) + v;
      } else {
        o[i] = sum + v;
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(args.out + at + j) =
        __floats2bfloat162_rn(o[0], o[1]);
  }
  if (KIND == QK_ONLY && threadIdx.x % 4 == 0) {
    args.rowsum[((size_t)b * H + h) * S + q0 + row] = sum;
  }
}

template <int KIND>
int launch_diag(const void* q, const void* k, const void* v, void* out,
                void* rowsum, int batch, int seq, int heads, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || (KIND == QK_ONLY && seq < DH)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs args = {};
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.out = static_cast<bf16*>(out);
  args.rowsum = static_cast<float*>(rowsum);
  args.S = seq;
  args.H = heads;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_diag_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DIAG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tiles((seq + TILE - 1) / TILE, heads, batch);
  fwd_diag_kernel<KIND><<<tiles, THREADS, DIAG_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// V10, scripts/bench_attn_fwd_diag.py::online_softmax at chunk=256.
int pigeon_attention_online_c256(const void* q, const void* k, const void* v,
                                 void* out, int batch, int seq, int heads,
                                 void* stream) {
  return static_cast<int>(
      launch_flash_forward<V10OnlineForward, AttnOutBf16, 256>(
          q, k, v, out, batch, seq, heads,
          static_cast<cudaStream_t>(stream)));
}

// V6, scripts/bench_attn_fwd_diag.py::dots_only.
int pigeon_attention_fwd_dots_only(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int seq, int heads, void* stream) {
  return static_cast<int>(
      launch_flash_forward<V6Attention, AttnOutBf16, FWD_CHUNK, CastChain>(
          q, k, v, out, batch, seq, heads,
          static_cast<cudaStream_t>(stream)));
}

// V7, scripts/bench_attn_fwd_diag.py::softmax_only.
int pigeon_attention_fwd_softmax_only(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int seq, int heads, void* stream) {
  if (seq < HD) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_flash_forward<V7Attention, AttnOutPlusBf16, FWD_CHUNK,
                           SoftmaxChain, false>(
          q, k, v, out, batch, seq, heads,
          static_cast<cudaStream_t>(stream), nullptr, v));
}

// V8, scripts/bench_attn_fwd_diag.py::qk_only; rowsum (B, H, S) f32 takes
// each row's sum of q k^T over all S keys.
int pigeon_attention_fwd_qk_only(const void* q, const void* k, const void* v,
                                 void* out, void* rowsum, int batch, int seq,
                                 int heads, void* stream) {
  return launch_diag<QK_ONLY>(q, k, v, out, rowsum, batch, seq, heads,
                              stream);
}

// V9, scripts/bench_attn_fwd_diag.py::qk_chunked.
int pigeon_attention_fwd_qk_chunked(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq, int heads, void* stream) {
  return launch_diag<QK_CHUNKED>(q, k, v, out, nullptr, batch, seq, heads,
                                 stream);
}

}  // extern "C"
