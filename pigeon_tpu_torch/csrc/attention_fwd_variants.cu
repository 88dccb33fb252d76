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
//   V8 qk_only       diagnostic: out = bf16(f32(bf16(q k^T)[:, :64]) + v),
//                    and rowsum (B, H, S) f32, each row's sum of q k^T
//                    over all S keys.
//   V9 qk_chunked    diagnostic: out = bf16(the row's sum of q k^T + v),
//                    the sum broadcast over the 64 columns.
//
// V8 and V9 are K3's forward at 128-key steps with PV = false under
// SumChain and their own tags, V8Attention and V9Attention: one walk of
// s = Q K_c^T by four m64n128k16 steps a chunk, V never loaded as tiles.
// The chain only adds the thread's 32 scores of each row into l (no mask:
// keys past S score 0 against zero-filled K rows; no max, exp or corr),
// and the epilogue reduces l over the row's four threads. After chunk 0
// o takes the raw scores of keys 0-63 (the first 32 score registers, in
// o's m64n64 layout), never rescaled. V8's output policy
// AttnOutScoresPlusBf16 rounds o to bf16 before it adds v and writes l to
// rowsum once a row; V9's AttnOutSumPlusBf16 writes l + v in every
// column, so its o is dead. Both read their v pairs when the tile starts,
// as V7 does. So K3's time less V9's is what K3 spends beyond its score
// walk, V7's less V9's the softmax chain on one walk (which nothing
// overlaps), and V6's less V9's the P V walk.
//
// What bounds them on the H100, at the tuning shape (B = 32 views,
// S = 577, H = 16): q/k/v and the output are ~151 MB (~0.045 ms at
// 3.35 TB/s; V7, V8 and V9 read v once, for the add); one S x S x 64
// product is ~21.8 GFLOP (~0.022 ms at 989 TFLOP/s). V10 and V6 do two
// products, V7, V8 and V9 one; V10's and V7's softmax adds ~5 f32
// operations and an exp an S x S element (~1 G, ~0.015 ms), V8's and
// V9's sums one add an element. The bytes and the products are within a
// factor two of each other: neither leaves room, and the diagnostics'
// times against K3's say which part of K3's time is which.
//
// Keeping the measured work alive: nvcc deletes what never reaches
// memory. V8 stores only 64 score columns; every score enters l, which
// its side output rowsum reads (the plain version computes it too). V7
// stores only p's first 64 columns, but every p enters l, which every
// output reads. V6 and V9 read every product into their outputs. Checked
// in the SASS (cuobjdump -sass of the sm_90a build; chip_smoke.py's
// [sass] lines): V6 24 HGMMA, as K3's instance, and no MUFU.EX2; V7 8
// HGMMA (K3's less the 16 of P V) and K3's 132 MUFU.EX2; V8 and V9 8
// HGMMA and no MUFU.EX2 each; no HMMA in the source.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// bf16, (B, S, H, 64) contiguous and 16-byte aligned; V7 and V8 need
// S >= 64. Rows of K/V past S are zero-filled (and masked where a
// softmax runs); query rows past S are never written.

#include "flash_fwd_sm90.cuh"

namespace {

struct V10OnlineForward {};  // V10's instance of the streaming forward
struct V6Attention {};       // V6's: CastChain
struct V7Attention {};       // V7's: no P V
struct V8Attention {};       // V8's: SumChain, no P V, rowsum
struct V9Attention {};       // V9's: SumChain, no P V

// V7's output, bf16(o / l + v): v the query row's own V row, at the
// output's offset of the same (B, S, H, 64) layout.
struct AttnOutPlusBf16 {
  typedef bf16 T;
  static constexpr bool SCALED = false;
  static constexpr bool ADDS = true;
  static constexpr bool ROWSUM = false;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float, float, uint32_t add) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&add));
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0 + v.x, o1 + v.y);
  }
};

// V8's output, bf16(f32(bf16(o)) + v): o the raw scores of keys 0-63,
// rounded to bf16 before v is added, as the TPU body casts its logits;
// the row's sum l to the side output rowsum.
struct AttnOutScoresPlusBf16 {
  typedef bf16 T;
  static constexpr bool SCALED = false;
  static constexpr bool ADDS = true;
  static constexpr bool ROWSUM = true;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float, float, uint32_t add) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&add));
    const float2 s = __bfloat1622float2(__floats2bfloat162_rn(o0, o1));
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(s.x + v.x, s.y + v.y);
  }
};

// V9's output, bf16(l + v): the row's sum of q k^T in every column.
struct AttnOutSumPlusBf16 {
  typedef bf16 T;
  static constexpr bool SCALED = false;
  static constexpr bool ADDS = true;
  static constexpr bool ROWSUM = false;
  __device__ static __forceinline__ void store(T* dst, float, float, float l,
                                               float, uint32_t add) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&add));
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(l + v.x, l + v.y);
  }
};

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
  if (seq < HD) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_flash_forward<V8Attention, AttnOutScoresPlusBf16, FWD_CHUNK,
                           SumChain, false>(
          q, k, v, out, batch, seq, heads,
          static_cast<cudaStream_t>(stream), nullptr, v,
          static_cast<float*>(rowsum)));
}

// V9, scripts/bench_attn_fwd_diag.py::qk_chunked.
int pigeon_attention_fwd_qk_chunked(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq, int heads, void* stream) {
  return static_cast<int>(
      launch_flash_forward<V9Attention, AttnOutSumPlusBf16, FWD_CHUNK,
                           SumChain, false>(
          q, k, v, out, batch, seq, heads,
          static_cast<cudaStream_t>(stream), nullptr, v));
}

}  // extern "C"
