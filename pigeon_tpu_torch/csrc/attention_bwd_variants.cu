// The attention-backward tuning variants of scripts/bench_attn_bwd.py on
// (B, S, H, 64) q/k/v and output cotangent g, for Hopper (sm_90a). Each
// replaces one Pallas body of that script (the TPU file and function are
// named at its entry point below); on the card they answer what bounds
// K4 (flash_attention_bwd.cu) and K2's attention passes:
//
//   V1 bwd_r_from_o  K4's dq, dk, dv with r = sum(g * (bf16(u) v) / den),
//                    u = exp(s - m) against the exact row max: r from the
//                    recomputed output, where K4 takes sum(dp * u) / den.
//                    It runs on K4's wgmma passes (flash_bwd_sm90.cuh)
//                    under its own tag, V1Attention: a statistics pass of
//                    its own (flash_attention_bwd_stats_from_output_kernel:
//                    K4's block, Q and G tiles and K/V ring; one sweep of
//                    Q K^T for the exact max, a second for u, den and
//                    o_rec = bf16(u) V on wgmma, then r from G's tile),
//                    then K4's gradient and dq passes unchanged. Eight
//                    S x S x 64 walks against K4's seven, as the TPU
//                    body's six products against K4's five: the time
//                    against K4's in one driver run is what statistics
//                    from the output, not from dp, cost or save.
//   V2 dq            dq alone (the script's split4, first half): K4's
//                    statistics pass under the tag V2Attention (two walks:
//                    s, dp), then a query-major dq pass
//                    (flash_attention_bwd_rows_dq_kernel, three walks: s,
//                    dp, dl k) that keeps each row's dq in registers. 2 + 3
//                    walks against the TPU body's 3 products. The g_n the
//                    statistics pass writes goes unread.
//   V3 dkv           dk, dv alone (split4's second half): K4's statistics
//                    pass under V3Attention, then K4's gradient pass
//                    without its dq product (DQ = false: no dl^T tile, no
//                    f32 workspace, no reduce-add, no dq cast). 2 + 4
//                    walks against the TPU body's 4.
//   V4 dots_only     diagnostic: K4's products with the softmax chain
//                    replaced by casts (s = q k^T unscaled, dv = bf16(s)^T
//                    g, dp = g v^T, dl = bf16(s * dp), dq = dl k,
//                    dk = dl^T q). K4's gradient pass under its own tag,
//                    V4Attention, and chain policy, CastChain (u = s,
//                    dl = s dp: no exp, no statistics staged or read; dv's
//                    B operand is g itself through the g_n map), then K4's
//                    dq cast; no statistics pass. Five walks, the TPU
//                    body's five. K4's gradient time minus V4's in one run
//                    is what the exps and the statistics cost that pass.
//   V5 vpu_only      diagnostic: the scores and K4's S-wide softmax chain
//                    with the output products removed (dp stands in as
//                    the scaled scores): dq = bf16(q + bf16(dl[:, :64])),
//                    dk = k, dv = bf16(g / den). K4's statistics pass
//                    under V5Attention without G V^T (DP = false: dp =
//                    s scale, V never loaded; the online max, its
//                    rescales and the (3, B, H, S) workspace as K4's),
//                    whose g_n = bf16(g / den) is written straight into
//                    dv; then one query-major sweep
//                    (flash_attention_bwd_dl_sweep_kernel: s = Q K^T, dl
//                    against the final max, sum |dl|, dq from chunk 0,
//                    dk = k). One walk each. K4's
//                    statistics time minus V5's in one run is what the dp
//                    product costs that pass; V5's is what the online max,
//                    its shuffles and rescales cost.
//
// Why V2 and V3 need a statistics pass the TPU bodies do not: a TPU body
// holds a head's whole (S, S) score block in VMEM, so it finds each row's
// max, den and r in the block it takes the products from. A Hopper block
// holds 128 rows and one 128-key chunk (227 KB of shared memory): V3's
// key-major block never sees a whole query row, and V2's query-major
// block needs the row's r, a sum over every key, before its first dl.
//
// What bounds them on the H100, at the tuning shape (B = 32 views,
// S = 577, H = 16): the TPU bodies' products are ~22 GFLOP each
// (2 B H S^2 64, 0.022 ms at 989 TFLOP/s); V1 has six (~131 GFLOP,
// ~0.13 ms), V2 three and V3 four (~153 GFLOP together), V4 five; q/k/v/g
// and the outputs are ~265 MB (~0.08 ms), so the tensor cores bound the
// exact variants and V4. V2 and V3 walk 5 and 6 times, each walk's
// products waiting on its exps. V5's TPU body does one product and ~12
// f32 operations an S x S element (~2 G at 67 TFLOP/s, ~0.03 ms): its
// bytes bound it, and its time is what the softmax chain costs on K4's
// statistics pass plus one sweep for dl.
//
// Keeping the measured work alive: nvcc deletes what never reaches
// memory. V5 stores only dl's first 64 columns; every other column of dl
// goes into a per-row f32 side output, sum(|dl|) over all S keys, which
// the plain version computes too. V4's and V1-V3's outputs read every
// product. chip_smoke.py counts MUFU.EX2 in the SASS of V5's two kernels
// (cuobjdump -sass of the sm_90a build) and fails if either has none.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// bf16, (B, S, H, 64) contiguous and 16-byte aligned; V5 needs S >= 64;
// V1-V3 and V5 take K4's row-statistics workspace (3, B, H, S) f32, V1-V3
// its g_n (B, S, H, 64) bf16; V1 and V4 K4's zeroed dq_acc (B, H,
// ceil(S / 64), 4096) f32. Ragged S is masked: TMA reads zeros past row
// S, keys past S get u = 0, and rows past S are never written.

#include "flash_bwd_sm90.cuh"

namespace {

// V1-V5's instances of K4's passes.
struct V1Attention {};
struct V2Attention {};
struct V3Attention {};
struct V4Attention {};
struct V5Attention {};

// V1-V5's arguments of K4's passes: the statistics (3, B, H, S) f32
// (null for V4) and g_n workspaces, dq_acc (V1 and V4, else null) and the
// outputs each produces (the others null).
BwdArgs bwd_args(void* stats, void* g_n, void* dq_acc, void* dq, void* dk,
                 void* dv, int batch, int seq, int heads) {
  BwdArgs args = {};
  if (stats) {
    float* f = static_cast<float*>(stats);
    const size_t n_rows = (size_t)batch * heads * seq;
    args.m = f;
    args.den = f + n_rows;
    args.r = f + 2 * n_rows;
  }
  args.g_n = static_cast<bf16*>(g_n);
  args.dq_acc = static_cast<float*>(dq_acc);
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.S = seq;
  args.H = heads;
  args.scale = 1.0f / sqrtf(static_cast<float>(HD));
  args.scale_log2 = args.scale * LOG2E;
  return args;
}

bool bad_shape(int batch, int seq, int heads) {
  return batch < 1 || seq < 1 || heads < 1;
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// V1, scripts/bench_attn_bwd.py::bwd_r_from_o: dq, dk, dv, with K4's
// workspaces (stats, g_n and dq_acc, zeroed).
int pigeon_attention_bwd_r_from_o(const void* q, const void* k,
                                  const void* v, const void* g, void* dq,
                                  void* dk, void* dv, void* stats, void* g_n,
                                  void* dq_acc, int batch, int seq, int heads,
                                  void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const BwdArgs args =
      bwd_args(stats, g_n, dq_acc, dq, dk, dv, batch, seq, heads);
  return static_cast<int>(
      launch_flash_backward<V1Attention, BwdPasses::kFromOutput>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V2, scripts/bench_attn_bwd.py::dq_body: dq, with K4's statistics and
// g_n workspaces.
int pigeon_attention_dq(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* stats, void* g_n,
                        int batch, int seq, int heads, void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const BwdArgs args = bwd_args(stats, g_n, nullptr, dq, nullptr, nullptr,
                                batch, seq, heads);
  return static_cast<int>(
      launch_flash_backward<V2Attention, BwdPasses::kRowsDq>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V3, scripts/bench_attn_bwd.py::dkv_body: dk, dv, with K4's statistics
// and g_n workspaces.
int pigeon_attention_dkv(const void* q, const void* k, const void* v,
                         const void* g, void* dk, void* dv, void* stats,
                         void* g_n, int batch, int seq, int heads,
                         void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  const BwdArgs args = bwd_args(stats, g_n, nullptr, nullptr, dk, dv, batch,
                                seq, heads);
  return static_cast<int>(
      launch_flash_backward<V3Attention, BwdPasses::kDkDv>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V4, scripts/bench_attn_bwd.py::dots_only: dq, dk, dv, with K4's
// zeroed dq_acc.
int pigeon_attention_bwd_dots_only(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, void* dq_acc,
                                   int batch, int seq, int heads,
                                   void* stream) {
  if (bad_shape(batch, seq, heads)) return cudaErrorInvalidValue;
  // dv = bf16(s)^T g: the gradient pass's g_n map reads g itself.
  const BwdArgs args = bwd_args(nullptr, const_cast<void*>(g), dq_acc, dq,
                                dk, dv, batch, seq, heads);
  return static_cast<int>(
      launch_flash_backward<V4Attention, BwdPasses::kDotsOnly>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

// V5, scripts/bench_attn_bwd.py::vpu_only: dq, dk, dv and each row's
// sum(|dl|) into dl_abs (B, H, S) f32, with K4's statistics workspace.
int pigeon_attention_bwd_vpu_only(const void* q, const void* k,
                                  const void* v, const void* g, void* dq,
                                  void* dk, void* dv, void* dl_abs,
                                  void* stats, int batch, int seq, int heads,
                                  void* stream) {
  if (bad_shape(batch, seq, heads) || seq < HD) return cudaErrorInvalidValue;
  // dv = bf16(g / den) is the statistics pass's g_n.
  BwdArgs args = bwd_args(stats, dv, nullptr, dq, dk, dv, batch, seq, heads);
  args.dl_abs = static_cast<float*>(dl_abs);
  return static_cast<int>(
      launch_flash_backward<V5Attention, BwdPasses::kVpuOnly>(
          q, k, v, g, args, batch, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
