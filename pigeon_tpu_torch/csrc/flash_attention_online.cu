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
// wgmma are later work). The body is online_attention_tile.cuh's, with
// the chunk a template parameter: this kernel is its <128, 2 blocks an
// SM> instance; the 256-key tuning variant (attention_fwd_variants.cu)
// another.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// q/k/v/out bf16, contiguous, 16-byte aligned. Keys past S are staged as
// zeros and masked; query rows past S are never written.

#include "online_attention_tile.cuh"

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v/out (B, S, H, 64), bf16, contiguous. Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
int pigeon_flash_attention_online(const void* q, const void* k,
                                  const void* v, void* out, int batch,
                                  int seq, int heads, void* stream) {
  return static_cast<int>(launch_online_attention<128, 2>(
      q, k, v, out, batch, seq, heads, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
