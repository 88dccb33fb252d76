// Online-softmax attention forward on (B, S, H, 64) q/k/v, for Hopper
// (sm_90a).
//
// Replaces pigeon_tpu/kernels/flash_attention.py::_attn_kernel_online, the
// body `_flash_forward` takes under PIGEON_FLASH_FWD=online (reached through
// `mha`: the `flash` route and the int8 calibration forward). Exact
// attention with a running max: for each query row and each chunk of
// ONLINE_CHUNK = 128 keys (the last one ragged, 65 keys at S = 577),
//
//     s     = (q k_c^T) * 64^-0.5                          (f32)
//     m_new = max(m, max_c(s));  p = exp(s - m_new);  corr = exp(m - m_new)
//     l     = l * corr + sum(p)                             (f32 p)
//     acc   = acc * corr + bf16(p) @ v_c                    (f32)
//
// and out = bf16(acc / l). bf16(p) is taken relative to the RUNNING max, so
// this is a different function from _attn_kernel's in bf16, as on the TPU.
//
// What bounds it on the H100: at the calibration shape (B=80 views, S=577,
// H=16) ~109 GFLOP of bf16 tensor-core work (QK^T and PV once each) over
// ~378 MB of q/k/v/out: ~290 FLOP per byte, at the card's ridge, so the
// bytes bound it (~0.113 ms) if K and V come from HBM once per head.
//
// The function is the one K3's Hopper kernel computes (128-key chunks, p
// rounded against the running max, l from f32 p), so this kernel is K3's
// streaming forward (flash_fwd_sm90.cuh): a persistent grid of 128-row
// query tiles, K and V streamed by TMA through a four-stage ring, both
// products on wgmma with the scores, p and the output kept in registers,
// the next chunk's scores overlapping this chunk's P V. Its own tag
// (K3OnlineForward) makes it a symbol of its own. One difference from the
// TPU body: the exponent is 2^(s c2 - m c2) with c2 = 64^-0.5 log2(e)
// folded into one FFMA (ex2.approx), not exp of the scaled f32 logits; the
// two differ by a few f32 ulps before p is rounded to bf16.
//
// Constraints (checked by the Python wrapper before launch): head_dim 64,
// any S >= 1, q/k/v/out bf16, (B, S, H, 64) contiguous, 16-byte aligned.
// Keys past S are masked; query rows past S are never written.

#include "flash_fwd_sm90.cuh"

namespace {
struct K3OnlineForward {};  // this kernel's instance of the forward
}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v/out (B, S, H, 64), bf16, contiguous. Launches on `stream` and
// returns the first failing call's cudaError_t (0 on success).
int pigeon_flash_attention_online(const void* q, const void* k,
                                  const void* v, void* out, int batch,
                                  int seq, int heads, void* stream) {
  return static_cast<int>(launch_flash_forward<K3OnlineForward>(
      q, k, v, out, batch, seq, heads, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
