// The wgmma GEMM of gemm_sm90.cuh at a tile width the caller names, for
// scripts/bench_torch_flash_sm90.py alone: it times K9's fc1 and fc2 and
// K6's out-projection with 128 x 128 and 128 x 256 output tiles on the
// same operands, the measurement behind `gemm_sm90`'s choice of tile. No
// path of the package launches it.

#include "gemm_sm90.cuh"

namespace {

struct TilesFc1 {};
struct TilesFc2 {};
struct TilesOutProjection {};

template <class Tag, class Epilogue>
cudaError_t at_width(int bn, const bf16* const* a, const bf16* const* b,
                     const bf16* const* bias, bf16* const* out,
                     const bf16* const* res, int M, int N, int K,
                     cudaStream_t st) {
  return bn == 256 ? gemm_sm90_at<Tag, 256, true, Epilogue>(
                         a, b, bias, out, res, M, N, K, K, N, st)
                   : gemm_sm90_at<Tag, 128, true, Epilogue>(
                         a, b, bias, out, res, M, N, K, K, N, st);
}

}  // namespace

extern "C" {

// out (M, N) = epilogue(a (M, K) w (N, K)^T, bias (N,), res (M, N)) with
// 128 x `bn` tiles (bn 128 or 256, N a multiple of it). `which`: 0 K9's
// fc1 (bias, quick-GELU), 1 K9's fc2 ((res + bias) + acc), 2 K6's
// out-projection (res + (acc + bias)). Returns the cudaError_t.
int pigeon_gemm_sm90_tiles(int which, int bn, const void* a, const void* w,
                           const void* bias, const void* res, void* out,
                           int M, int N, int K, void* stream) {
  if ((bn != 128 && bn != 256) || N % bn || K % GEMM_BK || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* const as[1] = {static_cast<const bf16*>(a)};
  const bf16* const ws[1] = {static_cast<const bf16*>(w)};
  const bf16* const bs[1] = {static_cast<const bf16*>(bias)};
  const bf16* const rs[1] = {static_cast<const bf16*>(res)};
  bf16* const os[1] = {static_cast<bf16*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0) {
    err = at_width<TilesFc1, EpilogueBiasQuickGelu>(bn, as, ws, bs, os,
                                                    nullptr, M, N, K, st);
  } else if (which == 1) {
    err = at_width<TilesFc2, EpilogueResidualBiasAcc>(bn, as, ws, bs, os,
                                                      rs, M, N, K, st);
  } else if (which == 2) {
    err = at_width<TilesOutProjection, EpilogueResidualAccBias>(
        bn, as, ws, bs, os, rs, M, N, K, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
