// The wgmma GEMM of gemm_sm90.cuh at a tile width the caller names, for
// scripts/bench_torch_flash_sm90.py alone: it times K9's fc1 and fc2, K6's
// out-projection and the int8 GEMMs of K8 and K7 (a q/k/v projection and
// K7's out-projection) with 128 x 128 and 128 x 256 output tiles on the
// same operands, the measurement behind `gemm_sm90`'s choice of tile. No
// path of the package launches it.

#include "gemm_sm90.cuh"

namespace {

struct TilesFc1 {};
struct TilesFc2 {};
struct TilesOutProjection {};
struct TilesS8Projection {};
struct TilesS8OutProjection {};

template <class Tag, class Epilogue>
cudaError_t at_width(int bn, const void* a, const void* w, const void* bias,
                     const void* scale, const void* res, void* out, int M,
                     int N, int K, cudaStream_t st) {
  const GemmIn<Epilogue>* const as[1] = {
      static_cast<const GemmIn<Epilogue>*>(a)};
  const GemmIn<Epilogue>* const ws[1] = {
      static_cast<const GemmIn<Epilogue>*>(w)};
  const GemmBias<Epilogue>* const bs[1] = {
      static_cast<const GemmBias<Epilogue>*>(bias)};
  const float* const ss[1] = {static_cast<const float*>(scale)};
  const bf16* const rs[1] = {static_cast<const bf16*>(res)};
  bf16* const os[1] = {static_cast<bf16*>(out)};
  if (K % Epilogue::Operand::BK) return cudaErrorInvalidValue;
  return bn == 256 ? gemm_sm90_at<Tag, 256, true, Epilogue>(
                         as, ws, bs, os, rs, M, N, K, K, N, st, ss)
                   : gemm_sm90_at<Tag, 128, true, Epilogue>(
                         as, ws, bs, os, rs, M, N, K, K, N, st, ss);
}

}  // namespace

extern "C" {

// out (M, N) = epilogue(a (M, K) w (N, K)^T, bias (N,), scale (N,), res
// (M, N)) with 128 x `bn` tiles (bn 128 or 256, N a multiple of it).
// `which`: 0 K9's fc1 (bias, quick-GELU), 1 K9's fc2 ((res + bias) +
// acc), 2 K6's out-projection (res + (acc + bias)), all bf16; 3 the int8
// projection of K8 and K7 (acc * scale + bias), 4 K7's int8 out-projection
// ((res + bias) + acc * scale): a and w int8, bias and scale f32. Returns
// the cudaError_t.
int pigeon_gemm_sm90_tiles(int which, int bn, const void* a, const void* w,
                           const void* bias, const void* scale,
                           const void* res, void* out, int M, int N, int K,
                           void* stream) {
  if ((bn != 128 && bn != 256) || N % bn || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0) {
    err = at_width<TilesFc1, EpilogueBiasQuickGelu>(bn, a, w, bias, scale,
                                                    res, out, M, N, K, st);
  } else if (which == 1) {
    err = at_width<TilesFc2, EpilogueResidualBiasAcc>(bn, a, w, bias, scale,
                                                      res, out, M, N, K, st);
  } else if (which == 2) {
    err = at_width<TilesOutProjection, EpilogueResidualAccBias>(
        bn, a, w, bias, scale, res, out, M, N, K, st);
  } else if (which == 3) {
    err = at_width<TilesS8Projection, EpilogueDequantBias>(
        bn, a, w, bias, scale, res, out, M, N, K, st);
  } else if (which == 4) {
    err = at_width<TilesS8OutProjection, EpilogueResidualBiasDequant>(
        bn, a, w, bias, scale, res, out, M, N, K, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
