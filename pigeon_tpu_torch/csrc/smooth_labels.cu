// Haversine distance matrix + label smoothing, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/geodesy.py::_smooth_kernel (launcher
// `smooth_labels_from_points`, the soft geocell targets of every training
// and eval batch). For labels (B, 2) and geocell centroids (C, 2), both
// (lon, lat) in degrees, f32:
//
//   d[b, c]   = 2 R asin(sqrt(clamp(sin^2(dlat/2)
//                                   + cos(lat_b) cos(lat_c) sin^2(dlon/2))))
//   out[b, c] = exp(-(d[b, c] - min_c d[b, c]) / tau)
//
// with R the WGS84 equatorial radius in km, the arithmetic of
// `pigeon_tpu_torch.core.geodesy.haversine` and
// `pigeon_tpu_torch.core.scoring.smooth_labels`. asinf replaces the A&S
// arcsin polynomial the TPU kernel needs (Mosaic lowers no asin).
//
// What bounds it on the H100: a training batch is B = 8 panoramas
// against C = 2203 cells, ~18k distances (~0.1 M transcendentals) and a
// 70 KB write; even the (256, 2203) check shape is 0.6 M trig calls and
// a 2.2 MB write, microseconds of work. Launch time bounds it. The design
// is one launch with nothing in between: one block per label row, its
// threads striding over the cells (coalesced 8-byte loads of the centroid
// table). Each thread writes its distances to the output row, the block
// reduces the row minimum in shared memory, and each thread rewrites its
// own entries as targets, so no (B, C) intermediate exists but the
// output itself. Every cell is real: no padding and no sentinel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr float EARTH_RADIUS_KM = 6378.137f;
constexpr float DEG2RAD = 0.017453292519943295f;

__global__ void __launch_bounds__(THREADS)
smooth_labels_kernel(const float2* __restrict__ labels,
                     const float2* __restrict__ cells,
                     float* __restrict__ out, int num_cells, float tau_km) {
  __shared__ float warp_min[THREADS / 32];
  const float2 label = labels[blockIdx.x];
  const float lon1 = label.x * DEG2RAD;
  const float lat1 = label.y * DEG2RAD;
  const float cos_lat1 = cosf(lat1);
  float* row = out + (size_t)blockIdx.x * num_cells;

  float dmin = INFINITY;
  for (int c = threadIdx.x; c < num_cells; c += THREADS) {
    const float2 cell = cells[c];
    const float lon2 = cell.x * DEG2RAD;
    const float lat2 = cell.y * DEG2RAD;
    const float s_lat = sinf((lat2 - lat1) / 2.0f);
    const float s_lon = sinf((lon2 - lon1) / 2.0f);
    float a = s_lat * s_lat + cos_lat1 * cosf(lat2) * (s_lon * s_lon);
    a = fminf(fmaxf(a, 0.0f), 1.0f);
    const float d = (EARTH_RADIUS_KM * 2.0f) * asinf(sqrtf(a));
    row[c] = d;
    dmin = fminf(dmin, d);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
  }
  if (threadIdx.x % 32 == 0) warp_min[threadIdx.x / 32] = dmin;
  __syncthreads();
  dmin = warp_min[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) dmin = fminf(dmin, warp_min[w]);

  // Each thread rereads only the entries it wrote itself.
  for (int c = threadIdx.x; c < num_cells; c += THREADS) {
    row[c] = expf(-(row[c] - dmin) / tau_km);
  }
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// labels (B, 2), cells (C, 2), out (B, C): f32, contiguous, 8-byte
// aligned. Launches on `stream`; returns the launch's cudaError_t.
int pigeon_smooth_labels(const void* labels, const void* cells, void* out,
                         int batch, int num_cells, float tau_km,
                         void* stream) {
  if (batch < 1 || num_cells < 1 || !(tau_km > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  smooth_labels_kernel<<<batch, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(labels), static_cast<const float2*>(cells),
      static_cast<float*>(out), num_cells, tau_km);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
