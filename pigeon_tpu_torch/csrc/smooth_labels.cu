// Haversine distance matrix + label smoothing, for Hopper (sm_90a).
//
// Replaces pigeon_tpu/kernels/geodesy.py:53 `_smooth_kernel` (launcher
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
// `pigeon_tpu_torch.core.scoring.smooth_labels` as PyTorch runs them on
// the card: each product and sum rounded on its own (`__fmul_rn`,
// `__fadd_rn`: never contracted into an FMA), the division by tau a
// product with its reciprocal (PyTorch's CUDA division by a scalar), so
// the output is the plain version's bit for bit on the H100, d does not
// depend on the compiler's choices, and a d computed twice is the same
// bits. asinf replaces the A&S arcsin polynomial the TPU kernel needs
// (Mosaic lowers no asin).
//
// What bounds it on the H100: neither bytes nor operations. The main
// path's shape, B = 8 labels x C = 2203 cells, is ~18k distances (~0.44 M
// f32 operations, 7e-6 ms at 67 TFLOP/s) and a 70 KB write (2.6e-5 ms at
// 3.35 TB/s); the check shape (256, 2203) 0.56 M distances and a 2.3 MB
// write (6.8e-4 ms). The first design, one block a row (8 blocks on 132
// SMs at B = 8, each thread ~9 haversines and ~9 exps in a row, d written
// to the output and read back), took 0.0063-0.0064 device ms at (8, 2203)
// and 0.0073-0.0074 at (256, 2203) (H100 80GB HBM3, 700 W,
// `chip_smoke.check_smoothing_kernel`): at B = 8 the latency of one
// thread's chain of dependent transcendentals bounds it, at B = 256 the
// instructions its pairs execute. Its wrapper took 0.037-0.061 ms a call:
// the host bounds the call at both shapes. This design takes 0.0026 and
// 0.0066 device ms there; its wrapper stays host-bound.
//
// The design: one launch of clusters of CLUSTER = 8 CTAs. A cluster covers a
// tile of ROWS label rows; each of its CTAs a slice of ceil(C / 8) cells, one
// cell a thread a chunk (cell = chunk start + thread, so loads and stores are
// coalesced). `kernels/geodesy.py::launch_plan` picks ROWS and the block size:
// a thread's rows run one after another, so the fewest rows a cluster whose
// grid the card holds at once (B = 8: 64 CTAs of one row; B = 256: 512 CTAs
// of 4 rows). A thread loads its cell while the tile's rows are staged in
// shared memory, keeps the cell's radians and cos(lat) in registers for all
// ROWS rows (computed once a CTA, not once a row; a thread reuses only its own
// cell, so shared memory would add a store and a load), and keeps every d in
// registers from the haversine to the exp. The row minimum is reduced by warp
// shuffles, then across the CTA's warps in shared memory, then across the
// cluster through distributed shared memory: each CTA publishes its ROWS
// partial minima, the cluster barrier, each CTA reads the 8 partials of its
// rows from its peers, and arrives on a second cluster barrier that it waits on
// only before it exits, so no CTA's shared memory is released while a peer
// still reads it (that arrive is relaxed: a release would add a GPU-scope
// MEMBAR that nothing needs). Each output element is stored once and never
// read; no atomics. A slice longer than one chunk (C > 4096: 512 threads)
// runs its chunks twice, once for the minimum and once for the exp; d of all
// but the last chunk is then computed again, the same bits by the rounding
// above. Rows past B in the last tile compute the last row again and store
// nothing; a slice past C contributes +inf to the minimum and stores nothing.
// Any plan the launcher accepts gives the same bits; the plan sets only the
// speed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int MAX_THREADS = 512;
constexpr float EARTH_RADIUS_KM = 6378.137f;
constexpr float DEG2RAD = 0.017453292519943295f;

struct Point {
  float lon, lat, cos_lat;  // radians, and cos of the latitude
};

__device__ __forceinline__ Point to_point(float2 deg) {
  const float lat = __fmul_rn(deg.y, DEG2RAD);
  return {__fmul_rn(deg.x, DEG2RAD), lat, cosf(lat)};
}

__device__ __forceinline__ float haversine_km(const Point& p, const Point& q) {
  const float s_lat = sinf(__fmul_rn(__fsub_rn(q.lat, p.lat), 0.5f));
  const float s_lon = sinf(__fmul_rn(__fsub_rn(q.lon, p.lon), 0.5f));
  float a = __fadd_rn(__fmul_rn(s_lat, s_lat),
                      __fmul_rn(__fmul_rn(p.cos_lat, q.cos_lat),
                                __fmul_rn(s_lon, s_lon)));
  a = fminf(fmaxf(a, 0.0f), 1.0f);
  return __fmul_rn(EARTH_RADIUS_KM * 2.0f, asinf(sqrtf(a)));
}

// d of this thread's cell for each of the tile's ROWS rows; +inf past the
// slice's end.
template <int ROWS>
__device__ __forceinline__ void cell_distances(const Point (&rows)[ROWS],
                                               float2 raw, bool in_slice,
                                               float (&d)[ROWS]) {
  const Point q = to_point(raw);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    d[r] = in_slice ? haversine_km(rows[r], q) : INFINITY;
  }
}

// out = exp(-(d - dmin) * (1 / tau)): PyTorch's CUDA division by a scalar
// multiplies by its reciprocal, so the plain version on the card does too.
template <int ROWS>
__device__ __forceinline__ void store_cell(const float (&d)[ROWS],
                                           const float (&dmin)[ROWS],
                                           float* __restrict__ out, int row0,
                                           int batch, int num_cells, int c,
                                           float inv_tau) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row0 + r < batch) {
      out[(size_t)(row0 + r) * num_cells + c] =
          expf(__fmul_rn(-__fsub_rn(d[r], dmin[r]), inv_tau));
    }
  }
}

// Release: this CTA's shared-memory writes are seen by its peers after
// their wait (on sm_90a a GPU-scope MEMBAR).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// Relaxed: says only that this CTA's reads of its peers are done (their
// values are in registers), which needs no fence.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Grid: CLUSTER x row tiles CTAs in x, clusters of CLUSTER along x; CTA
// rank q of a cluster takes cells [q * slice, (q + 1) * slice) of C.
template <int ROWS>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(MAX_THREADS)
smooth_labels_kernel(const float2* __restrict__ labels,
                     const float2* __restrict__ cells,
                     float* __restrict__ out, int batch, int num_cells,
                     float inv_tau) {
  __shared__ Point row_points[ROWS];
  __shared__ float warp_min[ROWS][MAX_THREADS / 32];
  __shared__ float cta_min[ROWS];  // this CTA's partials, read by its peers
  __shared__ float row_min[ROWS];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / CLUSTER) * ROWS;
  const int slice = (num_cells + CLUSTER - 1) / CLUSTER;
  const int begin = min(rank * slice, num_cells);
  const int end = min(begin + slice, num_cells);
  const int chunk = blockDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The first chunk's cell is in flight while the rows are staged.
  int c = begin + threadIdx.x;
  float2 raw = c < end ? cells[c] : make_float2(0.0f, 0.0f);
  if (threadIdx.x < ROWS) {
    const int row = min(row0 + static_cast<int>(threadIdx.x), batch - 1);
    row_points[threadIdx.x] = to_point(labels[row]);
  }
  __syncthreads();
  Point rows[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) rows[r] = row_points[r];

  // The minimum over the slice; d of its last chunk stays in registers.
  float d[ROWS];
  float dmin[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) dmin[r] = INFINITY;
  int last = begin;
  for (int base = begin; base < end; base += chunk) {
    c = base + threadIdx.x;
    if (base != begin) raw = c < end ? cells[c] : make_float2(0.0f, 0.0f);
    last = base;
    cell_distances(rows, raw, c < end, d);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dmin[r] = fminf(dmin[r], d[r]);
  }

  // Warps, then the CTA's warps in shared memory.
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      dmin[r] = fminf(dmin[r], __shfl_xor_sync(0xffffffffu, dmin[r], off));
    }
    if (lane == 0) warp_min[r][warp] = dmin[r];
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    float m = INFINITY;
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) {
      m = fminf(m, warp_min[threadIdx.x][w]);
    }
    cta_min[threadIdx.x] = m;
  }

  // The cluster: thread r * CLUSTER + q reads row r's partial of CTA q,
  // and lanes reduce over groups of CLUSTER (blockDim >= ROWS * CLUSTER).
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x < ((ROWS * CLUSTER + 31) / 32) * 32) {
    float m = INFINITY;
    if (threadIdx.x < ROWS * CLUSTER) {
      m = *cluster.map_shared_rank(&cta_min[threadIdx.x / CLUSTER],
                                   threadIdx.x % CLUSTER);
    }
#pragma unroll
    for (int off = CLUSTER / 2; off > 0; off /= 2) {
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (threadIdx.x < ROWS * CLUSTER && threadIdx.x % CLUSTER == 0) {
      row_min[threadIdx.x / CLUSTER] = m;
    }
  }
  // This CTA's reads of its peers are done; it waits for theirs of its
  // partials only before it exits.
  cluster_arrive_relaxed();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) dmin[r] = row_min[r];

  // The last chunk from registers, then the earlier ones computed again
  // (they are whole: each ends before the last chunk starts).
  c = last + threadIdx.x;
  if (c < end) store_cell(d, dmin, out, row0, batch, num_cells, c, inv_tau);
  for (int base = begin; base < last; base += chunk) {
    c = base + threadIdx.x;
    cell_distances(rows, cells[c], true, d);
    store_cell(d, dmin, out, row0, batch, num_cells, c, inv_tau);
  }
  cluster_wait();
}

template <int ROWS>
cudaError_t launch(const float2* labels, const float2* cells, float* out,
                   int batch, int num_cells, float tau_km, int threads,
                   cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((batch + ROWS - 1) / ROWS);
  smooth_labels_kernel<ROWS><<<tiles * CLUSTER, threads, 0, stream>>>(
      labels, cells, out, batch, num_cells, 1.0f / tau_km);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pigeon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// labels (B, 2), cells (C, 2), out (B, C): f32, contiguous, 8-byte
// aligned. The plan (`kernels/geodesy.py::launch_plan`): `rows` labels a
// cluster (1, 2, 4 or 8) and `threads` a CTA (a multiple of 32 from 64 to
// 512). Any such plan gives the same output; it only sets the speed.
// Launches on `stream`; returns the launch's cudaError_t.
int pigeon_smooth_labels(const void* labels, const void* cells, void* out,
                         int batch, int num_cells, float tau_km, int rows,
                         int threads, void* stream) {
  if (batch < 1 || num_cells < 1 || !(tau_km > 0.0f) || rows < 1 ||
      threads < 64 || threads > MAX_THREADS || threads % 32 ||
      (batch + rows - 1) / rows > 0x7fffffff / CLUSTER) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* l = static_cast<const float2*>(labels);
  const auto* c = static_cast<const float2*>(cells);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows) {
    case 1:
      err = launch<1>(l, c, o, batch, num_cells, tau_km, threads, s);
      break;
    case 2:
      err = launch<2>(l, c, o, batch, num_cells, tau_km, threads, s);
      break;
    case 4:
      err = launch<4>(l, c, o, batch, num_cells, tau_km, threads, s);
      break;
    case 8:
      err = launch<8>(l, c, o, batch, num_cells, tau_km, threads, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
