// Host-side geo kernels of pigeon_tpu_torch: the port's own copy of the
// JAX package's `native/geokernels.cpp`, loaded with ctypes by
// `pigeon_tpu_torch/geocell/geokernels.py`, which builds it with g++ at
// first use into the checkout's ignored `build/`.
//
// The offline geocell pipeline is dominated by two host computations:
//   * point-in-polygon tests (assigning millions of training points to
//     admin areas / geocells — reference uses geopandas' libgeos sindex,
//     `dataset_creation/geocell/geocell_creation.py:193`);
//   * dense pairwise haversine matrices (per-cell OPTICS clustering over
//     precomputed distances, `dataset_creation/prototype/prototype.py:135`).
//
// Both are embarrassingly parallel; this TU exposes them with a C ABI for
// ctypes. OpenMP parallel, SIMD-friendly inner loops. Built with
// -ffp-contract=off: the OPTICS graph must equal the plain numpy one
// (`geocell/optics.py::optics_graph_np`) bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// np.around(x, 15) for float64 (np.finfo(float64).precision == 15):
// multiply, round-half-even, divide — sklearn applies this to core and
// reachability distances (sklearn/cluster/_optics.py compute_optics_graph
// and _set_reach_dist), so we must too for bit parity.
inline double Round15(double x) { return std::rint(x * 1e15) / 1e15; }

// Distance from point p to point j. Coordinate mode (X != nullptr) is
// euclidean on (n,2) rows, matching scipy cdist minkowski p=2 / sklearn
// kd_tree rdist: fl(fl(dx*dx) + fl(dy*dy)) then sqrt. Built with
// -ffp-contract=off so no FMA contraction breaks the parity.
inline double PairDist(const double* X, const double* drow, int64_t p,
                       int64_t j) {
  if (drow != nullptr) return drow[j];
  const double dx = X[2 * p] - X[2 * j];
  const double dy = X[2 * p + 1] - X[2 * j + 1];
  return std::sqrt(dx * dx + dy * dy);
}

// k-th smallest value (1-based, k counts the self-distance) of the n
// distances from point i — a size-k max-heap over the row.
inline double KthSmallest(const double* X, const double* drow, int64_t i,
                          int64_t n, int64_t k, std::vector<double>& heap) {
  heap.clear();
  for (int64_t j = 0; j < n; ++j) {
    double d;
    if (drow != nullptr) {
      d = drow[j];
    } else {
      const double dx = X[2 * i] - X[2 * j];
      const double dy = X[2 * i + 1] - X[2 * j + 1];
      d = dx * dx + dy * dy;  // monotonic in distance: select on d^2
    }
    if (static_cast<int64_t>(heap.size()) < k) {
      heap.push_back(d);
      std::push_heap(heap.begin(), heap.end());
    } else if (d < heap.front()) {
      std::pop_heap(heap.begin(), heap.end());
      heap.back() = d;
      std::push_heap(heap.begin(), heap.end());
    }
  }
  return drow != nullptr ? heap.front() : std::sqrt(heap.front());
}

// The OPTICS ordering loop (sklearn compute_optics_graph, max_eps=inf):
// repeatedly take the unprocessed point with the smallest reachability
// (lowest index on ties — np.argmin first-occurrence), then relax every
// remaining point's reachability to max(dist, core[point]).
void OpticsMainLoop(const double* X, const double* D, int64_t n,
                    const double* core, int64_t* ordering, double* reach,
                    int64_t* pred) {
  const double inf = std::numeric_limits<double>::infinity();
  std::vector<int64_t> unproc(n);
  for (int64_t i = 0; i < n; ++i) {
    unproc[i] = i;
    reach[i] = inf;
    pred[i] = -1;
  }
#ifdef _OPENMP
  const int max_threads = omp_get_max_threads();
#else
  const int max_threads = 1;
#endif
  std::vector<double> tval(max_threads);
  std::vector<int64_t> tpos(max_threads);

  int64_t m = n;
  int64_t sel_pos = 0;  // all-inf argmin -> first (lowest) unprocessed index
  for (int64_t step = 0; step < n; ++step) {
    const int64_t p = unproc[sel_pos];
    ordering[step] = p;
    std::memmove(unproc.data() + sel_pos, unproc.data() + sel_pos + 1,
                 static_cast<size_t>(m - sel_pos - 1) * sizeof(int64_t));
    --m;
    if (m == 0) break;

    const double cd = core[p];
    const bool relax = !std::isinf(cd);
    const double* drow = (D != nullptr) ? D + p * n : nullptr;

    // Fused relax + argmin-for-next-selection pass over the (index-
    // ordered) unprocessed list; each j is touched once, so comparing
    // post-update reach preserves the serial argmin semantics.
    double best_val = inf;
    int64_t best_pos = -1;
#ifdef _OPENMP
    if (m >= 8192) {
#pragma omp parallel
      {
        const int tid = omp_get_thread_num();
        const int nt = omp_get_num_threads();
        const int64_t lo = m * tid / nt;
        const int64_t hi = m * (tid + 1) / nt;
        double bv = inf;
        int64_t bp = -1;
        for (int64_t t = lo; t < hi; ++t) {
          const int64_t j = unproc[t];
          if (relax) {
            const double d = PairDist(X, drow, p, j);
            const double rd = Round15(d > cd ? d : cd);
            if (rd < reach[j]) {
              reach[j] = rd;
              pred[j] = p;
            }
          }
          if (bp < 0 || reach[j] < bv) {
            bv = reach[j];
            bp = t;
          }
        }
        tval[tid] = bv;
        tpos[tid] = bp;
#pragma omp barrier
#pragma omp single
        {
          for (int t = 0; t < nt; ++t) {
            if (tpos[t] < 0) continue;
            if (best_pos < 0 || tval[t] < best_val) {
              best_val = tval[t];
              best_pos = tpos[t];
            }
          }
        }
      }
    } else
#endif
    {
      for (int64_t t = 0; t < m; ++t) {
        const int64_t j = unproc[t];
        if (relax) {
          const double d = PairDist(X, drow, p, j);
          const double rd = Round15(d > cd ? d : cd);
          if (rd < reach[j]) {
            reach[j] = rd;
            pred[j] = p;
          }
        }
        if (best_pos < 0 || reach[j] < best_val) {
          best_val = reach[j];
          best_pos = t;
        }
      }
    }
    sel_pos = best_pos;
  }
}

void OpticsGraph(const double* X, const double* D, int64_t n,
                 int64_t min_samples, int64_t* ordering, double* core,
                 double* reach, int64_t* pred) {
  const int64_t k = std::min<int64_t>(std::max<int64_t>(min_samples, 1), n);
#pragma omp parallel
  {
    std::vector<double> heap;
    heap.reserve(static_cast<size_t>(k));
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const double* drow = (D != nullptr) ? D + i * n : nullptr;
      core[i] = Round15(KthSmallest(X, drow, i, n, k, heap));
    }
  }
  OpticsMainLoop(X, D, n, core, ordering, reach, pred);
}

}  // namespace

extern "C" {

// OPTICS reachability graph, sklearn parity (compute_optics_graph with
// max_eps=inf): euclidean on coords X (n,2). Outputs: ordering (n),
// core/reachability distances (n), predecessor (n). The O(n^2) core of
// geocell splitting (`dataset_creation/geocell/cell.py:336-418` clusters
// oversize cells with sklearn OPTICS; planet-scale runs are bound here).
void optics_graph_euclidean(const double* X, int64_t n, int64_t min_samples,
                            int64_t* ordering, double* core, double* reach,
                            int64_t* pred) {
  OpticsGraph(X, nullptr, n, min_samples, ordering, core, reach, pred);
}

// Same over a precomputed (n,n) distance matrix (the prototype builder's
// per-cell haversine matrices, `dataset_creation/prototype/prototype.py:135`).
void optics_graph_precomputed(const double* D, int64_t n, int64_t min_samples,
                              int64_t* ordering, double* core, double* reach,
                              int64_t* pred) {
  OpticsGraph(nullptr, D, n, min_samples, ordering, core, reach, pred);
}

// Even-odd ray casting: points (n,2) vs one ring (m,2) -> out[n] in {0,1}.
void pip_batch(const double* points, int64_t n,
               const double* ring, int64_t m, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double x = points[2 * i];
    const double y = points[2 * i + 1];
    int inside = 0;
    for (int64_t j = 0; j < m; ++j) {
      const int64_t k = (j + 1 == m) ? 0 : j + 1;
      const double x0 = ring[2 * j], y0 = ring[2 * j + 1];
      const double x1 = ring[2 * k], y1 = ring[2 * k + 1];
      if ((y0 <= y) != (y1 <= y)) {
        const double xs = x0 + (y - y0) * (x1 - x0) / (y1 - y0);
        if (xs > x) inside ^= 1;
      }
    }
    out[i] = static_cast<uint8_t>(inside);
  }
}

// Points vs a multipolygon given as concatenated rings.
// ring_offsets has num_rings+1 entries (prefix offsets into ring_data rows).
// out[i] = 1 if the point is inside ANY ring (outer-ring union semantics,
// matching geocell/geometry.py::points_in_multipolygon).
void pip_multi(const double* points, int64_t n,
               const double* ring_data, const int64_t* ring_offsets,
               int64_t num_rings, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double x = points[2 * i];
    const double y = points[2 * i + 1];
    int hit = 0;
    for (int64_t r = 0; r < num_rings && !hit; ++r) {
      const double* ring = ring_data + 2 * ring_offsets[r];
      const int64_t m = ring_offsets[r + 1] - ring_offsets[r];
      int inside = 0;
      for (int64_t j = 0; j < m; ++j) {
        const int64_t k = (j + 1 == m) ? 0 : j + 1;
        const double x0 = ring[2 * j], y0 = ring[2 * j + 1];
        const double x1 = ring[2 * k], y1 = ring[2 * k + 1];
        if ((y0 <= y) != (y1 <= y)) {
          const double xs = x0 + (y - y0) * (x1 - x0) / (y1 - y0);
          if (xs > x) inside ^= 1;
        }
      }
      hit = inside;
    }
    out[i] = static_cast<uint8_t>(hit);
  }
}

// Assign each point to the FIRST multipolygon containing it, else -1.
// feature_offsets (num_features+1) indexes into ring_offsets; bboxes is
// (num_features,4) [minx,miny,maxx,maxy] for prefiltering.
void assign_features(const double* points, int64_t n,
                     const double* ring_data, const int64_t* ring_offsets,
                     const int64_t* feature_offsets, int64_t num_features,
                     const double* bboxes, int64_t* out) {
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n; ++i) {
    const double x = points[2 * i];
    const double y = points[2 * i + 1];
    int64_t found = -1;
    for (int64_t f = 0; f < num_features && found < 0; ++f) {
      const double* bb = bboxes + 4 * f;
      if (x < bb[0] || y < bb[1] || x > bb[2] || y > bb[3]) continue;
      for (int64_t r = feature_offsets[f];
           r < feature_offsets[f + 1] && found < 0; ++r) {
        const double* ring = ring_data + 2 * ring_offsets[r];
        const int64_t m = ring_offsets[r + 1] - ring_offsets[r];
        int inside = 0;
        for (int64_t j = 0; j < m; ++j) {
          const int64_t k = (j + 1 == m) ? 0 : j + 1;
          const double x0 = ring[2 * j], y0 = ring[2 * j + 1];
          const double x1 = ring[2 * k], y1 = ring[2 * k + 1];
          if ((y0 <= y) != (y1 <= y)) {
            const double xs = x0 + (y - y0) * (x1 - x0) / (y1 - y0);
            if (xs > x) inside ^= 1;
          }
        }
        if (inside) found = f;
      }
    }
    out[i] = found;
  }
}

// ---------------------------------------------------------------------
// Batched multipolygon adjacency (the fuse phase's hot predicate,
// reference `cell_collection.py:205-237`): does the subject multipolygon
// intersect each candidate multipolygon? Semantics identical to
// geocell/geometry.py::rings_intersect: bbox reject, then
// first-vertex containment either way (even-odd ray cast), then proper
// segment crossing with the same parametric test and 1e-18 denominator
// guard.

static bool point_in_ring_c(double x, double y, const double* ring,
                            int64_t m) {
  int inside = 0;
  for (int64_t j = 0; j < m; ++j) {
    const int64_t k = (j + 1 == m) ? 0 : j + 1;
    const double x0 = ring[2 * j], y0 = ring[2 * j + 1];
    const double x1 = ring[2 * k], y1 = ring[2 * k + 1];
    if ((y0 <= y) != (y1 <= y)) {
      const double xs = x0 + (y - y0) * (x1 - x0) / (y1 - y0);
      if (xs > x) inside ^= 1;
    }
  }
  return inside != 0;
}

static void ring_bbox(const double* ring, int64_t m, double* bb) {
  bb[0] = bb[2] = ring[0];
  bb[1] = bb[3] = ring[1];
  for (int64_t j = 1; j < m; ++j) {
    const double x = ring[2 * j], y = ring[2 * j + 1];
    if (x < bb[0]) bb[0] = x;
    if (y < bb[1]) bb[1] = y;
    if (x > bb[2]) bb[2] = x;
    if (y > bb[3]) bb[3] = y;
  }
}

static bool rings_intersect_c(const double* a, int64_t na, const double* ab,
                              const double* b, int64_t nb, const double* bb) {
  if (ab[2] < bb[0] || bb[2] < ab[0] || ab[3] < bb[1] || bb[3] < ab[1])
    return false;
  if (point_in_ring_c(a[0], a[1], b, nb) ||
      point_in_ring_c(b[0], b[1], a, na))
    return true;
  for (int64_t i = 0; i < na; ++i) {
    const int64_t i2 = (i + 1 == na) ? 0 : i + 1;
    const double a0x = a[2 * i], a0y = a[2 * i + 1];
    const double d1x = a[2 * i2] - a0x, d1y = a[2 * i2 + 1] - a0y;
    for (int64_t j = 0; j < nb; ++j) {
      const int64_t j2 = (j + 1 == nb) ? 0 : j + 1;
      const double b0x = b[2 * j], b0y = b[2 * j + 1];
      const double d2x = b[2 * j2] - b0x, d2y = b[2 * j2 + 1] - b0y;
      const double denom = d1x * d2y - d1y * d2x;
      if (!(std::fabs(denom) > 1e-18)) continue;
      const double dx = b0x - a0x, dy = b0y - a0y;
      const double t = (dx * d2y - dy * d2x) / denom;
      const double u = (dx * d1y - dy * d1x) / denom;
      if (t >= 0.0 && t <= 1.0 && u >= 0.0 && u <= 1.0) return true;
    }
  }
  return false;
}

// subject rings: subj_data rows indexed by subj_offsets (n_subj+1).
// candidate rings: cand_data rows indexed by cand_ring_offsets
// (total_cand_rings+1); cand_feat_offsets (n_cands+1) maps candidate ->
// ring range. out[c] = 1 iff any subject ring intersects any of
// candidate c's rings.
void multipoly_intersect_batch(const double* subj_data,
                               const int64_t* subj_offsets, int64_t n_subj,
                               const double* cand_data,
                               const int64_t* cand_ring_offsets,
                               const int64_t* cand_feat_offsets,
                               int64_t n_cands, uint8_t* out) {
  std::vector<double> subj_bb(static_cast<size_t>(n_subj) * 4);
  for (int64_t s = 0; s < n_subj; ++s) {
    ring_bbox(subj_data + 2 * subj_offsets[s],
              subj_offsets[s + 1] - subj_offsets[s], subj_bb.data() + 4 * s);
  }
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t c = 0; c < n_cands; ++c) {
    int hit = 0;
    for (int64_t r = cand_feat_offsets[c];
         r < cand_feat_offsets[c + 1] && !hit; ++r) {
      const double* b = cand_data + 2 * cand_ring_offsets[r];
      const int64_t nb = cand_ring_offsets[r + 1] - cand_ring_offsets[r];
      double bb[4];
      ring_bbox(b, nb, bb);
      for (int64_t s = 0; s < n_subj && !hit; ++s) {
        const double* a = subj_data + 2 * subj_offsets[s];
        const int64_t na = subj_offsets[s + 1] - subj_offsets[s];
        hit = rings_intersect_c(a, na, subj_bb.data() + 4 * s, b, nb, bb);
      }
    }
    out[c] = static_cast<uint8_t>(hit);
  }
}

// Dense pairwise haversine: x (n,2), y (m,2) in (lon,lat) degrees ->
// out (n*m) km. WGS84 equatorial radius (parity with core/geodesy.py).
void haversine_matrix(const double* x, int64_t n,
                      const double* y, int64_t m, double* out) {
  constexpr double kDeg2Rad = 0.017453292519943295;
  constexpr double kRadiusKm = 6378.137;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double lon1 = x[2 * i] * kDeg2Rad;
    const double lat1 = x[2 * i + 1] * kDeg2Rad;
    const double clat1 = std::cos(lat1);
    for (int64_t j = 0; j < m; ++j) {
      const double lon2 = y[2 * j] * kDeg2Rad;
      const double lat2 = y[2 * j + 1] * kDeg2Rad;
      const double sdlat = std::sin(0.5 * (lat2 - lat1));
      const double sdlon = std::sin(0.5 * (lon2 - lon1));
      double a = sdlat * sdlat + clat1 * std::cos(lat2) * sdlon * sdlon;
      a = a < 0.0 ? 0.0 : (a > 1.0 ? 1.0 : a);
      out[i * m + j] = 2.0 * kRadiusKm * std::asin(std::sqrt(a));
    }
  }
}

}  // extern "C"
