"""OPTICS with xi cluster extraction, on numpy and the port's C++ graph.

Counterpart of `pigeon_tpu/geocell/optics.py`, which computes the
reachability graph in C++ and extracts the clusters with scikit-learn's
`cluster_optics_xi` (sklearn's `OPTICS` end to end where no compiler is
found). The port needs no scikit-learn: it keeps its own copy of both
halves.

* The graph: `optics_graph` runs `csrc/geokernels.cpp` (`geokernels.
  optics_graph`) where it builds, else `optics_graph_np`, a plain numpy
  version of sklearn's `compute_optics_graph` at ``max_eps = inf``:
  the k-th smallest distance as the core distance, then the ordering
  loop (the unprocessed point of least reachability, the lowest index on
  ties), each distance ``sqrt(dx*dx + dy*dy)`` or a row of the
  precomputed matrix, core and reachability distances rounded by
  ``np.around(., 15)``. Both give the same arrays, bit for bit.
* The extraction: `cluster_optics_xi` is sklearn's xi-steep method
  (`sklearn/cluster/_optics.py`: `_xi_cluster`, its steep areas and
  maximum-in-between filter, the predecessor correction of Schubert and
  Gertz, `_extract_xi_labels`) rewritten on numpy, with sklearn's own
  corrections of the OPTICS paper's definitions 9 and 11. Its labels
  equal sklearn's exactly.
"""

from __future__ import annotations

import functools
import logging
from typing import List, Optional, Tuple

import numpy as np

from pigeon_tpu_torch.geocell import geokernels

logger = logging.getLogger("pigeon_tpu_torch.optics")

#: Rows of the distance matrix `optics_graph_np` holds at once while it
#: finds the core distances.
CORE_ROWS = 1024


def _round15(x: np.ndarray) -> np.ndarray:
    """sklearn's rounding of core and reachability distances
    (``np.finfo(float64).precision`` decimals)."""
    return np.around(x, decimals=15)


def _distances(x: np.ndarray, rows, cols: np.ndarray,
               precomputed: bool) -> np.ndarray:
    """Distances from the points ``rows`` to the points ``cols``:
    ``(len(rows), len(cols))``, the matrix's entries or euclidean, each
    ``sqrt(dx*dx + dy*dy)`` rounded as the C++ graph rounds it."""
    if precomputed:
        return x[rows][:, cols]
    d = x[rows][:, None, :] - x[cols][None, :, :]
    return np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def optics_graph_np(points: np.ndarray, min_samples: int,
                    precomputed: bool = False):
    """``(ordering, core_distances, reachability, predecessor)`` of
    sklearn's ``compute_optics_graph(max_eps=inf)`` for ``(n, 2)``
    euclidean coordinates, or an ``(n, n)`` distance matrix under
    ``precomputed``; the plain version of `geokernels.optics_graph`."""
    x = np.ascontiguousarray(points, np.float64)
    n = len(x)
    k = min(max(int(min_samples), 1), n)
    everyone = np.arange(n)
    core = np.empty(n, np.float64)
    for lo in range(0, n, CORE_ROWS):
        rows = np.arange(lo, min(lo + CORE_ROWS, n))
        d = _distances(x, rows, everyone, precomputed)
        core[rows] = np.partition(d, k - 1, axis=1)[:, k - 1]
    core = _round15(core)

    reach = np.full(n, np.inf)
    pred = np.full(n, -1, np.int64)
    processed = np.zeros(n, bool)
    ordering = np.empty(n, np.int64)
    for step in range(n):
        index = np.flatnonzero(~processed)
        point = index[np.argmin(reach[index])]
        processed[point] = True
        ordering[step] = point
        if np.isinf(core[point]):
            continue
        unproc = index[index != point]
        if not unproc.size:
            continue
        d = _distances(x, [point], unproc, precomputed)[0]
        rd = _round15(np.maximum(d, core[point]))
        better = rd < reach[unproc]
        reach[unproc[better]] = rd[better]
        pred[unproc[better]] = point
    return ordering, core, reach, pred


@functools.lru_cache(maxsize=None)
def _log_numpy_graph() -> None:
    logger.warning("OPTICS graph in numpy: the C++ geo kernels did not "
                   "build here")


def optics_graph(points: np.ndarray, min_samples: int,
                 precomputed: bool = False):
    """The reachability graph: the C++ kernel where it builds, else
    `optics_graph_np` (the same arrays)."""
    if geokernels.available():
        return geokernels.optics_graph(points, min_samples, precomputed)
    _log_numpy_graph()
    return optics_graph_np(points, min_samples, precomputed)


# ---------------------------------------------------------------------------
# xi extraction (sklearn's `cluster_optics_xi`)
# ---------------------------------------------------------------------------

def _extend_region(steep: np.ndarray, xward: np.ndarray, start: int,
                   min_samples: int) -> int:
    """The last index of the maximal steep region from ``start``: steep
    points extend it, at most ``min_samples`` consecutive non-steep points
    that do not turn ``xward`` continue it, a point that turns ends it."""
    n = len(steep)
    non_xward = 0
    end = start
    for index in range(start, n):
        if steep[index]:
            non_xward = 0
            end = index
        elif not xward[index]:
            non_xward += 1
            if non_xward > min_samples:
                break
        else:
            break
    return end


def _update_filter_sdas(sdas: List[dict], mib: float, xi_complement: float,
                        plot: np.ndarray) -> List[dict]:
    """Drop the steep-down areas the maximum in between ``mib`` rules
    out, and raise the survivors' own maxima to it."""
    if np.isinf(mib):
        return []
    kept = [sda for sda in sdas
            if mib <= plot[sda["start"]] * xi_complement]
    for sda in kept:
        sda["mib"] = max(sda["mib"], mib)
    return kept


def _correct_predecessor(plot: np.ndarray, pred_plot: np.ndarray,
                         ordering: np.ndarray, s: int, e: int
                         ) -> Tuple[Optional[int], Optional[int]]:
    """Shrink the cluster ``[s, e]`` from the right until its last
    point's predecessor lies inside it (Algorithm 2 of Schubert and
    Gertz, LWDA 2018); ``(None, None)`` where nothing is left."""
    while s < e:
        if plot[s] > plot[e]:
            return s, e
        if pred_plot[e] in ordering[s:e]:
            return s, e
        e -= 1
    return None, None


def _xi_cluster(plot: np.ndarray, pred_plot: np.ndarray,
                ordering: np.ndarray, xi: float, min_samples: int,
                min_cluster_size: int, predecessor_correction: bool
                ) -> np.ndarray:
    """The clusters ``(start, end)`` (inclusive, in the ordering) of the
    reachability ``plot``, smaller nested ones before the ones holding
    them."""
    # An inf at the end closes a cluster that runs to the last point.
    plot = np.hstack((plot, np.inf))
    xi_complement = 1 - xi
    sdas: List[dict] = []
    clusters = []
    index = 0
    mib = 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = plot[:-1] / plot[1:]
        steep_upward = ratio <= xi_complement
        steep_downward = ratio >= 1 / xi_complement
        downward = ratio > 1
        upward = ratio < 1
    for steep_index in np.flatnonzero(steep_upward | steep_downward):
        if steep_index < index:
            continue
        mib = max(mib, np.max(plot[index:steep_index + 1]))
        sdas = _update_filter_sdas(sdas, mib, xi_complement, plot)
        if steep_downward[steep_index]:
            d_start = steep_index
            d_end = _extend_region(steep_downward, upward, d_start,
                                   min_samples)
            sdas.append({"start": d_start, "end": d_end, "mib": 0.0})
            index = d_end + 1
            mib = plot[index]
            continue
        u_start = steep_index
        u_end = _extend_region(steep_upward, downward, u_start, min_samples)
        index = u_end + 1
        mib = plot[index]
        found = []
        for sda in sdas:
            c_start, c_end = sda["start"], u_end
            if plot[c_end + 1] * xi_complement < sda["mib"]:
                continue
            d_max = plot[sda["start"]]
            if d_max * xi_complement >= plot[c_end + 1]:
                while (plot[c_start + 1] > plot[c_end + 1]
                       and c_start < sda["end"]):
                    c_start += 1
            elif plot[c_end + 1] * xi_complement >= d_max:
                while plot[c_end - 1] > d_max and c_end > u_start:
                    c_end -= 1
            if predecessor_correction:
                c_start, c_end = _correct_predecessor(
                    plot, pred_plot, ordering, c_start, c_end)
            if c_start is None:
                continue
            if c_end - c_start + 1 < min_cluster_size:
                continue
            if c_start > sda["end"] or c_end < u_start:
                continue
            found.append((c_start, c_end))
        clusters.extend(reversed(found))
    return np.array(clusters)


def _extract_xi_labels(ordering: np.ndarray, clusters: np.ndarray
                       ) -> np.ndarray:
    """Labels by point: each cluster, smallest first, labels its span of
    the ordering unless a smaller one took any of it; -1 for noise."""
    labels = np.full(len(ordering), -1, dtype=int)
    label = 0
    for start, end in clusters:
        if not np.any(labels[start:end + 1] != -1):
            labels[start:end + 1] = label
            label += 1
    labels[ordering] = labels.copy()
    return labels


def cluster_optics_xi(*, reachability: np.ndarray, predecessor: np.ndarray,
                      ordering: np.ndarray, min_samples: int,
                      min_cluster_size: Optional[int] = None,
                      xi: float = 0.05, predecessor_correction: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``(labels, clusters)`` of sklearn's ``cluster_optics_xi`` for
    integer ``min_samples`` and ``min_cluster_size`` (default
    ``min_samples``), each at least 2 and at most the point count."""
    n = len(reachability)
    min_cluster_size = (min_samples if min_cluster_size is None
                        else min_cluster_size)
    for name, size in (("min_samples", min_samples),
                       ("min_cluster_size", min_cluster_size)):
        if not 2 <= size <= n:
            raise ValueError(f"{name}={size}: must lie in [2, {n}], the "
                             "number of samples")
    clusters = _xi_cluster(reachability[ordering], predecessor[ordering],
                           ordering, xi, min_samples, min_cluster_size,
                           predecessor_correction)
    return _extract_xi_labels(ordering, clusters), clusters


def optics_xi_labels(points: np.ndarray, min_samples: int, xi: float,
                     precomputed: bool = False) -> np.ndarray:
    """Cluster labels equal to sklearn's
    ``OPTICS(min_samples, xi[, metric='precomputed']).fit_predict(points)``.

    Args:
        points: (n, 2) euclidean coords, or (n, n) pairwise distances when
            ``precomputed``.
        min_samples: OPTICS core-neighborhood size (callers clamp to <= n).
        xi: steepness threshold for the xi cluster extraction.
    """
    ordering, _core, reach, pred = optics_graph(points, min_samples,
                                                precomputed)
    labels, _ = cluster_optics_xi(reachability=reach, predecessor=pred,
                                  ordering=ordering, min_samples=min_samples,
                                  xi=xi)
    return labels
