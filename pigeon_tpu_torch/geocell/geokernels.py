"""ctypes loader of the port's host geo kernels (`csrc/geokernels.cpp`).

Counterpart of `pigeon_tpu/native.py`: point-in-polygon, the batched
multipolygon adjacency test, dense haversine matrices and the OPTICS
reachability graph in C++ with OpenMP. The source is the port's own copy
of the JAX package's `native/geokernels.cpp`, built with the same flags
(`native/build.sh`) by ``g++`` at first use into the checkout's ignored
``build/`` directory, under a file lock (the split's process-pool
workers may all reach their first use together). This is host code, not
a device kernel.

Where the library cannot be built, `load` returns None once, with one
warning, and the callers (`geometry.points_in_multipolygon`,
`cells._adjacent_mask`, `optics.optics_graph`, `prototypes`) run their
plain numpy versions, which compute the same answers.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from pigeon_tpu_torch import native

logger = logging.getLogger("pigeon_tpu_torch.geokernels")

SRC_PATH = os.path.join(native.CSRC_DIR, "geokernels.cpp")
#: The flags the JAX package builds its copy with (`native/build.sh`);
#: ``-ffp-contract=off`` keeps ``dx*dx + dy*dy`` unfused, so the OPTICS
#: graph equals the numpy one bit for bit.
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-shared", "-fopenmp")


def _build() -> str:
    """The library's path, built at first use under a file lock."""
    import fcntl

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    with open(os.path.join(native.BUILD_DIR, "geokernels.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return native.build_shared(SRC_PATH, ["g++"], GXX_FLAGS).path


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """Build (at first use) and load the library; None where it cannot be
    built on this machine."""
    try:
        lib = ctypes.CDLL(_build())
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        logger.warning("geo kernels unavailable, running their numpy "
                       "versions: %s", str(e).splitlines()[0])
        return None
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    signatures = {
        "pip_batch": [f64p, i64, f64p, i64, u8p],
        "pip_multi": [f64p, i64, f64p, i64p, i64, u8p],
        "assign_features": [f64p, i64, f64p, i64p, i64p, i64, f64p, i64p],
        "haversine_matrix": [f64p, i64, f64p, i64, f64p],
        "optics_graph_euclidean": [f64p, i64, i64, i64p, f64p, f64p, i64p],
        "optics_graph_precomputed": [f64p, i64, i64, i64p, f64p, f64p,
                                     i64p],
        "multipoly_intersect_batch": [f64p, i64p, i64, f64p, i64p, i64p,
                                      i64, u8p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def available() -> bool:
    return load() is not None


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def _packed(rings: Sequence[np.ndarray]):
    """``(data (sum n_i, 2), offsets (len + 1,))`` of a list of rings."""
    offsets = np.zeros(len(rings) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r) for r in rings])
    data = (_f64(np.concatenate([np.asarray(r, np.float64) for r in rings]))
            if len(rings) else np.zeros((0, 2)))
    return data, offsets


def _features(rings_per_feature):
    """Rings of many features: ``(data, ring offsets, feature offsets)``."""
    flat = [r for rings in rings_per_feature for r in rings]
    data, ring_offsets = _packed(flat)
    feature_offsets = np.zeros(len(rings_per_feature) + 1, np.int64)
    feature_offsets[1:] = np.cumsum([len(r) for r in rings_per_feature])
    return data, ring_offsets, feature_offsets


# ---------------------------------------------------------------------------
# Wrappers (numpy in, numpy out), as `pigeon_tpu/native.py`'s
# ---------------------------------------------------------------------------

def pip_batch(points: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Even-odd ray casting of ``(N, 2)`` points against one ring."""
    pts, rg = _f64(points), _f64(ring)
    out = np.empty(len(pts), np.uint8)
    load().pip_batch(pts, len(pts), rg, len(rg), out)
    return out.astype(bool)


def pip_multi(points: np.ndarray, rings) -> np.ndarray:
    """Inside any of ``rings`` (`geometry.points_in_multipolygon`)."""
    pts = _f64(points)
    data, offsets = _packed(rings)
    out = np.empty(len(pts), np.uint8)
    load().pip_multi(pts, len(pts), data, offsets, len(rings), out)
    return out.astype(bool)


def assign_features(points: np.ndarray, rings_per_feature,
                    bboxes: np.ndarray) -> np.ndarray:
    """Point -> first containing feature index (-1 outside all)."""
    pts = _f64(points)
    data, ring_offsets, feature_offsets = _features(rings_per_feature)
    out = np.empty(len(pts), np.int64)
    load().assign_features(pts, len(pts), data, ring_offsets,
                           feature_offsets, len(rings_per_feature),
                           _f64(bboxes), out)
    return out


def haversine_matrix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``(N, 2)`` x ``(M, 2)`` (lon, lat) degrees -> ``(N, M)`` km."""
    xx, yy = _f64(x), _f64(y)
    out = np.empty((len(xx), len(yy)), np.float64)
    load().haversine_matrix(xx, len(xx), yy, len(yy), out)
    return out


def multipoly_intersect_batch(subject_rings, candidate_ring_lists
                              ) -> np.ndarray:
    """Whether the subject multipolygon intersects each candidate's
    rings: `geometry.polygons_intersect(subject_rings, candidate)` for
    every candidate, in one OpenMP pass."""
    subj_data, subj_offsets = _packed(subject_rings)
    data, ring_offsets, feature_offsets = _features(candidate_ring_lists)
    out = np.zeros(len(candidate_ring_lists), np.uint8)
    if len(subject_rings) and len(candidate_ring_lists):
        load().multipoly_intersect_batch(
            subj_data, subj_offsets, len(subject_rings), data, ring_offsets,
            feature_offsets, len(candidate_ring_lists), out)
    return out.astype(bool)


def optics_graph(points: np.ndarray, min_samples: int,
                 precomputed: bool = False):
    """The OPTICS reachability graph at ``max_eps = inf``:
    ``(ordering, core_distances, reachability, predecessor)`` of
    ``(n, 2)`` euclidean coordinates, or of an ``(n, n)`` distance matrix
    under ``precomputed`` (`optics.optics_graph_np` is its numpy
    version)."""
    x = _f64(points)
    n = len(x)
    ordering = np.empty(n, np.int64)
    core = np.empty(n, np.float64)
    reach = np.empty(n, np.float64)
    pred = np.empty(n, np.int64)
    lib = load()
    fn = (lib.optics_graph_precomputed if precomputed
          else lib.optics_graph_euclidean)
    fn(x, n, int(min_samples), ordering, core, reach, pred)
    return ordering, core, reach, pred
