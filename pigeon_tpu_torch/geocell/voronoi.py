"""Finite Voronoi tessellation.

Counterpart of `pigeon_tpu/geocell/voronoi.py`, the same arithmetic.

`scipy.spatial.Voronoi` leaves boundary regions infinite; geocell splitting
needs closed polygons to carve cluster territories
(reference `dataset_creation/geocell/voronoi.py:5-85`, itself a public-gist
adaptation that reconstructs infinite regions by extending ridges). That
reconstruction heuristic provably loses area when sites are
near-coincident (circumcenters fly far from the cloud and the angular
re-sort mis-orders the ring), so this module instead builds each cell
EXACTLY as an intersection of half-planes:

    cell(i) = box  ∩  { x : (x - m_ij) · (p_j - p_i) <= 0  for all j != i }

with m_ij the bisector midpoint. This tiles the plane for ANY set of
distinct sites — including near-coincident ones — because every boundary
is a true bisector, not an extended ridge. The arithmetic is
sign-symmetric between the two sides of each bisector, so shared edge
vertices come out bit-identical and downstream edge-cancellation dissolve
(`geometry.dissolve`) still fuses them exactly.

O(N^2 * ring-length) — geocell splits carve at most a few dozen cluster
centroids at a time, so this is never hot.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _clip_halfplane(ring: np.ndarray, mid: np.ndarray,
                    d: np.ndarray) -> np.ndarray:
    """Keep the part of `ring` with (x - mid) . d <= 0.

    Sutherland-Hodgman against a single line. The signed values `s`
    negate EXACTLY when (mid, d) -> (mid, -d), so the two cells sharing a
    bisector compute bit-identical intersection vertices.
    """
    if len(ring) == 0:
        return ring
    s = (ring[:, 0] - mid[0]) * d[0] + (ring[:, 1] - mid[1]) * d[1]
    inside = s <= 0.0
    if inside.all():
        return ring
    if not inside.any():
        return np.empty((0, 2), np.float64)
    out = []
    n = len(ring)
    for j in range(n):
        k = (j + 1) % n
        if inside[j]:
            out.append(ring[j])
        if inside[j] != inside[k]:
            t = s[j] / (s[j] - s[k])
            out.append(ring[j] + t * (ring[k] - ring[j]))
    return np.asarray(out, np.float64).reshape(-1, 2)


def _cells_from_sites(sites: np.ndarray, radius: float = None
                      ) -> List[np.ndarray]:
    """Exact Voronoi cells of distinct `sites`, clipped to a large box."""
    sites = np.asarray(sites, np.float64)
    center = sites.mean(axis=0)
    span = float(np.ptp(sites, axis=0).max()) if len(sites) > 1 else 0.0
    if radius is None:
        # Big enough to dwarf any parent polygon the caller clips against
        # (geographic coords are bounded by ~360), small enough that
        # double precision at box scale stays far below area tolerances.
        radius = (span + 1.0) * 1e3
    box = center + radius * np.array(
        [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    cells = []
    for i, p in enumerate(sites):
        ring = box
        # Exact early termination: clip bisectors nearest-site-first and
        # keep the cell's max vertex distance R from p. Once
        # d(p, q)/2 > R, q's bisector cannot intersect the cell — and
        # neither can any farther site's — so the remaining sites are
        # skipped. Naive all-pairs is O(N^2) and took 26 s at N=1000;
        # this is near-linear for practical site sets while keeping the
        # all-bisector exactness (no reliance on a Delaunay adjacency
        # that degrades at near-coincident sites).
        d = np.hypot(sites[:, 0] - p[0], sites[:, 1] - p[1])
        order = np.argsort(d, kind="stable")
        rr = ring - p
        r_max = float(np.max(np.hypot(rr[:, 0], rr[:, 1])))
        for j in order:
            if j == i:
                continue
            if d[j] * 0.5 > r_max:
                break
            if len(ring) == 0:
                break
            q = sites[j]
            new_ring = _clip_halfplane(ring, (p + q) / 2.0, q - p)
            if new_ring is not ring:
                ring = new_ring
                if len(ring):
                    rr = ring - p
                    r_max = float(np.max(np.hypot(rr[:, 0], rr[:, 1])))
        cells.append(ring)
    return cells


def voronoi_finite_polygons(vor, radius: float = None
                            ) -> Tuple[List[List[int]], np.ndarray]:
    """Closed (finite) regions for a scipy ``Voronoi`` object.

    Compatibility wrapper over the half-plane construction: takes a
    ``scipy.spatial.Voronoi`` (for its ``points``) and returns
    ``(regions, vertices)`` — per-input-point lists of vertex indices into
    ``vertices``, every region a closed convex ring.
    """
    if vor.points.shape[1] != 2:
        raise ValueError("2-D input required")
    cells = _cells_from_sites(vor.points, radius)
    vertices: List[np.ndarray] = []
    regions: List[List[int]] = []
    for ring in cells:
        idx = []
        for v in ring:
            idx.append(len(vertices))
            vertices.append(v)
        regions.append(idx)
    return regions, (np.asarray(vertices, np.float64).reshape(-1, 2))


def voronoi_regions_for_points(coords: np.ndarray,
                               radius: float = None) -> List[np.ndarray]:
    """Convenience: coords ``(N>=2, 2)`` -> list of N closed convex rings,
    ordered like the input points (duplicates share a ring). Together the
    rings tile the bounding box exactly — no area is lost even for
    near-coincident sites (reference `cell.py:233-273` relies on the
    territories covering the parent cell)."""
    coords = np.asarray(coords, np.float64)
    uniq, inverse = np.unique(coords, axis=0, return_inverse=True)
    if len(uniq) < 2:
        raise ValueError("need >= 2 distinct points for Voronoi")
    rings = _cells_from_sites(uniq, radius)
    return [rings[i] for i in inverse]
