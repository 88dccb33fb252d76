"""Dependency-free planar geometry for geocell work.

Counterpart of `pigeon_tpu/geocell/geometry.py`, with one deviation:
`clip_to_convex` skips a clip edge as rounding noise below 1e-12 of the
clip's extent OR of its largest coordinate's magnitude (the JAX
package scales with the extent alone, so a 1-ulp repeated vertex of a
small cell far from the origin passed as an edge and its noise
half-plane clipped real area away).

The reference leans on shapely/GEOS for polygon surgery
(`dataset_creation/geocell/cell.py`), neither of which exists in this
environment. This module provides the minimal algebra the geocell pipeline
actually needs, in vectorized numpy:

  * ring area / centroid (shoelace), bounding boxes;
  * batched point-in-polygon (even-odd ray casting);
  * polygon-polygon intersection TEST (segment crossing + containment) —
    used for adjacency during cell fusing (`cell_collection.py:195-230`);
  * convex clipping (Sutherland-Hodgman) — sufficient and exact for
    intersecting shapes with finite Voronoi regions, which are always
    convex (`cell.py:233-273`);
  * scale-about-centroid (the reference's 1.01x adjacency trick).

Polygons are ``(N, 2)`` float64 arrays of (lon, lat) ring vertices
(unclosed; closure is implicit). A MultiPolygon is a list of rings. Holes
are not modeled — for geocell purposes holes only matter for "doughnut"
splits, which are handled at the cell level by point set difference.

Coordinates are treated as PLANAR lon/lat — polygons spanning the +-180
antimeridian are not unwrapped. This matches the reference exactly
(shapely on raw EPSG:4326 coordinates has the same behavior); admin
boundary products ship antimeridian-split polygons, so it only affects
synthetic shapes that deliberately cross the dateline.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from pigeon_tpu_torch.geocell import geokernels
from pigeon_tpu_torch.geocell.boundaries import as_ring, points_in_polygon

Polygon = np.ndarray          # (N, 2) ring, implicit closure
MultiPolygon = List[np.ndarray]


def polygon_area(poly: Polygon) -> float:
    """Signed shoelace area (positive for counter-clockwise rings).

    Computed about the first vertex: the shoelace's cross products
    cancel catastrophically for sliver rings far from the origin
    (condition ~ |coord|^2 / area — hypothesis-found at 1500 examples:
    a near-degenerate triangle at (89, 34) broke area scaling at
    rel 1e-9). Translation changes nothing mathematically; error now
    scales with the ring's EXTENT, not its coordinate magnitude."""
    r = as_ring(poly)
    if len(r) == 0:
        return 0.0
    x, y = r[:, 0] - r[0, 0], r[:, 1] - r[0, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_centroid(poly: Polygon) -> np.ndarray:
    """Area centroid of a ring (vertex mean fallback for degenerate
    rings). Computed in first-vertex-local coordinates for the same
    conditioning reason as `polygon_area`."""
    r = as_ring(poly)
    if len(r) == 0:
        return np.array([np.nan, np.nan])
    x, y = r[:, 0] - r[0, 0], r[:, 1] - r[0, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        return r.mean(axis=0)
    cx = np.sum((x + xn) * cross) / (6.0 * a)
    cy = np.sum((y + yn) * cross) / (6.0 * a)
    return np.array([cx + r[0, 0], cy + r[0, 1]])


def bbox(poly: Polygon) -> np.ndarray:
    r = as_ring(poly)
    return np.array([r[:, 0].min(), r[:, 1].min(),
                     r[:, 0].max(), r[:, 1].max()])


def bboxes_overlap(a: np.ndarray, b: np.ndarray) -> bool:
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])


def points_in_ring(points: np.ndarray, ring: Polygon) -> np.ndarray:
    """Vectorized even-odd ray casting: ``(N, 2)`` points vs one ring."""
    return points_in_polygon(np.atleast_2d(np.asarray(points, np.float64)),
                             as_ring(ring))


def points_in_multipolygon(points: np.ndarray,
                           rings: Sequence[Polygon]) -> np.ndarray:
    pts = np.atleast_2d(points)
    # Native (OpenMP) path for large workloads; numpy fallback otherwise.
    if (len(pts) * sum(len(r) for r in rings) > 200_000
            and geokernels.available()):
        return geokernels.pip_multi(pts, [as_ring(r) for r in rings])
    out = np.zeros(len(pts), bool)
    for ring in rings:
        remaining = ~out
        if not remaining.any():
            break
        out[remaining] |= points_in_ring(pts[remaining], ring)
    return out


def _segments_cross(a0, a1, b0, b1) -> bool:
    """Do any segment in batch A properly intersect any in batch B?

    a0, a1: (N, 2) segment endpoints; b0, b1: (M, 2).
    """
    d1 = a1 - a0                                         # (N, 2)
    d2 = b1 - b0                                         # (M, 2)
    diff = b0[None, :, :] - a0[:, None, :]               # (N, M, 2)
    denom = d1[:, None, 0] * d2[None, :, 1] - \
        d1[:, None, 1] * d2[None, :, 0]                  # (N, M)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (diff[..., 0] * d2[None, :, 1]
             - diff[..., 1] * d2[None, :, 0]) / denom
        u = (diff[..., 0] * d1[:, None, 1]
             - diff[..., 1] * d1[:, None, 0]) / denom
    hit = (np.abs(denom) > 1e-18) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return bool(hit.any())


def rings_intersect(a: Polygon, b: Polygon) -> bool:
    """Do two rings intersect (boundary crossing or containment)?"""
    a, b = as_ring(a), as_ring(b)
    if not bboxes_overlap(bbox(a), bbox(b)):
        return False
    if points_in_ring(a[:1], b)[0] or points_in_ring(b[:1], a)[0]:
        return True
    return _segments_cross(a, np.roll(a, -1, 0), b, np.roll(b, -1, 0))


def polygons_intersect(a: Sequence[Polygon] | Polygon,
                       b: Sequence[Polygon] | Polygon) -> bool:
    """MultiPolygon-aware intersection test (adjacency predicate)."""
    aa = [a] if isinstance(a, np.ndarray) else list(a)
    bb = [b] if isinstance(b, np.ndarray) else list(b)
    return any(rings_intersect(ra, rb) for ra in aa for rb in bb)


def scale_about_centroid(poly: Polygon, factor: float,
                         origin: np.ndarray = None) -> Polygon:
    """Scale a ring about its (or a supplied) centroid — the reference's
    1.01x adjacency buffer (`cell_collection.py:195`)."""
    r = as_ring(poly)
    c = polygon_centroid(r) if origin is None else np.asarray(origin)
    return c + factor * (r - c)


def clip_to_convex(subject: Polygon, clip: Polygon) -> Polygon:
    """Sutherland-Hodgman: clip an arbitrary ring to a CONVEX ring.

    Exact for our use — Voronoi regions are convex by construction
    (`cell.py:252-263` intersects Voronoi regions with cell shapes).
    Returns an empty (0, 2) array when the intersection is empty.
    """
    empty = np.empty((0, 2), np.float64)
    clip = as_ring(clip)
    if len(clip) < 3:
        return empty
    # Degenerate clip (all vertices effectively coincident or collinear):
    # the intersection is measure-zero — clip everything away. Guard on
    # extent so tiny-but-real slivers still go through the edge loop
    # (identity clips of slivers must survive).
    extent = float(max(np.ptp(clip[:, 0]), np.ptp(clip[:, 1])))
    if extent == 0.0:
        return empty
    # A 1-ulp repeated vertex is an edge of ~1e-16 of the coordinates'
    # MAGNITUDE, not of the extent: a 1e-3-degree cell at (170, -55)
    # needs the larger of the two, or its noise edge slices it away.
    noise = 1e-12 * max(extent, float(np.abs(clip).max()))
    if polygon_area(clip) < 0:        # ensure CCW so "inside" = left side
        clip = clip[::-1]
    output = as_ring(subject)

    for i in range(len(clip)):
        if len(output) == 0:
            break
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        edge_len = float(np.hypot(edge[0], edge[1]))
        if edge_len <= noise:
            # A (near-)zero-length edge constrains nothing: its normal is
            # pure rounding noise, and hypothesis found a vertex repeated
            # to within 1 ulp (edge ~9e-16) whose noise-normal half-plane
            # sliced a real corner off the subject (rel area loss ~1e-6).
            # Any genuine edge this short can bound at most
            # ~extent^2 * 1e-12 of area — below our own tolerances.
            continue
        rel = output - a
        # inside = left of edge (CCW clip ring). The tolerance must scale
        # with |edge|·|rel| — an absolute epsilon lets near-coincident clip
        # vertices (edge ~1e-200) pass every point and return the subject
        # unclipped (hypothesis-found regression).
        side = edge[0] * rel[:, 1] - edge[1] * rel[:, 0]
        tol = 1e-12 * edge_len * (np.hypot(rel[:, 0], rel[:, 1]) + 1.0)
        inside = side >= -tol

        new_pts = []
        n = len(output)
        for j in range(n):
            k = (j + 1) % n
            p, q = output[j], output[k]
            pin, qin = inside[j], inside[k]
            if pin:
                new_pts.append(p)
            if pin != qin:
                # Intersection of segment pq with the infinite clip edge.
                d = q - p
                denom = edge[0] * d[1] - edge[1] * d[0]
                d_len = float(np.hypot(d[0], d[1]))
                if abs(denom) > 1e-15 * edge_len * (d_len + 1.0):
                    t = (edge[0] * (a[1] - p[1])
                         - edge[1] * (a[0] - p[0])) / denom
                    new_pts.append(p + t * d)
        output = np.asarray(new_pts, np.float64).reshape(-1, 2)
    return output


def convex_hull(points: np.ndarray) -> Polygon:
    """Convex hull ring (Andrew's monotone chain), CCW."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                a = out[-1] - out[-2]
                b = p - out[-2]
                if a[0] * b[1] - a[1] * b[0] > 0:   # strict left turn
                    break
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def dissolve(rings: Sequence[Polygon], snap: float = 1e-7
             ) -> List[Tuple[np.ndarray, List[np.ndarray]]]:
    """Dissolve a polygon COVERAGE (interior-disjoint pieces) into unioned
    polygons with holes.

    The geocell pipeline produces piece lists whose shared borders carry
    snapped-identical vertex chains (Voronoi cuts are computed from the
    same parent edges on both sides; admin products ship shared chains).
    Dissolving such a coverage = cancelling opposite directed edges and
    stitching what remains into rings — the same contract as GEOS coverage
    union, which the reference gets implicitly from `shapely.unary_union`
    when exporting geocell WKT (`cell.py:51-59,475-481`). Pieces whose
    borders DON'T match simply stay as separate rings (graceful
    degradation to the piece list).

    Returns a list of ``(shell, holes)`` per dissolved polygon; shells are
    CCW, holes CW.
    """
    def key(pt) -> Tuple[int, int]:
        return (int(round(pt[0] / snap)), int(round(pt[1] / snap)))

    coord: Dict[Tuple[int, int], np.ndarray] = {}
    ring_keys: List[List[Tuple[int, int]]] = []
    for ring in rings:
        r = as_ring(ring)
        if len(r) < 3:
            continue
        if polygon_area(r) < 0:
            r = r[::-1]
        ks = []
        for p in r:
            k = key(p)
            coord.setdefault(k, np.asarray(p, np.float64))
            if not ks or ks[-1] != k:
                ks.append(k)
        if len(ks) > 1 and ks[0] == ks[-1]:
            ks.pop()
        if len(ks) >= 3:
            ring_keys.append(ks)
    if not ring_keys:
        return []

    # Node edges at T-junctions: a vertex of one piece lying mid-edge of
    # another (partial border overlaps, e.g. a long admin edge met by two
    # shorter neighbor edges) must split that edge, or opposite sub-edges
    # can't cancel.
    all_keys = list(coord)
    vtx = np.asarray([coord[k] for k in all_keys])       # (V, 2)
    tol = 2.0 * snap

    edge_count: Dict[Tuple, int] = {}
    for ks in ring_keys:
        for i in range(len(ks)):
            ka, kb = ks[i], ks[(i + 1) % len(ks)]
            a, b = coord[ka], coord[kb]
            d = b - a
            L2 = float(d @ d)
            if L2 <= tol * tol:
                chain = [ka, kb]
            else:
                rel = vtx - a
                u = (rel @ d) / L2
                perp = np.abs(rel[:, 0] * d[1] - rel[:, 1] * d[0]) \
                    / np.sqrt(L2)
                on = (perp <= tol) & (u > 1e-12) & (u < 1 - 1e-12)
                interior = [(float(u[j]), all_keys[j])
                            for j in np.where(on)[0]
                            if all_keys[j] != ka and all_keys[j] != kb]
                interior.sort()
                chain = [ka] + [k for _, k in interior] + [kb]
            for j in range(len(chain) - 1):
                if chain[j] != chain[j + 1]:
                    e = (chain[j], chain[j + 1])
                    edge_count[e] = edge_count.get(e, 0) + 1

    # Cancel opposite shared edges (interior borders of the coverage).
    for (a, b) in list(edge_count):
        if a >= b:          # visit each unordered pair once
            continue
        fwd, rev = edge_count.get((a, b), 0), edge_count.get((b, a), 0)
        cancel = min(fwd, rev)
        if cancel:
            edge_count[(a, b)] = fwd - cancel
            edge_count[(b, a)] = rev - cancel

    out_edges: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    n_edges = 0
    for (a, b), cnt in edge_count.items():
        for _ in range(cnt):
            out_edges.setdefault(a, []).append(b)
            n_edges += 1

    def take_next(prev: Tuple[int, int], cur: Tuple[int, int]):
        """Pop the outgoing edge making the sharpest LEFT turn — keeps
        stitched rings simple at shared corners."""
        cands = out_edges.get(cur)
        if not cands:
            return None
        if len(cands) == 1:
            return cands.pop()
        vin = coord[cur] - coord[prev]
        ain = np.arctan2(vin[1], vin[0])
        best_i, best_t = 0, -np.inf
        for i, nxt in enumerate(cands):
            if nxt == prev and len(cands) > 1:
                turn = -np.inf  # avoid immediate backtrack if avoidable
            else:
                v = coord[nxt] - coord[cur]
                # CCW turn angle in (-pi, pi]; larger = harder left
                turn = np.arctan2(vin[0] * v[1] - vin[1] * v[0],
                                  vin[0] * v[0] + vin[1] * v[1])
            if turn > best_t:
                best_i, best_t = i, turn
        return cands.pop(best_i)

    stitched: List[np.ndarray] = []
    guard = 4 * n_edges + 16
    while any(out_edges.values()) and guard > 0:
        start = next(k for k, v in out_edges.items() if v)
        cur = out_edges[start].pop()
        path = [start, cur]
        prev = start
        while cur != start and guard > 0:
            guard -= 1
            nxt = take_next(prev, cur)
            if nxt is None:       # dangling chain: drop it
                path = []
                break
            prev, cur = cur, nxt
            path.append(cur)
        if len(path) >= 4:        # closed ring (start repeated at end)
            ring = np.asarray([coord[k] for k in path[:-1]], np.float64)
            if abs(polygon_area(ring)) > 0:
                stitched.append(ring)

    # Classify shells (CCW) vs holes (CW); nest holes in smallest shell.
    shells = [r for r in stitched if polygon_area(r) > 0]
    holes = [r for r in stitched if polygon_area(r) < 0]
    result: List[Tuple[np.ndarray, List[np.ndarray]]] = \
        [(s, []) for s in shells]
    for h in holes:
        inside = [i for i, (s, _) in enumerate(result)
                  if points_in_ring(h[:1], s)[0]]
        if inside:
            i = min(inside, key=lambda i: abs(polygon_area(result[i][0])))
            result[i][1].append(h)
        # orphan holes (mismatched borders) are dropped
    return result


def dissolve_to_wkt(rings: Sequence[Polygon], snap: float = 1e-7) -> str:
    """Dissolved-union WKT export (the reference's geocell geometry
    column is a shapely union, `cell.py:51-59`)."""
    return components_to_wkt(dissolve(rings, snap))


def components_to_wkt(polys: Sequence[Tuple[np.ndarray, List[np.ndarray]]]
                      ) -> str:
    """WKT for pre-dissolved ``(shell, holes)`` components."""
    if not polys:
        return "POLYGON EMPTY"

    def ring_str(r):
        closed = np.vstack([r, r[:1]])
        return "(" + ", ".join(f"{x:.6f} {y:.6f}" for x, y in closed) + ")"

    def poly_str(shell, holes):
        return ("(" + ring_str(shell)
                + "".join(", " + ring_str(h) for h in holes) + ")")

    if len(polys) == 1:
        shell, holes = polys[0]
        return ("POLYGON (" + ring_str(shell)
                + "".join(", " + ring_str(h) for h in holes) + ")")
    return ("MULTIPOLYGON ("
            + ", ".join(poly_str(s, h) for s, h in polys) + ")")


def boundary_proximity_count(subject: Polygon, others: Sequence[Polygon],
                             tol: float, samples: int = 64) -> int:
    """How many of `samples` points along `subject`'s boundary lie within
    `tol` of any boundary in `others` — the adjacency score used for
    sliver reassignment (approximates the reference's buffered-
    intersection area, `cell.py:455-470`: for touching polygons the
    buffer(0.01) intersection area is proportional to shared border
    length)."""
    r = as_ring(subject)
    if len(r) < 2 or not others:
        return 0
    closed = np.vstack([r, r[:1]])
    seg = np.diff(closed, axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    total = seg_len.sum()
    if total == 0:
        return 0
    # `samples` points spaced evenly by arc length.
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    t = (np.arange(samples) + 0.5) / samples * total
    idx = np.clip(np.searchsorted(cum, t) - 1, 0, len(seg) - 1)
    frac = (t - cum[idx]) / np.maximum(seg_len[idx], 1e-30)
    pts = closed[idx] + seg[idx] * frac[:, None]          # (samples, 2)

    hit = np.zeros(samples, bool)
    for other in others:
        o = as_ring(other)
        if len(o) < 2:
            continue
        oc = np.vstack([o, o[:1]])
        a, d = oc[:-1], np.diff(oc, axis=0)               # (M, 2)
        rel = pts[:, None, :] - a[None]                   # (S, M, 2)
        denom = np.maximum((d * d).sum(-1), 1e-30)
        u = np.clip((rel * d[None]).sum(-1) / denom, 0, 1)
        near = a[None] + u[..., None] * d[None]
        dist = np.hypot(*(pts[:, None, :] - near).transpose(2, 0, 1))
        hit |= (dist <= tol).any(1)
        if hit.all():
            break
    return int(hit.sum())


def to_wkt(rings: Sequence[Polygon] | Polygon) -> str:
    """Serialize as WKT POLYGON/MULTIPOLYGON (closing rings), matching the
    reference's geocell CSV geometry column."""
    if isinstance(rings, np.ndarray):
        rings = [rings]
    rings = [as_ring(r) for r in rings if len(as_ring(r)) >= 3]
    if not rings:
        return "POLYGON EMPTY"

    def ring_str(r):
        closed = np.vstack([r, r[:1]])
        return "(" + ", ".join(f"{x:.6f} {y:.6f}" for x, y in closed) + ")"

    if len(rings) == 1:
        return f"POLYGON ({ring_str(rings[0])})"
    return ("MULTIPOLYGON ("
            + ", ".join(f"({ring_str(r)})" for r in rings) + ")")


def from_wkt(wkt: str) -> MultiPolygon:
    """Parse POLYGON/MULTIPOLYGON WKT (outer rings only; holes dropped)."""
    s = wkt.strip()
    if s.upper().startswith("POLYGON EMPTY"):
        return []

    def parse_ring(text: str) -> np.ndarray:
        pairs = [p.strip() for p in text.split(",")]
        return as_ring(np.asarray(
            [[float(v) for v in p.split()[:2]] for p in pairs]))

    import re
    body = s[s.index("(") :]
    if s.upper().startswith("MULTIPOLYGON"):
        polys = re.findall(r"\(\(([^()]+)\)", body)
        return [parse_ring(p) for p in polys]
    ring = re.findall(r"\(([^()]+)\)", body)
    return [parse_ring(ring[0])]
