"""Boundary polygons from GeoJSON and the point -> feature lookup.

The port's one implementation of the JAX package's two lookups:
`pigeon_tpu/geocell/creation.py::BoundarySet` (the augmentor's countries
and admin-1 areas) and `pigeon_tpu/train/metrics.py::CountryIndex`
(``Country_accuracy``). Both take each Polygon's or MultiPolygon's outer
rings, prefilter by bounding box, ray-cast, and give a point that no
polygon covers the feature of the nearest vertex mean. They differ in
two details, kept here as arguments: `BoundarySet` drops a ring's
closing vertex (`pigeon_tpu/geocell/geometry.py::as_ring`), which moves
the vertex mean the fallback measures against, and the two read a
feature's name from different properties.

Coordinates are planar (lon, lat), as there; holes are not modelled.
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


def as_ring(poly) -> np.ndarray:
    """``poly`` as an unclosed ``(N, 2)`` float64 ring: a last vertex
    within 1e-9 of the ring's extent from the first is dropped
    (`pigeon_tpu/geocell/geometry.py::as_ring`)."""
    ring = np.asarray(poly, np.float64)
    if ring.ndim != 2 or ring.shape[1] != 2:
        raise ValueError(f"ring must be (N, 2), got {ring.shape}")
    if len(ring) > 1:
        extent = float(max(np.ptp(ring[:, 0]), np.ptp(ring[:, 1]), 1e-12))
        if np.abs(ring[0] - ring[-1]).max() <= 1e-9 * extent:
            ring = ring[:-1]
    return ring


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Even-odd ray casting in +x: ``(N, 2)`` points against one ``(M, 2)``
    ring -> ``(N,)`` bool. A point exactly on an edge may land either
    way."""
    x, y = points[:, 0:1], points[:, 1:2]
    x0, y0 = polygon[:, 0], polygon[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    straddle = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
    return (np.sum(straddle & (xs > x), axis=1) % 2) == 1


#: The feature-name properties the augmentor tries, in order
#: (geoBoundaries ``shapeName``, GADM ``COUNTRY``/``NAME_*``, Natural
#: Earth ``ADMIN``/``name``).
NAME_KEYS = ("shapeName", "name", "NAME", "COUNTRY", "NAME_0", "NAME_1",
             "ADMIN", "admin")
#: Those `CountryIndex` reads.
COUNTRY_NAME_KEYS = ("name", "ADMIN")


class BoundarySet:
    """Polygon features: ``rings`` (each feature's outer rings),
    ``names``, bounding boxes and vertex means."""

    def __init__(self, rings: List[List[np.ndarray]], names: Sequence[str]):
        self.rings = rings
        self.names = list(names)
        pts = [np.concatenate(r) for r in rings]
        self.bboxes = np.array([[p[:, 0].min(), p[:, 1].min(),
                                 p[:, 0].max(), p[:, 1].max()] for p in pts])
        self.centroids = np.stack([p.mean(0) for p in pts])

    @classmethod
    def from_geojson(cls, path: str, drop_closing: bool = True,
                     name_keys: Sequence[str] = NAME_KEYS) -> "BoundarySet":
        """The Polygon and MultiPolygon features of a FeatureCollection;
        ``drop_closing`` passes each ring through `as_ring`. A feature
        with none of ``name_keys`` is named by its index."""
        with open(path) as f:
            feats = json.load(f)["features"]
        rings, names = [], []
        for i, feat in enumerate(feats):
            g = feat["geometry"]
            polys = ([g["coordinates"]] if g["type"] == "Polygon"
                     else g["coordinates"])
            rings.append([as_ring(p[0]) if drop_closing
                          else np.asarray(p[0], np.float64) for p in polys])
            props = feat.get("properties") or {}
            names.append(next((str(props[k]) for k in name_keys
                               if props.get(k)), str(i)))
        return cls(rings, names)

    def __len__(self) -> int:
        return len(self.rings)

    def assign(self, points: np.ndarray) -> np.ndarray:
        """``(N, 2)`` (lon, lat) -> ``(N,)`` the first feature containing
        each point, -1 for none."""
        pts = np.asarray(points, np.float64)
        out = np.full(len(pts), -1, np.int64)
        box = self.bboxes
        inside_box = ((pts[:, None, 0] >= box[None, :, 0])
                      & (pts[:, None, 0] <= box[None, :, 2])
                      & (pts[:, None, 1] >= box[None, :, 1])
                      & (pts[:, None, 1] <= box[None, :, 3]))
        for fi, rings in enumerate(self.rings):
            cand = np.where((out < 0) & inside_box[:, fi])[0]
            if len(cand) == 0:
                continue
            hit = np.zeros(len(cand), bool)
            for ring in rings:
                hit |= points_in_polygon(pts[cand], ring)
            out[cand[hit]] = fi
        return out

    def assign_with_nearest_fill(self, points: np.ndarray) -> np.ndarray:
        """`assign`, then the nearest vertex mean's feature for a point no
        polygon covers."""
        out = self.assign(points)
        missing = out < 0
        if missing.any():
            pts = np.asarray(points, np.float64)
            d = np.linalg.norm(pts[missing, None, :] - self.centroids[None],
                               axis=-1)
            out[missing] = d.argmin(1)
        return out
