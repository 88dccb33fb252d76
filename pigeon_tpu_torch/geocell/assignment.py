"""Point -> geocell label assignment.

Counterpart of `pigeon_tpu/geocell/assignment.py`.

Rebuilds the reference's spatial-index label generation
(`preprocessing/dataset_preprocessing.py:60-94`): a point gets the geocell
whose polygon covers it, else the nearest geocell (by centroid distance —
the reference's sindex.nearest uses polygon distance; centroid distance is
the piece-list equivalent and only differs for far-outside points where
both are fallbacks anyway).

Loads either a live `CellCollection` or the geocell CSV (WKT geometry +
lng/lat centroid columns) written by `CellCollection.to_csv`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from pigeon_tpu_torch.geocell import geometry as geom


class CellAssigner:
    def __init__(self, polygons_per_cell: List[List[np.ndarray]],
                 centroids: np.ndarray):
        """Args:
            polygons_per_cell: ring lists, one entry per geocell (index =
                geocell label used in training).
            centroids: ``(num_cells, 2)`` (lon, lat) cell centroids.
        """
        self.polygons = polygons_per_cell
        self.centroids = np.asarray(centroids, np.float64)
        self.bboxes = np.stack([
            _multibbox(p) if p else np.array([np.inf, np.inf,
                                              -np.inf, -np.inf])
            for p in polygons_per_cell])

    @classmethod
    def from_collection(cls, cells) -> "CellAssigner":
        ordered = sorted(cells, key=lambda c: c.cell_id)
        return cls([c.polygons for c in ordered],
                   np.stack([c.centroid for c in ordered]))

    @classmethod
    def from_csv(cls, path: str) -> "CellAssigner":
        import pandas as pd

        df = pd.read_csv(path)
        polys = [geom.from_wkt(w) if isinstance(w, str) else []
                 for w in df.get("geometry", [""] * len(df))]
        centroids = df[["lng", "lat"]].to_numpy(np.float64)
        return cls(polys, centroids)

    @property
    def num_cells(self) -> int:
        return len(self.centroids)

    def assign(self, points: np.ndarray) -> np.ndarray:
        """``(N, 2)`` (lon, lat) -> ``(N,)`` geocell indices."""
        pts = np.atleast_2d(np.asarray(points, np.float64))
        out = np.full(len(pts), -1, np.int64)
        inside_box = ((pts[:, None, 0] >= self.bboxes[None, :, 0])
                      & (pts[:, None, 0] <= self.bboxes[None, :, 2])
                      & (pts[:, None, 1] >= self.bboxes[None, :, 1])
                      & (pts[:, None, 1] <= self.bboxes[None, :, 3]))
        for ci in range(self.num_cells):
            cand = np.where((out < 0) & inside_box[:, ci])[0]
            if len(cand) == 0 or not self.polygons[ci]:
                continue
            hit = geom.points_in_multipolygon(pts[cand], self.polygons[ci])
            out[cand[hit]] = ci
        missing = out < 0
        if missing.any():
            d = np.linalg.norm(
                pts[missing, None, :] - self.centroids[None], axis=-1)
            out[missing] = d.argmin(1)
        return out

    def one_hot(self, points: np.ndarray) -> np.ndarray:
        idx = self.assign(points)
        out = np.zeros((len(idx), self.num_cells), np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return out


def _multibbox(rings: Sequence[np.ndarray]) -> np.ndarray:
    pts = np.vstack(rings)
    return np.array([pts[:, 0].min(), pts[:, 1].min(),
                     pts[:, 0].max(), pts[:, 1].max()])
