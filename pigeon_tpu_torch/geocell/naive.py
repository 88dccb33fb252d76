"""Naive rectangular geocells: recursive quad-ish splitting baseline.

Counterpart of `pigeon_tpu/geocell/naive.py`.

Rebuilds `dataset_creation/geocell/naive_cell.py:10-87` (the reference's
baseline used for ablations): start from one world rectangle, recursively
split any cell holding more than `max_size` points at the midpoint of its
wider axis. The reference's version crashes on use (undefined name at
`naive_cell.py:62`); this one works.
"""

from __future__ import annotations

from typing import List

import numpy as np


class NaiveCell:
    """Axis-aligned rectangular cell over a point set."""

    def __init__(self, points: np.ndarray, lon_min: float = -180.0,
                 lat_min: float = -90.0, lon_max: float = 180.0,
                 lat_max: float = 90.0):
        self.points = np.asarray(points, np.float64).reshape(-1, 2)
        self.bounds = (lon_min, lat_min, lon_max, lat_max)

    @property
    def size(self) -> int:
        return len(self.points)

    @property
    def centroid(self) -> np.ndarray:
        if self.size:
            return self.points.mean(0)
        b = self.bounds
        return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2])

    @property
    def width(self) -> float:
        return self.bounds[2] - self.bounds[0]

    @property
    def height(self) -> float:
        return self.bounds[3] - self.bounds[1]

    def split(self) -> List["NaiveCell"]:
        """Split at the midpoint of the wider axis."""
        lon_min, lat_min, lon_max, lat_max = self.bounds
        if self.width >= self.height:
            mid = (lon_min + lon_max) / 2.0
            left = self.points[:, 0] < mid
            return [
                NaiveCell(self.points[left], lon_min, lat_min, mid, lat_max),
                NaiveCell(self.points[~left], mid, lat_min, lon_max,
                          lat_max),
            ]
        mid = (lat_min + lat_max) / 2.0
        low = self.points[:, 1] < mid
        return [
            NaiveCell(self.points[low], lon_min, lat_min, lon_max, mid),
            NaiveCell(self.points[~low], lon_min, mid, lon_max, lat_max),
        ]

    @classmethod
    def build(cls, points: np.ndarray, max_size: int,
              min_size: int = 1) -> List["NaiveCell"]:
        """Recursive build: split until every cell has <= max_size points;
        cells below min_size are dropped."""
        stack = [cls(points)]
        done: List[NaiveCell] = []
        while stack:
            cell = stack.pop()
            if cell.size <= max_size:
                if cell.size >= min_size:
                    done.append(cell)
                continue
            stack.extend(cell.split())
        return done

    def contains(self, points: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(points)
        b = self.bounds
        return ((pts[:, 0] >= b[0]) & (pts[:, 0] < b[2])
                & (pts[:, 1] >= b[1]) & (pts[:, 1] < b[3]))

    def __repr__(self):
        return f"NaiveCell(size={self.size}, bounds={self.bounds})"
