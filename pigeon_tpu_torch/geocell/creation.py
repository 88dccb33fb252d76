"""GeocellCreator: admin-seeded semantic geocell creation.

Counterpart of `pigeon_tpu/geocell/creation.py`. Its boundaries are
`geocell.boundaries.BoundarySet`, the port's one boundary lookup, which
the augmentor reads too.

Rebuilds `dataset_creation/geocell/geocell_creation.py:45-247`:

  1. assign every training point a country / admin-1 / admin-2 id via
     point-in-polygon over boundary GeoJSON (nearest-centroid fill for
     points no polygon covers);
  2. seed one cell per admin-2 area containing training points;
  3. attach point-less admin-2 polygons to the nearest seeded cell;
  4. balance via `CellCollection.balance` (fuse/split);
  5. export the geocell CSV (name/admin_1/country/size/num_polygons/WKT +
     centroid lng/lat).

Boundary files are GeoJSON FeatureCollections (the reference downloads
geoBoundaries/GADM via `get_auxiliary_data.sh`); any file with Polygon /
MultiPolygon features works.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from pigeon_tpu_torch.geocell import geometry as geom
from pigeon_tpu_torch.geocell.boundaries import BoundarySet
from pigeon_tpu_torch.geocell.cells import (
    Cell,
    CellCollection,
    OPTICS_PARAMS_PLANET,
)

LEVEL_NAMES = ("country_id", "admin_1_id", "admin_2_id")


class GeocellCreator:
    """Semantic geocell creation from a training dataframe + boundaries.

    Args:
        df: training metadata with ``lng``, ``lat`` and optionally a
            ``selection`` column (rows with ``selection == 'train'`` are
            used, reference `geocell_creation.py:61`) and optionally
            precomputed ``country_id``/``admin_1_id``/``admin_2_id``.
        countries / admin_1 / admin_2: `BoundarySet`s (admin_2 required
            unless ids are precomputed in ``df``).
    """

    def __init__(self, df: pd.DataFrame,
                 admin_2: Optional[BoundarySet] = None,
                 admin_1: Optional[BoundarySet] = None,
                 countries: Optional[BoundarySet] = None):
        if "selection" in df.columns:
            df = df[df["selection"] == "train"]
        self.df = df.reset_index(drop=True).copy()
        self.admin_2 = admin_2
        self.admin_1 = admin_1
        self.countries = countries
        self.cells: Optional[CellCollection] = None

    def generate(self, min_cell_size: int, max_cell_size: int,
                 optics_params=OPTICS_PARAMS_PLANET,
                 output_csv: Optional[str] = None,
                 num_workers: int = 0) -> CellCollection:
        points = self.df[["lng", "lat"]].to_numpy(np.float64)

        have_ids = all(c in self.df.columns for c in LEVEL_NAMES) and \
            not self.df[list(LEVEL_NAMES)].isnull().any().any()
        if not have_ids:
            # Without boundaries the whole world degrades to one pseudo
            # admin area per level: cells seed from the global point cloud
            # (convex hull) and ALL structure comes from OPTICS splitting.
            levels = {
                "country_id": self.countries,
                "admin_1_id": self.admin_1,
                "admin_2_id": self.admin_2,
            }
            for name, bset in levels.items():
                if bset is None:    # degrade gracefully: one global area
                    self.df[name] = "0"
                else:
                    self.df[name] = bset.assign_with_nearest_fill(
                        points).astype(str)

        cells = self._seed_cells()
        if self.admin_2 is not None:
            self._attach_empty_areas(cells)
        self.cells = CellCollection(cells)
        self.cells.balance(min_cell_size, max_cell_size, optics_params,
                           num_workers=num_workers)
        if output_csv:
            self.cells.to_csv(output_csv)
        return self.cells

    def _seed_cells(self) -> List[Cell]:
        """One cell per admin-2 area containing training points
        (reference `geocell_creation.py:110-143`)."""
        cells = []
        for a2, group in self.df.groupby("admin_2_id"):
            pts = group[["lng", "lat"]].to_numpy(np.float64)
            a1 = str(group.iloc[0]["admin_1_id"])
            country = str(group.iloc[0]["country_id"])
            if self.admin_2 is not None:
                polys = list(self.admin_2.rings[int(a2)])
            else:
                hull = geom.convex_hull(pts)
                polys = [hull] if len(hull) >= 3 else []
            cells.append(Cell(str(a2), a1, country, pts, polys))
        return cells

    def _attach_empty_areas(self, cells: List[Cell]) -> None:
        """Attach point-less admin-2 polygons to the nearest seeded cell
        by boundary centroid (reference `geocell_creation.py:204-230`)."""
        seeded = {int(c.cell_id): c for c in cells}
        seeded_ids = np.array(sorted(seeded))
        seeded_centroids = self.admin_2.centroids[seeded_ids]
        for fi in range(len(self.admin_2)):
            if fi in seeded:
                continue
            d = np.linalg.norm(
                self.admin_2.centroids[fi] - seeded_centroids, axis=-1)
            target = seeded[int(seeded_ids[d.argmin()])]
            target.polygons.extend(self.admin_2.rings[fi])
