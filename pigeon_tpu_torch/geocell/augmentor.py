"""GeoAugmentor: offline enrichment of (lon, lat) metadata.

The port's own copy of `pigeon_tpu/geocell/augmentor.py`, with its
behaviour and columns: country and admin-1 names (boundary polygons,
`geocell/boundaries.py`), the Köppen-Geiger climate zone (raster),
elevation, population density, and WorldClim temperature and
precipitation statistics, the source of the multi-task labels and the
caption ingredients (reference `preprocessing/geo_augmentor.py:83-353`).

Rasters go through a minimal PIL GeoTIFF sampler (the affine transform
from GeoTIFF tags 33550 and 33922); boundaries through
`geocell.boundaries.BoundarySet`. Every enrichment is gated on its file
being present: a missing source is skipped, not an error.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from pigeon_tpu_torch.geocell.boundaries import BoundarySet

logger = logging.getLogger("pigeon_tpu_torch.augmentor")

#: Köppen-Geiger legend: raster value -> (code, description, caption text).
#: Standard Beck et al. 2018 legend (the reference uses the same 30 classes,
#: `preprocessing/geo_augmentor.py:46-78`).
KOPPEN_CLASSES: Dict[int, Tuple[str, str, str]] = {
    1: ("Af", "Tropical, rainforest", "a tropical rainforest climate"),
    2: ("Am", "Tropical, monsoon", "a tropical monsoon climate"),
    3: ("Aw", "Tropical, savannah", "a tropical savanna climate"),
    4: ("BWh", "Arid, desert, hot", "an arid, hot desert climate"),
    5: ("BWk", "Arid, desert, cold", "an arid, cold desert climate"),
    6: ("BSh", "Arid, steppe, hot", "a hot, semi-arid climate"),
    7: ("BSk", "Arid, steppe, cold", "a cold, semi-arid climate"),
    8: ("Csa", "Temperate, dry summer, hot summer",
        "a Mediterranean climate with a hot summer"),
    9: ("Csb", "Temperate, dry summer, warm summer",
        "a Mediterranean climate with a warm summer"),
    10: ("Csc", "Temperate, dry summer, cold summer",
         "a Mediterranean climate with a cold summer"),
    11: ("Cwa", "Temperate, dry winter, hot summer",
         "a humid subtropical monsoon climate"),
    12: ("Cwb", "Temperate, dry winter, warm summer",
         "a temperate oceanic monsoon climate"),
    13: ("Cwc", "Temperate, dry winter, cold summer",
         "a subpolar oceanic monsoon climate"),
    14: ("Cfa", "Temperate, no dry season, hot summer",
         "a humid subtropical climate"),
    15: ("Cfb", "Temperate, no dry season, warm summer",
         "a temperate oceanic climate"),
    16: ("Cfc", "Temperate, no dry season, cold summer",
         "a subpolar oceanic climate"),
    17: ("Dsa", "Cold, dry summer, hot summer",
         "a Mediterranean humid continental climate with a hot summer"),
    18: ("Dsb", "Cold, dry summer, warm summer",
         "a Mediterranean humid continental climate with a warm summer"),
    19: ("Dsc", "Cold, dry summer, cold summer",
         "a Mediterranean subarctic climate with a cold summer"),
    20: ("Dsd", "Cold, dry summer, very cold winter",
         "a Mediterranean humid continental climate with a warm summer"),
    21: ("Dwa", "Cold, dry winter, hot summer",
         "a humid continental monsoon climate with a hot summer"),
    22: ("Dwb", "Cold, dry winter, warm summer",
         "a humid continental monsoon climate with a warm summer"),
    23: ("Dwc", "Cold, dry winter, cold summer", "a subarctic monsoon climate"),
    24: ("Dwd", "Cold, dry winter, very cold winter",
         "an extremely cold subarctic monsoon climate"),
    25: ("Dfa", "Cold, no dry season, hot summer",
         "a humid continental climate with a hot summer"),
    26: ("Dfb", "Cold, no dry season, warm summer",
         "a humid continental climate with a warm summer"),
    27: ("Dfc", "Cold, no dry season, cold summer", "a subarctic climate"),
    28: ("Dfd", "Cold, no dry season, very cold winter",
         "an extremely cold subarctic climate"),
    29: ("ET", "Polar, tundra", "a polar tundra climate"),
    30: ("EF", "Polar, frost", "a polar ice cap climate"),
}

NUM_CLIMATE_CLASSES = 28  # model head classes (reference super_guessr.py:19)


def climate_class_index(raster_value: int) -> int:
    """Raster class (1..30) -> model class index (0..27).

    The head has 28 classes (reference `super_guessr.py:19`) against 30
    legend entries; the two polar classes fold onto the last two indices
    by clamping — matching a 0-indexed 28-wide one-hot of value-1.
    """
    return int(np.clip(raster_value - 1, 0, NUM_CLIMATE_CLASSES - 1))


class GeoTiffSampler:
    """Minimal GeoTIFF nearest-neighbour point sampler (PIL).

    Reads the affine georeference from GeoTIFF tags: ModelPixelScale
    (33550) + ModelTiepoint (33922). Assumes north-up rasters in a
    lon/lat-aligned CRS (true for the Köppen and WorldClim products; for
    Mollweide rasters like GHSL pass `transform_fn` to project
    coordinates first — the reference reprojects with geopandas,
    `geo_augmentor.py:273-274`).
    """

    def __init__(self, path: str, transform_fn=None, nodata=None):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        with Image.open(path) as im:
            tags = getattr(im, "tag_v2", {})
            self.scale = tags.get(33550)     # (sx, sy, sz)
            self.tiepoint = tags.get(33922)  # (i, j, k, x, y, z)
            self.data = np.asarray(im)
        if self.scale is None or self.tiepoint is None:
            raise ValueError(f"{path}: missing GeoTIFF georeference tags")
        self.transform_fn = transform_fn
        self.nodata = nodata

    def sample(self, lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
        x, y = (np.asarray(lon, np.float64), np.asarray(lat, np.float64))
        if self.transform_fn is not None:
            x, y = self.transform_fn(x, y)
        sx, sy = float(self.scale[0]), float(self.scale[1])
        _, _, _, ox, oy = (*self.tiepoint[:3], *self.tiepoint[3:5])
        col = np.clip(((x - ox) / sx).astype(np.int64),
                      0, self.data.shape[1] - 1)
        row = np.clip(((oy - y) / sy).astype(np.int64),
                      0, self.data.shape[0] - 1)
        return self.data[row, col]


def mollweide_forward(lon: np.ndarray, lat: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(lon, lat) degrees -> Mollweide (ESRI:54009) meters.

    Newton iteration for the auxiliary angle; used to sample the GHSL
    population raster without a projection library.
    """
    r = 6371007.181
    lon_r = np.deg2rad(np.asarray(lon, np.float64))
    lat_r = np.deg2rad(np.asarray(lat, np.float64))
    theta = lat_r.copy()
    for _ in range(10):
        denom = 2.0 + 2.0 * np.cos(2.0 * theta)
        step = np.where(np.abs(denom) < 1e-12, 0.0,
                        (2.0 * theta + np.sin(2.0 * theta)
                         - np.pi * np.sin(lat_r)) / np.maximum(denom, 1e-12))
        theta = theta - step
    x = r * (2.0 * np.sqrt(2.0) / np.pi) * lon_r * np.cos(theta)
    y = r * np.sqrt(2.0) * np.sin(theta)
    return x, y


class GeoAugmentor:
    """Offline metadata enrichment; every source optional."""

    def __init__(self,
                 countries=None, country_names: Optional[Sequence[str]] = None,
                 admin_1=None, admin_1_names: Optional[Sequence[str]] = None,
                 koppen_raster: Optional[str] = None,
                 elevation_raster: Optional[str] = None,
                 population_raster: Optional[str] = None,
                 worldclim_tavg: Optional[Sequence[str]] = None,
                 worldclim_prec: Optional[Sequence[str]] = None,
                 driving_side: Optional[Dict[str, str]] = None):
        """Args:
            countries / admin_1: `geocell.boundaries.BoundarySet`s with
                parallel name lists.
            koppen_raster: Beck Köppen-Geiger GeoTIFF path.
            elevation_raster: elevation GeoTIFF (SRTM-derived).
            population_raster: GHSL population GeoTIFF (Mollweide).
            worldclim_tavg / worldclim_prec: 12 monthly GeoTIFF paths.
            driving_side: country name -> 'left'|'right'.
        """
        self.countries = countries
        self.country_names = list(country_names or [])
        self.admin_1 = admin_1
        self.admin_1_names = list(admin_1_names or [])
        self.driving_side = driving_side or {}
        self._koppen = self._open(koppen_raster)
        self._elevation = self._open(elevation_raster)
        self._population = (
            GeoTiffSampler(population_raster,
                           transform_fn=mollweide_forward)
            if population_raster else None)
        self._tavg = [self._open(p) for p in (worldclim_tavg or [])]
        self._prec = [self._open(p) for p in (worldclim_prec or [])]

    @staticmethod
    def _open(path: Optional[str]) -> Optional[GeoTiffSampler]:
        if not path:
            return None
        try:
            return GeoTiffSampler(path)
        except (OSError, ValueError) as e:
            logger.warning("raster %s unavailable: %s", path, e)
            return None

    def augment(self, df: pd.DataFrame) -> pd.DataFrame:
        """Add all available enrichment columns to `df` (lng/lat required)."""
        df = df.copy()
        lon = df["lng"].to_numpy(np.float64)
        lat = df["lat"].to_numpy(np.float64)

        if self.countries is not None:
            idx = self.countries.assign_with_nearest_fill(
                np.stack([lon, lat], -1))
            df["country_name"] = [
                self.country_names[i] if i < len(self.country_names)
                else str(i) for i in idx]
            if self.driving_side:
                df["driving_right"] = [
                    self.driving_side.get(c) == "right"
                    if c in self.driving_side else np.nan
                    for c in df["country_name"]]

        if self.admin_1 is not None:
            idx = self.admin_1.assign_with_nearest_fill(
                np.stack([lon, lat], -1))
            df["geo_area"] = [
                self.admin_1_names[i] if i < len(self.admin_1_names)
                else str(i) for i in idx]

        if self._koppen is not None:
            vals = self._koppen.sample(lon, lat).astype(int)
            df["climate_zone"] = [
                KOPPEN_CLASSES[v][2] if v in KOPPEN_CLASSES else np.nan
                for v in vals]
            df["climate_zone_idx"] = [climate_class_index(v) for v in vals]

        if self._elevation is not None:
            df["elevation"] = self._elevation.sample(lon, lat) \
                .astype(np.float64)

        if self._population is not None:
            df["population"] = self._population.sample(lon, lat) \
                .astype(np.float64)

        if self._tavg:
            monthly = np.stack([s.sample(lon, lat).astype(np.float64)
                                for s in self._tavg])
            df["temp_avg"] = monthly.mean(0)
            df["temp_diff"] = monthly.max(0) - monthly.min(0)
        if self._prec:
            monthly = np.stack([s.sample(lon, lat).astype(np.float64)
                                for s in self._prec])
            df["prec_avg"] = monthly.mean(0)
            df["prec_diff"] = monthly.max(0) - monthly.min(0)

        return df


def load_boundaries_with_names(path: str):
    """GeoJSON -> (`BoundarySet`, feature names): each feature's name is
    its first property of `geocell.boundaries.NAME_KEYS`, else its index
    as a string (the reference reads GADM ``NAME_0``/``NAME_1``,
    `preprocessing/geo_augmentor.py:97-169`)."""
    bs = BoundarySet.from_geojson(path)
    return bs, bs.names


def _tif_glob(directory: str):
    """Sorted GeoTIFF paths under ``directory`` ([] when absent)."""
    import glob
    import os

    hits = []
    for pat in ("*.tif", "*.tiff"):
        hits += glob.glob(os.path.join(directory, pat))
    return sorted(hits)


def build_augmentor(aux_dir: str) -> Optional[GeoAugmentor]:
    """Construct a `GeoAugmentor` from the conventional auxiliary-data
    layout that `scripts/get_auxiliary_data.sh` fetches:

    ``<aux>/boundaries/geoBoundariesCGAZ_ADM0.geojson`` (countries),
    ``.../ADM1`` (admin-1 areas), ``<aux>/koppen_geiger/*.tif``,
    ``<aux>/elevation/*.tif``, ``<aux>/pop_density/*.tif``,
    ``<aux>/worldclim/tavg/*.tif`` + ``.../prec/*.tif`` (12 monthly),
    ``<aux>/driving_side.json`` ({country name: 'left'|'right'}).

    Every source is optional; returns None when NOTHING is present so
    callers can gate auto-augmentation on data availability (the
    reference augments unconditionally and crashes without its GADM
    files — `finetune_dataset.py:135-137`, `geo_augmentor.py:301-348`).
    """
    import json
    import os

    kw: Dict = {}
    adm0 = os.path.join(aux_dir, "boundaries",
                        "geoBoundariesCGAZ_ADM0.geojson")
    if os.path.exists(adm0):
        kw["countries"], kw["country_names"] = \
            load_boundaries_with_names(adm0)
    adm1 = os.path.join(aux_dir, "boundaries",
                        "geoBoundariesCGAZ_ADM1.geojson")
    if os.path.exists(adm1):
        kw["admin_1"], kw["admin_1_names"] = \
            load_boundaries_with_names(adm1)

    koppen = _tif_glob(os.path.join(aux_dir, "koppen_geiger"))
    if koppen:
        kw["koppen_raster"] = koppen[0]
    elev = _tif_glob(os.path.join(aux_dir, "elevation"))
    if elev:
        kw["elevation_raster"] = elev[0]
    pop = _tif_glob(os.path.join(aux_dir, "pop_density"))
    if pop:
        kw["population_raster"] = pop[0]
    tavg = _tif_glob(os.path.join(aux_dir, "worldclim", "tavg"))
    if tavg:
        kw["worldclim_tavg"] = tavg
    prec = _tif_glob(os.path.join(aux_dir, "worldclim", "prec"))
    if prec:
        kw["worldclim_prec"] = prec
    driving = os.path.join(aux_dir, "driving_side.json")
    if os.path.exists(driving):
        with open(driving) as f:
            kw["driving_side"] = json.load(f)

    if not kw:
        return None
    logger.info("augmentor sources under %s: %s", aux_dir,
                sorted(kw.keys()))
    return GeoAugmentor(**kw)
