"""The evaluation metric suite, in float64 numpy on the host.

Counterpart of `pigeon_tpu/train/metrics.py` with the reference's metric
names (`evaluation/metrics.py:139-202`) in the JAX suite's order: the
distance errors and radii, the GeoGuessr score, ``Country_accuracy``
(with a `CountryIndex`), the geocell accuracies, the multi-task errors in
physical units (with a `RegressionScaler`), then climate and month. A key
whose inputs are missing is left out, as there.

``Geocell_top5_accuracy`` is taken over every column of ``topk_cells``:
under `train.evaluate.EVAL_NUM_CANDIDATES` that is the top 50, as in the
JAX suite.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from pigeon_tpu_torch.core.geodesy import haversine_np
from pigeon_tpu_torch.geocell.boundaries import (
    COUNTRY_NAME_KEYS,
    BoundarySet,
    points_in_polygon,
)
from pigeon_tpu_torch.core.scoring import geoguessr_score_np

RADII_KM = (1, 5, 10, 25, 50, 100, 200, 750, 1000, 2500)
#: The multi-task regression columns, in order.
MT_VARIABLES = ("elevation", "population", "temp_avg", "temp_diff",
                "prec_avg", "prec_diff")
#: The metric name of each multi-task column's mean absolute error.
MT_ERROR_KEYS = ("Mean_elevation_error", "Mean_population_error",
                 "Mean_temperature_error", "Mean_temp_diff_error",
                 "Mean_precipitation_error", "Mean_prec_diff_error")
#: Columns stored as ``log(x + offset)``, and the offsets of all six
#: (the elevation's is the scaler's own).
_LOG_COLUMNS = [0, 1, 3, 4, 5]


def _offsets(elevation_offset: float) -> np.ndarray:
    return np.array([elevation_offset, 1, 0, 1, 1, 1], np.float64)


class RegressionScaler:
    """Standardised ``log(x + offset)`` (``temp_avg`` not logged) for the
    six multi-task targets, stored as JSON (the reference pickles an
    sklearn scaler, `evaluation/metrics.py:42-54`); `inverse` takes
    scaled outputs back to physical units."""

    def __init__(self, mean: Sequence[float], scale: Sequence[float],
                 elevation_offset: float = 408.0):
        self.mean = np.asarray(mean, np.float64)
        self.scale = np.asarray(scale, np.float64)
        self.elevation_offset = float(elevation_offset)

    @classmethod
    def fit(cls, raw_values: np.ndarray,
            elevation_offset: float = 408.0) -> "RegressionScaler":
        """Fit from raw multi-task values ``(N, 6)``."""
        t = cls._forward(raw_values, elevation_offset)
        return cls(t.mean(0), t.std(0) + 1e-12, elevation_offset)

    @staticmethod
    def _forward(values: np.ndarray, elevation_offset: float) -> np.ndarray:
        v = np.asarray(values, np.float64) + _offsets(elevation_offset)
        v[:, _LOG_COLUMNS] = np.log(np.maximum(v[:, _LOG_COLUMNS], 1e-12))
        return v

    def transform(self, raw_values: np.ndarray) -> np.ndarray:
        return (self._forward(raw_values, self.elevation_offset)
                - self.mean) / self.scale

    def inverse(self, scaled: np.ndarray) -> np.ndarray:
        """Scaled model outputs -> physical units."""
        v = np.asarray(scaled, np.float64) * self.scale + self.mean
        with np.errstate(over="ignore"):   # untrained outputs may overflow
            v[:, _LOG_COLUMNS] = np.exp(v[:, _LOG_COLUMNS])
        return v - _offsets(self.elevation_offset)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"mean": self.mean.tolist(),
                       "scale": self.scale.tolist(),
                       "elevation_offset": self.elevation_offset}, f)

    @classmethod
    def load(cls, path: str) -> "RegressionScaler":
        with open(path) as f:
            d = json.load(f)
        return cls(d["mean"], d["scale"], d["elevation_offset"])


class CountryIndex(BoundarySet):
    """Countries of a GeoJSON FeatureCollection (Polygon or MultiPolygon
    outer rings): a bounding-box prefilter, ray casting, and the nearest
    ring centroid for a point in no polygon (the reference's geopandas
    lookup with its nearest fallback, `evaluation/metrics.py:56-72`), on
    `geocell.boundaries.BoundarySet` with the rings as the file gives
    them and the names of ``name`` or ``ADMIN``
    (`pigeon_tpu/train/metrics.py::CountryIndex`)."""

    def __init__(self, geojson_path: str):
        base = BoundarySet.from_geojson(geojson_path, drop_closing=False,
                                        name_keys=COUNTRY_NAME_KEYS)
        super().__init__(base.rings, base.names)

    def country_of(self, points: np.ndarray) -> np.ndarray:
        """``(N, 2)`` (lon, lat) -> ``(N,)`` country indices, the first
        country containing each point, else the nearest centroid's."""
        return self.assign_with_nearest_fill(points)


def country_accuracy(pred_lla: np.ndarray, label_lla: np.ndarray,
                     index: CountryIndex) -> float:
    """The share of predictions inside the label's country: the label's
    country with the nearest fallback, the prediction strictly contained
    (`evaluation/metrics.py:74-88`)."""
    label_countries = index.country_of(label_lla)
    pred_lla = np.asarray(pred_lla, np.float64)
    correct = np.zeros(len(pred_lla), bool)
    for ci in np.unique(label_countries):
        rows = np.where(label_countries == ci)[0]
        hit = np.zeros(len(rows), bool)
        for ring in index.rings[ci]:
            hit |= points_in_polygon(pred_lla[rows], ring)
        correct[rows] = hit
    return float(correct.mean())


def compute_geoguessr_metrics(
    predictions: np.ndarray,
    labels: np.ndarray,
    cell_preds: Optional[np.ndarray] = None,
    cell_labels: Optional[np.ndarray] = None,
    topk_cells: Optional[np.ndarray] = None,
    preds_mt: Optional[np.ndarray] = None,
    labels_mt: Optional[np.ndarray] = None,
    preds_climate: Optional[np.ndarray] = None,
    labels_climate: Optional[np.ndarray] = None,
    preds_month: Optional[np.ndarray] = None,
    labels_month: Optional[np.ndarray] = None,
    scaler: Optional[RegressionScaler] = None,
    country_index: Optional[CountryIndex] = None,
) -> Dict[str, float]:
    """The full suite. ``predictions`` and ``labels`` are ``(N, 2)`` (lon,
    lat); cells ``(N,)`` indices (or one-hot labels), ``topk_cells``
    ``(N, k)``; ``preds_mt`` / ``labels_mt`` ``(N, 6)`` scaled values
    (their errors need ``scaler``); climate and month predictions are
    logits with integer labels."""
    predictions = np.asarray(predictions, np.float64)
    labels = np.asarray(labels, np.float64)
    distances = haversine_np(predictions, labels)

    out: Dict[str, float] = {
        "Mean_km_error": float(distances.mean()),
        "Median_km_error": float(np.median(distances)),
    }
    for r in RADII_KM:
        out[f"Under_{r}_km"] = float((distances < r).mean())
    out["Geoguessr_score"] = geoguessr_score_np(distances)

    if country_index is not None:
        out["Country_accuracy"] = country_accuracy(predictions, labels,
                                                   country_index)

    if cell_preds is not None and cell_labels is not None:
        cell_labels = np.asarray(cell_labels)
        if cell_labels.ndim > 1:       # one-hot -> indices
            cell_labels = cell_labels.argmax(-1)
        out["Geocell_accuracy"] = float(
            (np.asarray(cell_preds) == cell_labels).mean())
        if topk_cells is not None:
            out["Geocell_top5_accuracy"] = float(
                (np.asarray(topk_cells) == cell_labels[:, None])
                .any(-1).mean())

    if preds_mt is not None and labels_mt is not None and scaler is not None:
        p = scaler.inverse(preds_mt)
        lab = scaler.inverse(labels_mt)
        for i, key in enumerate(MT_ERROR_KEYS):
            out[key] = float(np.abs(lab[:, i] - p[:, i]).mean())

    if preds_climate is not None and labels_climate is not None:
        out["Climate_accuracy"] = float(
            (np.asarray(preds_climate).argmax(-1)
             == np.asarray(labels_climate)).mean())

    if preds_month is not None and labels_month is not None:
        out["Month_accuracy"] = float(
            (np.asarray(preds_month).argmax(-1)
             == np.asarray(labels_month)).mean())
    return out
