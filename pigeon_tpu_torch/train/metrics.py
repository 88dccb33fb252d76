"""The evaluation metric suite, in float64 numpy on the host.

Counterpart of `pigeon_tpu/train/metrics.py::compute_geoguessr_metrics`
with the reference's metric names (`evaluation/metrics.py:139-202`). The
multi-task errors in physical units (`RegressionScaler`) and the country
accuracy (`CountryIndex`) are not ported yet; without them the JAX suite
leaves those keys out too.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pigeon_tpu_torch.core.geodesy import haversine_np
from pigeon_tpu_torch.core.scoring import geoguessr_score_np

RADII_KM = (1, 5, 10, 25, 50, 100, 200, 750, 1000, 2500)


def compute_geoguessr_metrics(
    predictions: np.ndarray,
    labels: np.ndarray,
    cell_preds: Optional[np.ndarray] = None,
    cell_labels: Optional[np.ndarray] = None,
    topk_cells: Optional[np.ndarray] = None,
    preds_climate: Optional[np.ndarray] = None,
    labels_climate: Optional[np.ndarray] = None,
    preds_month: Optional[np.ndarray] = None,
    labels_month: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Distance, score, geocell, climate and month metrics.

    ``predictions`` and ``labels`` are ``(N, 2)`` (lon, lat); cells are
    ``(N,)`` indices (or one-hot labels) and ``topk_cells`` ``(N, k)``;
    climate and month predictions are logits.
    """
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

    if preds_climate is not None and labels_climate is not None:
        out["Climate_accuracy"] = float(
            (np.asarray(preds_climate).argmax(-1)
             == np.asarray(labels_climate)).mean())

    if preds_month is not None and labels_month is not None:
        out["Month_accuracy"] = float(
            (np.asarray(preds_month).argmax(-1)
             == np.asarray(labels_month)).mean())
    return out
