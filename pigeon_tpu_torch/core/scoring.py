"""Label smoothing and GeoGuessr scoring.

Counterpart of `pigeon_tpu/core/scoring.py`: haversine label smoothing
and cyclic month smoothing in torch (the training targets), and the
float64 GeoGuessr score in numpy (the metrics).
"""

from __future__ import annotations

import numpy as np
import torch

from pigeon_tpu_torch.config import GEOGUESSR_DECAY_KM, GEOGUESSR_MAX_SCORE


def smooth_labels(distances: torch.Tensor, tau_km: float = 75.0
                  ) -> torch.Tensor:
    """``(..., C)`` km -> ``exp(-(d - min_c d) / tau)``: the nearest cell
    gets 1.0. Unnormalised, as the loss contract wants (reference
    `preprocessing/utils.py:7-19`)."""
    adj = distances - distances.amin(-1, keepdim=True)
    return torch.nan_to_num(torch.exp(-adj / tau_km), nan=0.0, posinf=0.0,
                            neginf=0.0)


def smooth_month_labels(month_labels: torch.Tensor, num_months: int = 12,
                        tau: float = 0.3) -> torch.Tensor:
    """``(...,)`` month indices -> ``(..., num_months)`` targets
    ``exp(-circular_distance / tau)``, max entry 1.0."""
    months = torch.arange(num_months, device=month_labels.device)
    diff = (month_labels[..., None] - months).abs()
    circ = torch.minimum(diff, num_months - diff)
    return torch.exp(-circ / tau)


def geoguessr_score_np(distances_km: np.ndarray) -> float:
    """Mean GeoGuessr score ``mean(round(5000 exp(-d / 1492.7)))`` in
    float64 (reference `evaluation/metrics.py:103-115`)."""
    d = np.asarray(distances_km, dtype=np.float64)
    return float(np.mean(np.round(
        GEOGUESSR_MAX_SCORE * np.exp(-d / GEOGUESSR_DECAY_KM))))
