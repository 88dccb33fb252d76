"""Haversine distances in torch.

Counterpart of `pigeon_tpu/core/geodesy.py::haversine` and
`haversine_matrix`: spherical haversine on the WGS84 equatorial radius,
points as ``(lon, lat)`` in degrees, distances in km. The refiner's
cancel gate, the hedge and the label smoothing need them; the metrics
need the float64 numpy twins (`haversine_np`, `haversine_matrix_np`).
"""

from __future__ import annotations

import numpy as np
import torch

#: Equatorial radius of the Earth in km (WGS84 semi-major axis), the
#: radius `pigeon_tpu.core.geodesy.EARTH_RADIUS_KM` uses.
EARTH_RADIUS_KM = 6378.137


def haversine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Distance in km between aligned ``(..., 2)`` (lon, lat) tensors."""
    x = torch.deg2rad(x)
    y = torch.deg2rad(y)
    dlon = y[..., 0] - x[..., 0]
    dlat = y[..., 1] - x[..., 1]
    a = (torch.sin(dlat / 2.0) ** 2
         + torch.cos(x[..., 1]) * torch.cos(y[..., 1])
         * torch.sin(dlon / 2.0) ** 2)
    # The clamp keeps sqrt/asin defined under rounding just outside [0, 1].
    return EARTH_RADIUS_KM * 2.0 * torch.asin(torch.sqrt(a.clamp(0.0, 1.0)))


def haversine_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All-pairs distances: ``(N, 2)`` x ``(M, 2)`` -> ``(N, M)`` km."""
    return haversine(x[..., :, None, :], y[..., None, :, :])


def haversine_np(x, y) -> np.ndarray:
    """Float64 numpy twin of :func:`haversine` for host-side metrics."""
    x = np.deg2rad(np.asarray(x, dtype=np.float64))
    y = np.deg2rad(np.asarray(y, dtype=np.float64))
    dlon = y[..., 0] - x[..., 0]
    dlat = y[..., 1] - x[..., 1]
    a = (np.sin(dlat / 2.0) ** 2
         + np.cos(x[..., 1]) * np.cos(y[..., 1]) * np.sin(dlon / 2.0) ** 2)
    return EARTH_RADIUS_KM * 2.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def haversine_matrix_np(x, y) -> np.ndarray:
    """Float64 numpy twin of :func:`haversine_matrix`: ``(N, 2)`` x
    ``(M, 2)`` -> ``(N, M)`` km."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return haversine_np(x[:, None, :], y[None, :, :])
