"""Haversine distances and LLA <-> ECEF conversions in torch.

Counterpart of `pigeon_tpu/core/geodesy.py`: spherical haversine on the
WGS84 equatorial radius, points as ``(lon, lat)`` in degrees, distances
in km. The refiner's cancel gate, the hedge and the label smoothing need
them; the metrics need the float64 numpy twins (`haversine_np`,
`haversine_matrix_np`). `lla2ecef` and `ecef2lla` (Bowring's method, a
fixed 5 iterations) map surface points to and from WGS84 ECEF metres;
their numpy twins run in float64, `ecef2lla_np` in Heikkinen's closed
form with the reference's ``G``-term typo corrected, as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

#: Equatorial radius of the Earth in km (WGS84 semi-major axis), the
#: radius `pigeon_tpu.core.geodesy.EARTH_RADIUS_KM` uses.
EARTH_RADIUS_KM = 6378.137

#: WGS84: semi-major axis (m), flattening, semi-minor axis, first and
#: second eccentricity squared.
_A = EARTH_RADIUS_KM * 1000.0
_F = 1.0 / 298.257223563
_B = _A * (1.0 - _F)
_E_SQ = _F * (2.0 - _F)
_EP_SQ = (_A**2 - _B**2) / _B**2
_E2_DIFF = _A**2 - _B**2
#: Bowring iterations of `ecef2lla` (the reference's own cap).
_BOWRING_ITERS = 5


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


def lla2ecef(coords: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` (lon, lat) degrees -> ``(..., 3)`` ECEF metres of the
    surface point on the WGS84 ellipsoid, in the input's dtype."""
    rad = torch.deg2rad(coords)
    lon, lat = rad[..., 0], rad[..., 1]
    cos_lat, sin_lat = torch.cos(lat), torch.sin(lat)
    ff = (1.0 - _F) ** 2
    c = 1.0 / torch.sqrt(cos_lat**2 + ff * sin_lat**2)
    s = c * ff
    return torch.stack([(_A * c) * cos_lat * torch.cos(lon),
                        (_A * c) * cos_lat * torch.sin(lon),
                        (_A * s) * sin_lat], dim=-1)


def lla2ecef_np(coords) -> np.ndarray:
    """Float64 numpy twin of :func:`lla2ecef`."""
    rad = np.deg2rad(np.asarray(coords, dtype=np.float64))
    lon, lat = rad[..., 0], rad[..., 1]
    cos_lat, sin_lat = np.cos(lat), np.sin(lat)
    ff = (1.0 - _F) ** 2
    c = 1.0 / np.sqrt(cos_lat**2 + ff * sin_lat**2)
    s = c * ff
    return np.stack([(_A * c) * cos_lat * np.cos(lon),
                     (_A * c) * cos_lat * np.sin(lon),
                     (_A * s) * sin_lat], axis=-1)


def ecef2lla(coords: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` ECEF metres -> ``(..., 2)`` (lon, lat) degrees by
    Bowring's fixed-point solve for the parametric latitude, a fixed
    `_BOWRING_ITERS` iterations."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    lon = torch.atan2(y, x)
    rho = torch.sqrt(x**2 + y**2)
    ae2 = _A * _E_SQ
    bep2 = _B * _E_SQ / (1.0 - _E_SQ)
    # Bowring's starting value for the parametric latitude beta.
    r = torch.sqrt(rho**2 + z**2)
    u = _A * rho
    v = _B * z * (1.0 + bep2 / r)
    hyp = torch.sqrt(u**2 + v**2)
    cos_beta, sin_beta = u / hyp, v / hyp
    for _ in range(_BOWRING_ITERS):
        u = rho - ae2 * cos_beta**3
        v = z + bep2 * sin_beta**3
        au, bv = _A * u, _B * v
        hyp = torch.sqrt(au**2 + bv**2)
        cos_beta, sin_beta = au / hyp, bv / hyp
    lat = torch.atan2(v, u)
    return torch.stack([torch.rad2deg(lon), torch.rad2deg(lat)], dim=-1)


def ecef2lla_np(coords) -> np.ndarray:
    """Float64 ECEF -> (lon, lat) degrees in Heikkinen's closed form."""
    coords = np.asarray(coords, dtype=np.float64)
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    a, b, e_sq = _A, _B, _E_SQ
    r = np.sqrt(x**2 + y**2)
    f = 54.0 * b**2 * z**2
    g = r**2 + (1.0 - e_sq) * z**2 - e_sq * _E2_DIFF
    c = (e_sq**2) * f * r**2 / g**3
    s = np.cbrt(1.0 + c + np.sqrt(c**2 + 2.0 * c))
    p = f / (3.0 * (s + 1.0 / s + 1.0) ** 2 * g**2)
    q = np.sqrt(1.0 + 2.0 * e_sq**2 * p)
    r0 = (-(p * e_sq * r) / (1.0 + q)
          + np.sqrt(np.maximum(
              0.5 * a**2 * (1.0 + 1.0 / q)
              - p * (1.0 - e_sq) * z**2 / (q * (1.0 + q))
              - 0.5 * p * r**2, 0.0)))
    v = np.sqrt((r - e_sq * r0) ** 2 + (1.0 - e_sq) * z**2)
    z0 = b**2 * z / (a * v)
    lat = np.arctan((z + _EP_SQ * z0) / r)
    lon = np.arctan2(y, x)
    return np.stack([np.rad2deg(lon), np.rad2deg(lat)], axis=-1)
