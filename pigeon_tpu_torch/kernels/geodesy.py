"""Haversine label smoothing (kernel K10), for the H100.

Replaces `pigeon_tpu/kernels/geodesy.py::_smooth_kernel` (launcher
`smooth_labels_from_points`): labels ``(B, 2)`` and geocell centroids
``(C, 2)``, (lon, lat) degrees -> soft targets ``exp((min_c d - d) / tau)``
``(B, C)`` f32, once per training or eval batch. The kernel is CUDA C++
for ``sm_90a`` in `csrc/smooth_labels.cu`, built by ``nvcc`` at first use
and bound with ``ctypes`` like the attention kernels; its source note
says what bounds it on the card.

A CPU tensor runs :func:`smooth_labels_reference` (the plain PyTorch
version); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.core.geodesy import haversine_matrix
from pigeon_tpu_torch.core.scoring import smooth_labels


def smooth_labels_reference(labels, geocells, tau_km: float = 75.0):
    """Plain PyTorch K10: ``smooth_labels(haversine_matrix(labels,
    geocells), tau_km)``."""
    return smooth_labels(haversine_matrix(labels, geocells), tau_km)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("smooth_labels").path)
    ptr = ctypes.c_void_p
    lib.pigeon_smooth_labels.argtypes = [ptr, ptr, ptr, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_float, ptr]
    lib.pigeon_smooth_labels.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(labels, geocells, tau_km: float):
    for name, t in (("labels", labels), ("geocells", geocells)):
        if t.dim() != 2 or t.shape[1] != 2 or t.shape[0] < 1:
            raise ValueError(f"{name} must be (N, 2) (lon, lat), got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes f32")
        if t.device != labels.device:
            raise ValueError(f"{name} on {t.device}, labels on "
                             f"{labels.device}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} is not contiguous and 8-byte aligned")
    if not tau_km > 0:
        raise ValueError(f"tau_km={tau_km} must be positive")


def smooth_labels_from_points(labels, geocells, tau_km: float = 75.0):
    """K10: ``(B, 2) x (C, 2) -> (B, C)`` smoothed geocell targets.

    CPU tensors run the plain version; CUDA tensors (f32, contiguous)
    launch the kernel on PyTorch's current stream and count the launch in
    ``smooth_labels_from_points.launches``; any other device raises.
    """
    if labels.device.type == "cpu":
        return smooth_labels_reference(labels, geocells, tau_km)
    if labels.device.type != "cuda":
        raise ValueError(f"smooth_labels_from_points: no kernel for "
                         f"{labels.device}")
    lib = load()
    _check_operands(labels, geocells, tau_km)
    out = torch.empty((labels.shape[0], geocells.shape[0]),
                      dtype=torch.float32, device=labels.device)
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        rc = lib.pigeon_smooth_labels(
            labels.data_ptr(), geocells.data_ptr(), out.data_ptr(),
            labels.shape[0], geocells.shape[0], float(tau_km), stream)
    if rc != 0:
        raise RuntimeError(
            "smooth_labels_from_points launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    smooth_labels_from_points.launches += 1
    return out


smooth_labels_from_points.launches = 0
