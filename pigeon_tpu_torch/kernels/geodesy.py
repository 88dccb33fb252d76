"""Haversine label smoothing (kernel K10), for the H100.

Replaces `pigeon_tpu/kernels/geodesy.py::_smooth_kernel` (launcher
`smooth_labels_from_points`): labels ``(B, 2)`` and geocell centroids
``(C, 2)``, (lon, lat) degrees -> soft targets ``exp((min_c d - d) / tau)``
``(B, C)`` f32, once per training or eval batch. The kernel is CUDA C++
for ``sm_90a`` in `csrc/smooth_labels.cu`: one launch of 8-CTA clusters,
each row spread over a cluster's CTAs, its minimum reduced through
distributed shared memory. It is built by ``nvcc`` at first use and bound
with ``ctypes`` like the attention kernels; its source note says what
bounds it on the card. :func:`launch_plan` chooses how the grid covers
(B, C).

A CPU tensor runs :func:`smooth_labels_reference` (the plain PyTorch
version); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pigeon_tpu_torch import native
from pigeon_tpu_torch.core.geodesy import haversine_matrix
from pigeon_tpu_torch.core.scoring import smooth_labels


def smooth_labels_reference(labels, geocells, tau_km: float = 75.0):
    """Plain PyTorch K10: ``smooth_labels(haversine_matrix(labels,
    geocells), tau_km)``."""
    return smooth_labels(haversine_matrix(labels, geocells), tau_km)


#: CTAs a cluster: each takes a slice of ceil(C / CLUSTER) cells of every
#: row of its cluster's tile (`csrc/smooth_labels.cu`).
CLUSTER = 8
#: Threads a CTA at most (the kernel's launch bound).
MAX_THREADS = 512
#: Label rows a cluster: the kernel's instances.
ROWS = (8, 4, 2, 1)
#: SMs of an H100 SXM, `launch_plan`'s default, and threads an SM holds.
H100_SMS = 132
SM_THREADS = 2048


class LaunchPlan(NamedTuple):
    """How the kernel covers (B, C): ``tiles`` clusters of ``rows`` label
    rows (the last one ragged), each CTA ``slice`` cells in chunks of
    ``threads``, one cell a thread."""

    rows: int
    threads: int
    tiles: int
    slice: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, num_cells: int, sms: int = H100_SMS
                ) -> LaunchPlan:
    """The block that covers a CTA's slice one cell a thread in whole
    warps (at least two, at most `MAX_THREADS`: a longer slice loops over
    chunks), then the fewest rows a cluster whose grid the card holds at
    once (``sms`` SMs of `SM_THREADS` threads): a thread's rows run one
    after another, so fewer rows a thread are faster while the CTAs fit
    (B = 8: one row, 64 CTAs; B = 256: four rows, 512 CTAs of 288
    threads), 8 where none fits."""
    slice_ = _cdiv(num_cells, CLUSTER)
    threads = min(MAX_THREADS, max(64, _cdiv(slice_, 32) * 32))
    resident = sms * (SM_THREADS // threads)
    rows = next((r for r in reversed(ROWS)
                 if _cdiv(batch, r) * CLUSTER <= resident), ROWS[0])
    return LaunchPlan(rows, threads, _cdiv(batch, rows), slice_)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(native.build_cuda("smooth_labels").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pigeon_smooth_labels.argtypes = [ptr, ptr, ptr, i32, i32,
                                         ctypes.c_float, i32, i32, ptr]
    lib.pigeon_smooth_labels.restype = ctypes.c_int
    lib.pigeon_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigeon_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_points(name: str, t, device) -> None:
    if t.dim() != 2 or t.shape[1] != 2 or t.shape[0] < 1:
        raise ValueError(f"{name} must be (N, 2) (lon, lat), got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes f32")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, labels on {device}")
    if not t.is_contiguous() or t.data_ptr() % 8:
        raise ValueError(f"{name} is not contiguous and 8-byte aligned")


#: The key of the last centroid table that passed the checks: the same
#: table (one tensor for a whole run) is not checked again.
_checked_table = [None]


def _check_operands(labels, geocells, tau_km: float):
    """Raise on what the kernel cannot take. The labels are checked every
    call; the centroid table only when its data pointer, shape, stride,
    dtype or device, or the labels' device, differ from the last table
    that passed."""
    device = labels.device
    _check_points("labels", labels, device)
    key = (geocells.data_ptr(), geocells.shape, geocells.stride(),
           geocells.dtype, geocells.device, device)
    if key != _checked_table[0]:
        _check_points("geocells", geocells, device)
        _checked_table[0] = key
    if not tau_km > 0:
        raise ValueError(f"tau_km={tau_km} must be positive")


def smooth_labels_from_points(labels, geocells, tau_km: float = 75.0):
    """K10: ``(B, 2) x (C, 2) -> (B, C)`` smoothed geocell targets.

    CPU tensors run the plain version; CUDA tensors (f32, contiguous)
    launch the kernel on PyTorch's current stream and count the launch in
    ``smooth_labels_from_points.launches``; any other device raises. The
    output is a new tensor every call: the loss keeps it for its backward.
    """
    device = labels.device
    if device.type == "cpu":
        return smooth_labels_reference(labels, geocells, tau_km)
    if device.type != "cuda":
        raise ValueError(f"smooth_labels_from_points: no kernel for "
                         f"{device}")
    lib = load()
    _check_operands(labels, geocells, tau_km)
    batch, num_cells = labels.shape[0], geocells.shape[0]
    index = device.index
    plan = launch_plan(batch, num_cells, _sm_count(index))
    out = torch.empty((batch, num_cells), dtype=torch.float32, device=device)
    args = (labels.data_ptr(), geocells.data_ptr(), out.data_ptr(), batch,
            num_cells, float(tau_km), plan.rows, plan.threads,
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        rc = lib.pigeon_smooth_labels(*args)
    else:
        with torch.cuda.device(index):
            rc = lib.pigeon_smooth_labels(*args)
    if rc != 0:
        raise RuntimeError(
            "smooth_labels_from_points launch failed: "
            f"{lib.pigeon_cuda_error_string(rc).decode()} (CUDA error {rc})")
    smooth_labels_from_points.launches += 1
    return out


smooth_labels_from_points.launches = 0
