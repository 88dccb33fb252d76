"""Prototype dataset builder: per-geocell OPTICS location clusters.

Counterpart of `pigeon_tpu/geocell/prototypes.py`, the same rows for the
same metadata: OPTICS runs the port's own graph and xi extraction
(`geocell/optics.py`), a cell above 512 points its haversine matrix in
the port's C++ geo kernels where they build.

Rebuilds `dataset_creation/prototype/prototype.py:37-179`: group training
points by geocell, OPTICS-cluster each cell's points on the precomputed
pairwise haversine matrix (zeros clamped to 1e-5 exactly as the reference
does), keep non-noise clusters, and emit one row per cluster:
``geocell_idx, cluster, lng, lat, count, indices`` — the schema consumed by
`pigeon_tpu_torch.models.refiner.build_proto_bank`.

Differences vs the reference: cells smaller than ``min_samples`` become a
single cluster 0 (reference behavior, `prototype.py:141-144`); the work is
parallelized with a process pool sized to the host (the reference hardcodes
64 pandarallel workers).
"""

from __future__ import annotations

import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from pigeon_tpu_torch.core.geodesy import haversine_matrix_np
from pigeon_tpu_torch.geocell import geokernels
from pigeon_tpu_torch.geocell.optics import optics_xi_labels

DEFAULT_CLUSTER_ARGS = (5, 0.05)


def _cluster_cell(points: np.ndarray,
                  cluster_args: Tuple[int, float]) -> np.ndarray:
    """OPTICS labels for one cell's points (precomputed haversine)."""
    min_samples, xi = cluster_args
    if len(points) < min_samples:
        return np.zeros(len(points), np.int64)
    if len(points) > 512 and geokernels.available():
        distances = geokernels.haversine_matrix(points, points)
    else:
        distances = haversine_matrix_np(points, points)
    distances = np.where(distances == 0, 1e-5, distances)
    return optics_xi_labels(distances, min_samples, xi, precomputed=True)


def _cell_job(args):
    cell_idx, points, row_indices, cluster_args = args
    labels = _cluster_cell(points, cluster_args)
    rows = []
    for cluster in np.unique(labels):
        if cluster == -1:       # noise clusters are dropped (:146)
            continue
        mask = labels == cluster
        rows.append({
            "geocell_idx": int(cell_idx),
            "cluster": int(cluster),
            "lng": float(points[mask, 0].mean()),
            "lat": float(points[mask, 1].mean()),
            "count": int(mask.sum()),
            "indices": json.dumps([int(i) for i in row_indices[mask]]),
        })
    return rows


def build_prototypes(df: pd.DataFrame,
                     cluster_args: Tuple[int, float] = DEFAULT_CLUSTER_ARGS,
                     output_csv: Optional[str] = None,
                     num_workers: Optional[int] = None,
                     cell_column: str = "geocell_idx") -> pd.DataFrame:
    """Build the per-cluster prototype table.

    Args:
        df: training metadata with ``lng``, ``lat`` and a geocell index
            column (and optionally ``selection`` — only 'train' rows are
            used). Row POSITION within the filtered frame is the index
            recorded in ``indices`` (it must match the embedding bank's
            row order).
        cluster_args: OPTICS ``(min_samples, xi)``.
        output_csv: optional path to write the CSV.
        num_workers: process-pool size (None: os.cpu_count()).

    Returns:
        DataFrame with columns geocell_idx, cluster, lng, lat, count,
        indices (JSON string).
    """
    if "selection" in df.columns:
        df = df[df["selection"] == "train"]
    df = df.reset_index(drop=True)

    jobs = []
    for cell_idx, group in df.groupby(cell_column):
        pts = group[["lng", "lat"]].to_numpy(np.float64)
        jobs.append((cell_idx, pts, group.index.to_numpy(), cluster_args))

    all_rows: List[Dict] = []
    if num_workers == 0 or len(jobs) < 4:
        for job in jobs:
            all_rows.extend(_cell_job(job))
    else:
        # spawn, not fork (torch threads in the parent; reference
        # run.py:192)
        with ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            for rows in pool.map(_cell_job, jobs, chunksize=8):
                all_rows.extend(rows)

    out = pd.DataFrame(
        all_rows, columns=["geocell_idx", "cluster", "lng", "lat", "count",
                           "indices"])
    if output_csv:
        out.to_csv(output_csv, index=False)
    return out


def load_prototypes_csv(path: str) -> List[Dict]:
    """Load a prototype CSV into `build_proto_bank`-ready rows."""
    df = pd.read_csv(path)
    return df.to_dict("records")
