"""CSV-driven image datasets and threaded batching for training.

Counterpart of `pigeon_tpu/data/pipeline.py` (`TabularImageDataset`,
`iter_batches`) with the same schema: metadata columns ``image``
(+ ``image_2..image_4`` for panoramas), ``lng``, ``lat``, ``selection``,
the six `MT_COLUMNS`, ``climate_zone_idx``, ``heading`` (degrees),
``month`` (0-11) and an optional ``geocell_idx``. Pixels stay uint8
(decode + resize + centre crop on host threads); normalisation happens
on the device. Images are decoded by PIL with the JAX pipeline's draft
mode; the native JPEG decoder is not used here.

`iter_batches` shuffles with the same numpy generator and seed as the
JAX package, so both see the same batches, and re-raises a producer's
exception (a corrupt image) in the consumer instead of ending the epoch
early.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence

import numpy as np
import pandas as pd

from pigeon_tpu_torch.data.image_ops import heading_to_sincos, resize_crop_pil

MT_COLUMNS = ("elevation", "population", "temp_avg", "temp_diff",
              "prec_avg", "prec_diff")
#: Decode threads, and batches the producer may run ahead of the consumer.
NUM_WORKERS, PREFETCH = 16, 2


class TabularImageDataset:
    """Rows of a metadata frame, with their images loaded lazily."""

    def __init__(self, df: pd.DataFrame, image_dir: str = "",
                 image_size: int = 336, panorama: bool = False):
        self.df = df.reset_index(drop=True)
        self.image_dir = image_dir
        self.image_size = image_size
        self.panorama = panorama

    def __len__(self) -> int:
        return len(self.df.index)

    @property
    def image_columns(self) -> Sequence[str]:
        if self.panorama:
            return ("image", "image_2", "image_3", "image_4")
        return ("image",)

    def load_pixels(self, row) -> np.ndarray:
        """One sample's views: ``(S, S, 3)`` or ``(4, S, S, 3)`` uint8."""
        from PIL import Image

        views = []
        for col in self.image_columns:
            with Image.open(os.path.join(self.image_dir, str(row[col]))) \
                    as im:
                im.draft("RGB", (self.image_size, self.image_size))
                views.append(resize_crop_pil(im, self.image_size))
        return np.stack(views) if self.panorama else views[0]

    def sample_arrays(self, row) -> Dict[str, np.ndarray]:
        """The row's label arrays; each column is optional."""
        out = {}
        if "lng" in row.index and "lat" in row.index:
            out["labels"] = np.array([row["lng"], row["lat"]], np.float32)
        if "geocell_idx" in row.index:
            out["labels_clf"] = np.int32(row["geocell_idx"])
        elif "geocell_idx_yfcc" in row.index:
            out["labels_clf"] = np.int32(row["geocell_idx_yfcc"])
        if all(c in row.index for c in MT_COLUMNS):
            out["labels_multi_task"] = np.array(
                [row[c] for c in MT_COLUMNS], np.float32)
        if "climate_zone_idx" in row.index:
            out["labels_climate"] = np.int32(row["climate_zone_idx"])
        if "month" in row.index and not pd.isna(row["month"]):
            out["labels_month"] = np.int32(row["month"])
        if "heading" in row.index and not pd.isna(row["heading"]):
            out["heading"] = heading_to_sincos(float(row["heading"]))
        return out


def iter_batches(dataset: TabularImageDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of stacked numpy arrays; decode runs on a thread pool and
    a bounded queue keeps up to `PREFETCH` batches ahead of the
    consumer."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    bounds = range(0, n - batch_size + 1 if drop_last else n, batch_size)
    pool = ThreadPoolExecutor(max_workers=NUM_WORKERS)
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    done = object()

    def build_batch(idx: np.ndarray) -> Dict[str, np.ndarray]:
        rows = [dataset.df.iloc[i] for i in idx]
        batch: Dict[str, list] = {
            "inputs": list(pool.map(dataset.load_pixels, rows))}
        for row in rows:
            for k, v in dataset.sample_arrays(row).items():
                batch.setdefault(k, []).append(v)
        # A key missing from some rows (NaN heading or month) is dropped.
        return {k: np.stack(v) for k, v in batch.items()
                if len(v) == len(rows)}

    def producer():
        # A decode failure ships through the queue and re-raises at the
        # consumer: the epoch must not end early and silently.
        try:
            for start in bounds:
                q.put(build_batch(order[start:start + batch_size]))
            q.put(done)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            q.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        thread.join(timeout=1.0)
        pool.shutdown(wait=False)
