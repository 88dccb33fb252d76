"""CSV-driven image datasets and threaded batching for training.

Counterpart of `pigeon_tpu/data/pipeline.py` (`TabularImageDataset`,
`iter_batches`) with the same schema: metadata columns ``image``
(+ ``image_2..image_4`` for panoramas), ``lng``, ``lat``, ``selection``,
the six `MT_COLUMNS`, ``climate_zone_idx``, ``heading`` (degrees),
``month`` (0-11) and an optional ``geocell_idx``. Pixels stay uint8
(decode + resize + centre crop on host threads); normalisation happens
on the device. A JPEG is decoded by the native decoder
(`data/native_decode.py`) where it builds, as the JAX pipeline's
uint8 path does; any other image, or a JPEG it refuses, by PIL with the
JAX pipeline's draft mode.

`BenchmarkDataset` reads a benchmark from the registry JSON
(``{name: {"meta": csv, "images": dir}}``, paths relative to the
registry), `holdout` takes a slice of a dataset's rows.

`iter_batches` shuffles with the same numpy generator and seed as the
JAX package, so both see the same batches, and re-raises a producer's
exception (a corrupt image) in the consumer instead of ending the epoch
early.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

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

    @classmethod
    def from_csv(cls, csv_path: str, split: Optional[str] = None,
                 image_dir: str = "", image_size: int = 336,
                 panorama: bool = False) -> "TabularImageDataset":
        """The rows of ``csv_path`` whose ``selection`` is ``split`` (all
        rows without a split or without the column)."""
        df = pd.read_csv(csv_path)
        if split is not None and "selection" in df.columns:
            df = df[df["selection"] == split]
        return cls(df, image_dir, image_size, panorama)

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

        from pigeon_tpu_torch.data import native_decode

        views = []
        for col in self.image_columns:
            path = os.path.join(self.image_dir, str(row[col]))
            if (path.lower().endswith((".jpg", ".jpeg"))
                    and native_decode.available()):
                with open(path, "rb") as f:
                    # One image a call, on this decode thread.
                    arr = native_decode.decode_resize_crop_batch(
                        [f.read()], self.image_size, nthreads=1)[0]
                if arr is not None:
                    views.append(arr)
                    continue
            with Image.open(path) as im:
                im.draft("RGB", (self.image_size, self.image_size))
                views.append(resize_crop_pil(im, self.image_size))
        return np.stack(views) if self.panorama else views[0]

    def labels_lla(self) -> np.ndarray:
        """``(N, 2)`` (lng, lat) of every row, f32."""
        return self.df[["lng", "lat"]].to_numpy(dtype=np.float32)

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


class BenchmarkDataset(TabularImageDataset):
    """A single-image benchmark of the registry at ``registry_path``
    (`pigeon_tpu/data/pipeline.py::BenchmarkDataset`); the centre crop of
    the preprocessing is the benchmarks' square min-side crop."""

    def __init__(self, name: str, registry_path: str,
                 image_size: int = 336):
        with open(registry_path) as f:
            registry = json.load(f)
        if name not in registry:
            raise KeyError(f"benchmark {name!r} not registered; available: "
                           f"{sorted(registry)}")
        base = os.path.dirname(os.path.abspath(registry_path))
        meta, images = (os.path.join(base, registry[name][key])
                        for key in ("meta", "images"))
        super().__init__(pd.read_csv(meta), image_dir=images,
                         image_size=image_size, panorama=False)
        self.name = name


def holdout(dataset: TabularImageDataset, sl: slice) -> TabularImageDataset:
    """The rows ``sl`` of ``dataset`` as a dataset of their own."""
    return TabularImageDataset(dataset.df.iloc[sl],
                               image_dir=dataset.image_dir,
                               image_size=dataset.image_size,
                               panorama=dataset.panorama)


def iter_batches(dataset: TabularImageDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False,
                 select: Optional[Callable[[np.ndarray], np.ndarray]] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of stacked numpy arrays; decode runs on a thread pool and
    a bounded queue keeps up to `PREFETCH` batches ahead of the
    consumer. Closing the generator early (a calibration batch) stops
    the producer. ``select`` maps each batch's dataset rows to the rows
    this process loads (a rank's slice, `train/multihost.py`)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    bounds = range(0, n - batch_size + 1 if drop_last else n, batch_size)
    pool = ThreadPoolExecutor(max_workers=NUM_WORKERS)
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    done = object()
    stop = threading.Event()

    def build_batch(idx: np.ndarray) -> Dict[str, np.ndarray]:
        load = idx if select is None else select(idx)
        rows = [dataset.df.iloc[i] for i in load]
        batch: Dict[str, list] = {
            "inputs": list(pool.map(dataset.load_pixels, rows))}
        for row in rows:
            for k, v in dataset.sample_arrays(row).items():
                batch.setdefault(k, []).append(v)
        # A key missing from some rows (NaN heading or month) is dropped;
        # of a selection, where a row of the whole batch misses it.
        keep = [k for k, v in batch.items() if len(v) == len(rows)]
        if select is not None:
            for i in idx:
                present = dataset.sample_arrays(dataset.df.iloc[i])
                keep = [k for k in keep if k == "inputs" or k in present]
        return {k: np.stack(batch[k]) for k in keep}

    def producer():
        # A decode failure ships through the queue and re-raises at the
        # consumer: the epoch must not end early and silently.
        try:
            for start in bounds:
                if stop.is_set():
                    return
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
        # Drain the queue until the producer ends: it may be blocked on a
        # full queue, and sees `stop` before its next batch.
        stop.set()
        while thread.is_alive():
            with contextlib.suppress(queue.Empty):
                q.get(timeout=0.1)
        pool.shutdown(wait=False)
