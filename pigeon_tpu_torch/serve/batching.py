"""Micro-batched serving: concurrent requests coalesced into one forward.

Counterpart of `pigeon_tpu/serve/batching.py::MicroBatcher`. Requests
queue; a collector thread takes the first, waits up to ``max_wait_ms``
for more, up to ``max_batch``, copies the n panoramas it has to the
card, pads them there with zero rows to the smallest bucket of a
power-of-two ladder that holds n, runs the serving forward (and the
refiner) once, and answers each request's future with its row. Every
bucket is a fixed batch shape: `warm` runs each before traffic, so
kernel builds and first launches are behind the server when the first
request comes. A padded row costs a forward of its own; the buckets keep
that to less than half of a dispatch.

The forward runs on the collector thread, under `make_serving_fn`'s
``torch.inference_mode`` (a decorator, so it holds on any thread). When a
batch fails, every future of that batch gets the exception and no row of
it is answered.

While a torch profiler runs, the collector records its spans
(`train.profiling`): ``serve.queue`` for each request, from `submit` to
its batch's staging; ``serve.batch`` for each batch (``fill``,
``bucket``), from its first request taken to its last answer, and inside
it ``serve.collect``, ``serve.stage`` (stacking, the copy to the card,
the pad), ``serve.forward`` and ``serve.refine`` (their launches) and
``serve.readback`` (with the wait for the card); ``serve.device`` holds
the card's elapsed time from the copy to the refiner's last launch.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch

from pigeon_tpu_torch.train import profiling


def bucket_ladder(max_batch: int, buckets: Optional[tuple] = None) -> tuple:
    """The batch shapes: ``buckets`` sorted and deduplicated, or the powers
    of two below ``max_batch`` and ``max_batch`` itself."""
    if buckets is None:
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(max_batch)
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    if not buckets:
        raise ValueError("buckets must be non-empty")
    return buckets


def _host(t: torch.Tensor) -> np.ndarray:
    """A result on the host; bf16 (which numpy lacks) as f32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class MicroBatcher:
    """Coalesce concurrent single-sample predictions into batched calls.

    Args:
        serve_fn: batched ``pixels (B, ...) -> dict of (B, ...) tensors``
            (`server.make_serving_fn`, or a loaded artifact's).
        refine_fn: optional batched refiner, run on the whole batch.
        max_batch: the largest batch; clamped to the largest bucket.
        max_wait_ms: how long the collector waits for more requests after
            the first of a batch arrives.
        buckets: the batch shapes; a fill of n runs at the smallest
            bucket >= n. Default: `bucket_ladder`.
    """

    def __init__(self, serve_fn: Callable,
                 refine_fn: Optional[Callable] = None,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 buckets: Optional[tuple] = None):
        self.serve_fn = serve_fn
        self.refine_fn = refine_fn
        self.buckets = bucket_ladder(int(max_batch), buckets)
        # A fill can never exceed the largest bucket: clamp, so that the
        # choice of a bucket is total.
        self.max_batch = min(int(max_batch), self.buckets[-1])
        self.max_wait = max_wait_ms / 1000.0
        #: The fill (requests) and bucket of each batch run, in order.
        self.fills: list = []
        self._requests = itertools.count()
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="micro-batcher")
        self._thread.start()

    @property
    def batches_run(self) -> int:
        return len(self.fills)

    @property
    def requests_served(self) -> int:
        return sum(n for n, _ in self.fills)

    def submit(self, pixels: np.ndarray) -> "Future":
        """Enqueue one sample (no batch dimension); the future resolves to
        its row: a dict of numpy arrays with ``pred_lla`` (2,) and the
        serving fields."""
        fut: Future = Future()
        # While a profiler runs, the request's number and queueing time
        # (its ``serve.queue`` span).
        stamp = ((next(self._requests), time.perf_counter_ns())
                 if profiling.tracing() else None)
        self._q.put((np.asarray(pixels), fut, stamp))
        return fut

    def predict_one(self, pixels: np.ndarray, timeout: float = 120.0):
        return self.submit(pixels).result(timeout=timeout)

    def warm(self, sample_shape, dtype=torch.uint8) -> None:
        """Run every bucket's forward (and the refiner) once before
        traffic, then wait for the card, so that kernel builds and first
        launches are done when the first request arrives."""
        device = None
        for bucket in self.buckets:
            out = self.serve_fn(torch.zeros((bucket, *sample_shape),
                                            dtype=dtype))
            if self.refine_fn is not None:
                self.refine_fn(out["embedding"], out["pred_lla"],
                               out["topk_cells"], out["topk_probs"])
            device = out["pred_lla"].device
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)           # wake the collector
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _collect(self, first) -> list:
        """Take more requests after ``first`` until the batch is full or
        ``max_wait`` has passed since ``first`` was taken."""
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _loop(self):
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            with profiling.span("serve.batch") as batch:
                with profiling.span("serve.collect"):
                    items = self._collect(first)
                try:
                    self._run(items, batch)
                except Exception as e:  # noqa: BLE001 — each request's error
                    for _, fut, _ in items:
                        if not fut.done():
                            fut.set_exception(e)

    def _run(self, items: list, batch) -> None:
        """One batch: stage it on the card, run the forward and the
        refiner, read the rows back and answer each request's future."""
        n = len(items)
        bucket = next(b for b in self.buckets if b >= n)
        batch.set(fill=n, bucket=bucket)
        with contextlib.ExitStack() as on_card:
            with profiling.span("serve.stage") as stage:
                if stage:
                    # Each request's queue wait ends as its batch is staged.
                    for _, _, stamp in items:
                        if stamp is not None:
                            profiling.record("serve.queue", stamp[1],
                                             stage.start_ns,
                                             request=stamp[0],
                                             batch=batch.id)
                pixels = torch.from_numpy(np.stack([p for p, _, _ in items]))
                # The card's elapsed time, from the copy to the
                # refiner's last launch.
                on_card.enter_context(profiling.span(
                    "serve.device", device=True, parent=batch.id))
                # serve_fn.device: set by make_serving_fn and the artifact
                # loader.
                device = getattr(self.serve_fn, "device", None)
                if device is not None:
                    pixels = pixels.to(device)
                if n < bucket:
                    # n rows cross to the card, the zero rows are made
                    # there: each bucket is one fixed batch shape.
                    pad = torch.zeros((bucket - n, *pixels.shape[1:]),
                                      dtype=pixels.dtype,
                                      device=pixels.device)
                    pixels = torch.cat([pixels, pad])
            with profiling.span("serve.forward"):
                out = self.serve_fn(pixels)
            if self.refine_fn is not None:
                with profiling.span("serve.refine"):
                    refined = self.refine_fn(
                        out["embedding"], out["pred_lla"],
                        out["topk_cells"], out["topk_probs"])
                out = dict(out, pred_lla=refined["pred_lla"],
                           pred_cell=refined.get("pred_cell"))
        with profiling.span("serve.readback"):
            rows = {k: _host(v[:n]) for k, v in out.items() if v is not None}
        self.fills.append((n, bucket))
        for i, (_, fut, _) in enumerate(items):
            fut.set_result({k: v[i] for k, v in rows.items()})
