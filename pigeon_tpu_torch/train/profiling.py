"""Profiling: a step window of the training loop, one-off captures and a
summary of the trace, on `torch.profiler`.

Counterpart of `pigeon_tpu/train/profiling.py` and the JAX loop's
``ProfilerWindow``. A window writes a Chrome trace,
``<dir>/<host>_<pid>.<ms>.pt.trace.json``, that TensorBoard and
``chrome://tracing`` load and `summarize_trace` reads without either.

The summary groups the device kernels (``cat`` ``kernel``, and memory
copies and sets) by name. torch.profiler has been seen to keep no kernel
records for a window late in a long process (`PERF.md`): the summary
then raises `NoDeviceRecords`, and `print_trace_summary` says so, rather
than report the window as zero device time.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import socket
import time
from typing import Callable, List, Optional, Tuple

import torch

#: Trace event categories that are device work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class NoDeviceRecords(ValueError):
    """A trace holds no device record: the profiler kept none, or nothing
    ran on a device."""


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(trace_dir: str) -> str:
    os.makedirs(trace_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}"
    return os.path.join(trace_dir, f"{name}.pt.trace.json")


class ProfilerWindow:
    """A torch.profiler trace over steps ``wait`` to ``wait + active`` of
    a loop that calls `step` once a step (the JAX loop's window, wait 4
    and active 10; the reference's torch.profiler schedule). Nothing
    happens without ``log_dir``."""

    def __init__(self, log_dir: Optional[str], wait: int = 4,
                 active: int = 10):
        self.log_dir = log_dir
        self.wait = wait
        self.active = active
        self._prof = None
        self._step = 0
        #: The trace file written, once the window has closed.
        self.path: Optional[str] = None

    def step(self) -> None:
        if self.log_dir is None:
            return
        if self._step == self.wait:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
        if self._step == self.wait + self.active:
            self.close()
        self._step += 1

    def close(self) -> None:
        """Stop a running window and write its trace."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.path = _trace_path(self.log_dir)
        prof.export_chrome_trace(self.path)


def capture_trace(fn: Callable, trace_dir: str, steps: int = 3) -> str:
    """Run ``fn()`` ``steps`` times under torch.profiler and write the
    trace under ``trace_dir``; returns ``trace_dir``."""
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(steps):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(_trace_path(trace_dir))
    return trace_dir


def _load_events(trace_dir: str) -> List[dict]:
    """The complete (``ph`` X) events of the newest trace under
    ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if not paths:
        raise FileNotFoundError(f"no trace files under {trace_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("dur")]


def summarize_trace(trace_dir: str, top: int = 15,
                    include_host: bool = False
                    ) -> List[Tuple[str, float, float]]:
    """The newest trace's events by name: ``[(name, total_ms, percent),
    ...]``, the largest first. By default the device kernels alone, and
    `NoDeviceRecords` where there are none; ``include_host`` adds the
    host's operator events (``cpu_op``)."""
    cats = DEVICE_CATEGORIES + (("cpu_op",) if include_host else ())
    agg: collections.Counter = collections.Counter()
    for e in _load_events(trace_dir):
        if e.get("cat") in cats:
            agg[e["name"]] += e["dur"]
    if not include_host and not agg:
        raise NoDeviceRecords(f"the trace under {trace_dir} holds no device "
                              "records")
    total = sum(agg.values()) or 1.0
    return [(name, dur / 1e3, 100.0 * dur / total)
            for name, dur in agg.most_common(top)]


def print_trace_summary(trace_dir: str, top: int = 15) -> None:
    try:
        rows = summarize_trace(trace_dir, top)
    except NoDeviceRecords as err:
        print(f"device op-time: not measured ({err})")
        return
    total = sum(r[1] for r in rows)
    print(f"device op-time (top {top}, {total:.1f} ms total):")
    for name, ms, pct in rows:
        print(f"  {ms:9.1f} ms  {pct:5.1f}%  {name[:80]}")
