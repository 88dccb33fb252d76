"""Profiling: a step window of the training loop, one-off captures, a
summary of the trace, and the program's own spans, on `torch.profiler`.

Counterpart of `pigeon_tpu/train/profiling.py` and the JAX loop's
``ProfilerWindow``. A window writes a Chrome trace,
``<dir>/<host>_<pid>.<ms>.pt.trace.json``, that TensorBoard and
``chrome://tracing`` load and `summarize_trace` reads without either.

The summary groups the device kernels (``cat`` ``kernel``, and memory
copies and sets) by name. torch.profiler has been seen to keep no kernel
records for a window late in a long process (`PERF.md`): the summary
then raises `NoDeviceRecords`, and `print_trace_summary` says so, rather
than report the window as zero device time.

Spans (`span`, `record`) time the program's own phases: the
micro-batcher's queue wait and batch phases, the train step's forward,
backward and optimizer, the embed step's copy. They are recorded exactly
while a torch profiler runs, on every thread, into a bounded ring that
`spans` reads and `drain` empties; off, a span costs one attribute read
and creates nothing. A span is also a ``record_function`` of its name,
so it lands in the profiler's trace on the profiler's clock (the
micro-batcher's thread too, where the profiler records every thread:
`ProfilerWindow` and `capture_trace` do). ``device=True`` adds a CUDA
event pair on the current stream, read as `Span.device_ms`: the card's
elapsed time across the work, idle gaps between its operations included.
"""

from __future__ import annotations

import collections
import glob
import itertools
import json
import os
import socket
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: Trace event categories that are device work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class NoDeviceRecords(ValueError):
    """A trace holds no device record: the profiler kept none, or nothing
    ran on a device."""


#: Spans kept, the newest last; a longer trace keeps its latest.
SPAN_CAPACITY = 1 << 16
_SPANS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_IDS = itertools.count(1)
_LOCAL = threading.local()


def tracing() -> bool:
    """Whether spans are recorded: exactly while a torch profiler runs
    (torch's own process-wide flag, set by every profiler it starts)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One timed phase: ``name``, its ``id``, the ``parent`` span's id
    (None for a root), host times ``start_ns`` and ``end_ns``
    (`time.perf_counter_ns`) and ``attrs``. Entered as a context manager
    it takes its parent from the innermost span open on its thread,
    unless one was given."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs",
                 "_device", "_events", "_device_ms", "_nested", "_mark")

    def __init__(self, name: str, parent: Optional[int] = None,
                 device: bool = False, attrs: Optional[dict] = None):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent
        self._nested = parent is None
        self.start_ns = self.end_ns = None
        self.attrs = attrs or {}
        self._device = device
        self._events = None
        self._device_ms = None
        self._mark = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        """Host milliseconds from start to end."""
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events on the device: the
        card's elapsed time from the first operation the span enqueued to
        its last, the card's idle gaps between them included (waits for
        the end event); None without events."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms

    def __enter__(self) -> "Span":
        # A span given its parent may be straddled by other spans of its
        # thread: it stays off the thread's stack, no parent of theirs.
        if self._nested:
            stack = _stack()
            if stack:
                self.parent = stack[-1].id
            stack.append(self)
        self._mark = torch.profiler.record_function(self.name)
        self._mark.__enter__()
        if self._device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._mark.__exit__(None, None, None)
        self._mark = None
        if self._nested:
            _stack().remove(self)
        _SPANS.append(self)


class _Off:
    """What `span` returns while no profiler runs: does nothing."""

    __slots__ = ()
    id = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, device: bool = False, parent: Optional[int] = None,
         **attrs):
    """A context manager timing work that begins and ends on one thread:
    a `Span` while a profiler runs, else a shared object that does
    nothing (falsy, like its ``id``). ``device``: CUDA events around the
    work, where CUDA is initialised. ``parent``: the causing span's id,
    for a span that other spans of its thread straddle; by default the
    innermost span open on the thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, parent, device, attrs)


def record(name: str, start_ns: int, end_ns: int,
           **attrs) -> Optional[Span]:
    """A span whose ends fall on different threads (a request's queue
    wait), from its `time.perf_counter_ns` times; nothing while no
    profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    s = Span(name, attrs=attrs)
    s.start_ns, s.end_ns = start_ns, end_ns
    _SPANS.append(s)
    return s


def spans(name: Optional[str] = None) -> List[Span]:
    """The recorded spans (of ``name``), in the order they ended."""
    return [s for s in list(_SPANS) if name is None or s.name == name]


def drain() -> List[Span]:
    """The recorded spans, in the order they ended, taken out of the
    ring: the next `spans` or `drain` holds only spans that end after
    this call."""
    out = []
    while True:
        try:
            out.append(_SPANS.popleft())
        except IndexError:
            return out


def _all_threads():
    """The profiler setting that records every thread's annotations, the
    micro-batcher's too."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


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
    and active 10; the reference's torch.profiler schedule), every
    thread's spans in it. Nothing happens without ``log_dir``."""

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
            self._prof = torch.profiler.profile(
                activities=_activities(), experimental_config=_all_threads())
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
    """Run ``fn()`` ``steps`` times under torch.profiler (every thread's
    spans) and write the trace under ``trace_dir``; returns
    ``trace_dir``."""
    with torch.profiler.profile(activities=_activities(),
                                experimental_config=_all_threads()) as prof:
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
