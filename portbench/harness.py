"""One run of one cell: set-up, the measured window, an optional traced
slice, the per-layer metrics, the check against the reference, and the
result line.

Everything is found by name under the benchmark's root: configurations
in ``configs/``, traffic mixes in ``traffic/`` (each names its driver,
a module of ``drivers/``), metrics in ``metrics/`` (every end-to-end
metric but ``setup_s``, which the harness times, and every per-layer
one) and the limits of each cell's check in ``limits/``. A driver is a class
``Driver(config, traffic, seed, device, fault=None, control=False)``
with ``setup()``, ``window(seconds)``, ``slice()``, ``release()`` and
``check()``; a metric module has ``read(run) -> float or None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
#: Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pigeon_tpu")
#: Traced slices tried before the rooflines are left out: the profiler
#: may keep fewer kernel records than the kernels launched.
TRACE_ATTEMPTS = 3


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    `FORBIDDEN_MODULES`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json``'s entries and the files they name, looked up
    under each of ``roots`` in turn (the benchmark's own directory by
    default)."""

    def __init__(self, spec: Optional[dict] = None, roots=(ROOT,)):
        self.spec = spec if spec is not None else _load_json(
            os.path.join(REPO, "BENCHMARK.json"))
        self.roots = tuple(roots)

    def path(self, kind: str, name: str) -> str:
        """The first ``<root>/<kind>/<name>`` that exists."""
        for root in self.roots:
            path = os.path.join(root, kind, name)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name} under {self.roots}")

    def workload(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in the benchmark")

    def config(self, name: str) -> dict:
        return _load_json(self.path("configs", f"{name}.json"))

    def traffic(self, name: str) -> dict:
        return _load_json(self.path("traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return _load_json(self.path("limits", f"{workload}.json"))

    def driver(self, traffic: dict):
        name = traffic["driver"]
        return _load_module(self.path("drivers", f"{name}.py"),
                            f"portbench_driver_{name}")

    def metric(self, name: str):
        return _load_module(self.path("metrics", f"{name}.py"),
                            f"portbench_metric_{name}")

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics read in ``workload``: those that list it,
        and those without a list that move a metric it reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


@dataclasses.dataclass
class RunRecord:
    """What a metric reads: the cell, its configuration and
    traffic, the window's counts and time, the traced slice's summary and
    the kernel calls it made, and the program's counters."""

    workload: dict
    config: dict
    traffic: dict
    window: dict
    trace: object = None
    calls: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)


#: The kernel group with one record a launch of each counted kernel.
_ONE_RECORD = {"K1": "K1 attention", "K2": "K2 dx GEMM"}


def traced_slice(drv) -> tuple:
    """Profile a short steady slice of the driver's loop. Returns the
    trace's summary, the kernel calls of the slice (``{kernel: [(shape,
    launches)]}``) and whether the trace holds a record of every launch;
    a slice whose records fall short is profiled again, up to
    `TRACE_ATTEMPTS` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.program import launches
    from portbench.yardstick import trace

    for _ in range(TRACE_ATTEMPTS):
        before = launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW_MARK):
                calls = drv.slice()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = trace.summarize(trace.load_events(path))
        finally:
            os.unlink(path)
        launched = {k: v - before[k] for k, v in launches().items()}
        whole = all(summary.group_records.get(_ONE_RECORD[k], 0) >= n
                    for k, n in launched.items())
        if whole:
            break
    return summary, calls, whole


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, fault: Optional[str] = None
             ) -> dict:
    """One run of ``workload``; returns the result line as a dict (its
    ``checks`` last). ``fault`` plants one of the driver's faults (the
    tests; the benchmark's runs take none)."""
    import torch

    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    cuda = torch.device(device).type == "cuda"
    drv = bench.driver(traffic).Driver(config, traffic, seed, device,
                                       fault=fault)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    guard_imports()
    win = drv.window(seconds)
    device_info = {"platform": "gpu" if cuda else torch.device(device).type,
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if cuda else 0)}
    counters = dict(win.get("counters", {}),
                    memory_peak_bytes=device_info["memory_peak_bytes"])
    record = RunRecord(cell, config, traffic, win, counters=counters)
    metrics, breakdown = {}, None
    if trace:
        summary, calls, whole = traced_slice(drv)
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        from portbench.yardstick.trace import breakdown as make_breakdown

        breakdown = make_breakdown(summary)
        record.trace, record.calls = summary, calls if whole else {}
        specs = bench.per_layer(workload)
    else:
        specs = [m for m in bench.end_to_end(workload)
                 if m["name"] != "setup_s"]
    for spec in specs:
        value = bench.metric(spec["name"]).read(record)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = drv.check()
    results = {name: {"value": value, "limit": limits[name]}
               for name, value in checks.items()}
    correct = (win["failed"] == 0 and set(checks) == set(limits)
               and all(_finite(r["value"]) and r["value"] <= r["limit"]
                       for r in results.values()))
    line = {"correct": correct, "attempted": win["attempted"],
            "failed": win["failed"], "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = results
    return line


class ForbiddenImport(RuntimeError):
    pass


def guard_imports() -> None:
    """Raise `ForbiddenImport` naming any loaded module of JAX or of the
    JAX package."""
    found = forbidden_modules()
    if found:
        raise ForbiddenImport("modules of JAX or the JAX package are "
                              f"loaded: {', '.join(found)}")
