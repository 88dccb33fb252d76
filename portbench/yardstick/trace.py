"""The reduction of a `torch.profiler` Chrome trace to device time by
kernel group, the busy share of a window and its idle gaps.

The groups are the port's kernels by a substring of their CUDA function
names, the first match in this order (the port's own GEMM instances carry
their users' tags, so they come before the library's generic "gemm"),
then the library GEMMs, then everything else.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import NamedTuple

KERNEL_GROUPS = (
    ("K1 projection GEMM", "K1Projection"),
    ("K1 attention", "K1Attention"),
    ("K5 LN1", "K5LayerNorm"),
    ("K5 projection GEMM", "K5Projection"),
    ("K5 attention", "K5Attention"),
    ("K2 projection GEMM", "K2Projection"),
    ("K2 attention passes", "K2Attention"),
    ("K2 dx GEMM", "K2Dx"),
    ("K3'", "K3OnlineForward"),
    ("K3", "K3Forward"),
    ("K6 LN1", "K6LayerNorm"),
    ("K6 projection GEMM", "K6Projection"),
    ("K6 attention", "K6Attention"),
    ("K6 out-projection GEMM", "K6OutProjection"),
    ("K8 projection GEMM", "K8Projection"),
    ("K8 attention", "K8Attention"),
    ("K7 LN1", "K7LayerNorm"),
    ("K7 projection GEMM", "K7Projection"),
    ("K7 attention", "K7Attention"),
    ("K7 out-projection GEMM", "K7OutProjection"),
    ("K4 statistics", "flash_attention_bwd_stats"),
    ("K4 gradients", "flash_attention_bwd_grad"),
    ("K4 dq cast", "flash_attention_bwd_dq"),
    ("K9 LN2", "K9LayerNorm"),
    ("K9 fc1 GEMM", "K9Fc1"),
    ("K9 fc2 GEMM", "K9Fc2"),
    ("K10", "smooth_labels_kernel"),
)
#: Library GEMMs (cuBLAS, CUTLASS) by name.
GEMM_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "sm90_")
#: The kernel groups of each of the port's kernels.
KERNEL_OF = {"K1": ("K1 projection GEMM", "K1 attention"),
             "K2": ("K2 projection GEMM", "K2 attention passes",
                    "K2 dx GEMM")}
#: Trace event categories that are device work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host events that say what the host was doing.
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")
#: The user annotation the harness puts around a traced slice.
WINDOW_MARK = "portbench.slice"


def group_of(name: str) -> str:
    for label, mark in KERNEL_GROUPS:
        if mark in name:
            return label
    if any(m in name.lower() for m in GEMM_MARKS):
        return "library GEMMs"
    return "other"


class TraceSummary(NamedTuple):
    """A traced slice: its length and the seconds in which some device
    operation ran, device seconds and records by group, and idle seconds
    by what the host was doing."""

    window_s: float
    busy_s: float
    group_seconds: dict
    group_records: dict
    idle_by_host: dict


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _host_label(host_events, starts, t: float, lookback: int = 256) -> str:
    """The innermost of the host events that started among the last
    ``lookback`` before ``t`` and still run at ``t``, or ``host
    (python)`` where none does."""
    best = None
    j = bisect.bisect_right(starts, t)
    for start, end, name in host_events[max(0, j - lookback):j]:
        if end >= t and (best is None or end - start < best[1] - best[0]):
            best = (start, end, name)
    return best[2] if best else "host (python)"


def summarize(events: list, mark: str = WINDOW_MARK) -> TraceSummary:
    """Reduce the complete events of one trace (``ph`` X, times in µs)
    to a `TraceSummary` of the window annotated ``mark``. Device events
    are clipped to the window. Raises ValueError where the window mark
    is missing."""
    windows = [e for e in events if e.get("name") == mark]
    if not windows:
        raise ValueError(f"no {mark!r} annotation in the trace")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    groups = collections.Counter()
    records = collections.Counter()
    busy = []
    host = []
    for e in events:
        cat = e.get("cat")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            lo, hi = max(start, w0), min(end, w1)
            if hi <= lo:
                continue
            label = group_of(e["name"]) if cat == "kernel" else cat
            groups[label] += (hi - lo) / 1e6
            records[label] += 1
            busy.append((lo, hi))
        elif cat in HOST_CATEGORIES and e.get("name") != mark:
            if end > w0 and start < w1:
                host.append((start, end, e["name"]))
    merged = _union(busy)
    busy_s = sum(hi - lo for lo, hi in merged) / 1e6
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi > lo:
            idle[_host_label(host, starts, (lo + hi) / 2)] += (hi - lo) / 1e6
    return TraceSummary((w1 - w0) / 1e6, busy_s, dict(groups),
                        dict(records), dict(idle))


def load_events(path: str) -> list:
    """The complete (``ph`` X) events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e]


def kernel_seconds(summary: TraceSummary, kernel: str) -> float:
    """Device seconds of one of the port's kernels (`KERNEL_OF`)."""
    return sum(summary.group_seconds.get(g, 0.0) for g in KERNEL_OF[kernel])


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The result line's ``breakdown``: the groups that took most device
    time, and idle time by what the host was doing, in seconds."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": largest(summary.group_seconds),
            "idle_gaps": largest(summary.idle_by_host)}
