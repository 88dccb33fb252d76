"""What the metrics compute from a `harness.RunRecord`. Each returns
None where the run holds nothing to read, never 0 for a share of a
roofline or a peak."""

from __future__ import annotations

import numpy as np

from portbench.yardstick import flops, trace

#: Operations and bytes of one call of each of the port's kernels.
OPS_BYTES = {"K1": flops.k1_ops_bytes, "K2": flops.k2_ops_bytes}


def rate(run):
    """Items (images) through the window over its host-clock time."""
    w = run.window
    return w["items"] / w["seconds"] if w.get("seconds") else None


def p95_ms(run):
    """The 95th percentile of every request's latency, from its due time
    to its answer; a request never answered counts as infinitely late."""
    latency = run.counters.get("latency_ms")
    if not latency:
        return None
    return float(np.percentile(latency, 95))


def mfu(run):
    """Model FLOPs of the window's work over its time, as a percentage
    of the bf16 peak."""
    w = run.window
    if not w.get("seconds") or "flops_per_item" not in w:
        return None
    return 100.0 * w["items"] * w["flops_per_item"] / w["seconds"] \
        / flops.PEAK_BF16_FLOPS


def roofline(run, kernel: str):
    """The bound of the kernel's calls in the traced slice over the
    device time of its group, as a percentage."""
    calls = run.calls.get(kernel)
    if run.trace is None or not calls:
        return None
    seconds = trace.kernel_seconds(run.trace, kernel)
    if seconds <= 0:
        return None
    bound = sum(count * flops.bound_seconds(*OPS_BYTES[kernel](*shape))
                for shape, count in calls)
    return 100.0 * bound / seconds if bound > 0 else None


def device_idle(run):
    """The share of the traced slice in which no device operation ran."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_gib(run):
    peak = run.counters.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
