"""The arithmetic behind ``perfbench/metrics/*.py``: each per-layer metric
of one loop kind from a traced run's ``trace.Records``.  Each returns None
where the records hold nothing to read (another loop kind, no device
interval), never 0."""

from __future__ import annotations

import statistics


def host_ms(r, kind: str):
    """Mean host time (ms) to enqueue one call, request or step, each
    after a synchronize."""
    if r.kind != kind or not r.host_s:
        return None
    return statistics.fmean(r.host_s) * 1e3


def roofline_share(r, kind: str):
    """% of the device-busy time of a call that the least time for its
    work would take (``counts``: operations over the mode's peak or bytes
    over HBM bandwidth, the larger, summed over the ops)."""
    if r.kind != kind or not r.kernels or not r.calls:
        return None
    return 100.0 * r.least_s / (r.busy_s() / r.calls)


def idle_share(r, kind: str):
    """% of the device-only profiled sub-window in which no device op ran:
    1 - the union of its device intervals over its length.  (The profiler
    adds host time to every launch, so where the host sets the pace this
    reads above the untraced run's idle share.)"""
    if r.kind != kind or not r.kernels or r.window_s() <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s())


def mfu(r, kind: str):
    """% of the mode's peak: useful operations of a call over its wall
    time in the untraced part of the run."""
    if r.kind != kind or r.wall_s <= 0 or not r.peak_flops:
        return None
    return 100.0 * r.useful_flops / (r.wall_s * r.peak_flops)
