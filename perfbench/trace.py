"""The traced run's records: device intervals and the benchmark's own spans
from ``torch.profiler``, reduced to busy time, idle gaps and a breakdown.

The loops wrap each call into a layer in ``span(name)`` (a
``record_function``).  Nothing is written to disk: the events are read in
memory.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

#: entries of each list in the result line's ``breakdown``
BREAKDOWN_ENTRIES = 10
WINDOW = "window"


def span(name: str):
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Records:
    """What the readers of ``perfbench/metrics`` read.  Times in seconds.

    ``kind`` is the loop's ("sddmm", "train"); ``calls`` the
    calls, requests or steps in the profiled sub-window; ``kernels``
    (name, start, end) device intervals inside it; ``spans`` (name, start,
    end) of the benchmark's own spans; ``window`` (start, end) of the
    sub-window; ``host_s`` the host enqueue time of calls that each
    followed a synchronize; ``gaps`` (span, seconds) of the idle
    stretches of a second sub-window traced with the host's ops;
    ``wall_s`` the wall time per call of the untraced part;
    ``useful_flops`` and ``least_s`` of one call; ``peak_flops`` the
    mode's peak."""
    kind: str
    calls: int = 0
    kernels: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    window: tuple = (0.0, 0.0)
    host_s: list = dataclasses.field(default_factory=list)
    gaps: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    useful_flops: float = 0.0
    least_s: float = 0.0
    peak_flops: float = 0.0

    def busy_intervals(self) -> list:
        """The union of the device intervals, merged, in time order."""
        merged = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def idle_gaps(self) -> list:
        """(start, end) of every stretch of the window with no device op."""
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def host_span_at(self, t: float) -> str:
        """The innermost benchmark span the host was in at time t."""
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "outside"

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for name, s, e in self.kernels:
            ops[name] += e - s
        idle = collections.Counter()
        for name, t in self.gaps:
            idle[name] += t
        return {"device_ops": [[n[:200], t] for n, t in
                               ops.most_common(BREAKDOWN_ENTRIES)],
                "idle_gaps": [[n, t] for n, t in
                              idle.most_common(BREAKDOWN_ENTRIES)]}


def _device_events(prof) -> list:
    from torch.autograd import DeviceType
    return [(ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
            for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def profile(fn, calls: int, records: Records, tries: int = 3) -> None:
    """Two profiled sub-windows of ``fn(i)`` for i < ``calls``, each ending
    with a synchronize, into ``records``.

    The first traces the device alone, which costs the host little: its
    device intervals and its length on the host clock give ``kernels`` and
    ``window``, the busy and idle time.  The second also traces the host's
    ops and the benchmark's spans, which slows the host: it gives only
    ``gaps``, the idle stretches labelled by what the host was doing.
    The profiler now and then records no device event on the card: each
    pass is tried again, up to ``tries`` times."""
    cuda = torch.cuda.is_available()
    dev_acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    for _ in range(tries):
        with torch.profiler.profile(
                activities=dev_acts or [torch.profiler.ProfilerActivity.CPU]
        ) as prof:
            _sync(cuda)
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
            _sync(cuda)
            t1 = time.perf_counter()
        kernels = _device_events(prof)
        if kernels or not cuda:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    records.calls = calls
    if kernels:
        # the device clock's origin is the profiler's: the window is placed
        # on it by its first interval, its length is the host clock's
        start = min(s for _, s, _ in kernels)
        records.kernels = kernels
        records.window = (start, start + (t1 - t0))
    acts = [torch.profiler.ProfilerActivity.CPU] + dev_acts
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            with span(WINDOW):
                for i in range(calls):
                    fn(i)
                with span("sync"):
                    _sync(cuda)
        kernels = _device_events(prof)
        if kernels or not cuda:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    spans, window = [], None
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if ev.name == WINDOW:
            window = (ev.time_range.start / 1e6, ev.time_range.end / 1e6)
        elif ev.name in SPAN_NAMES:
            spans.append((ev.name, ev.time_range.start / 1e6,
                          ev.time_range.end / 1e6))
    traced = Records(kind=records.kind, kernels=kernels, spans=spans,
                     window=window or (0.0, 0.0))
    records.gaps = [(traced.host_span_at((s + e) / 2), e - s)
                    for s, e in traced.idle_gaps()]


#: the benchmark's span names
SPAN_NAMES = ("prepare", "call", "forward", "loss", "backward",
              "optimizer", "sync", "zero_grad")
