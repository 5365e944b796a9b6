"""Kernel timing on the card with CUDA events.

Counterpart of ``sddmm_tpu/utils/timing.py``.  PyTorch returns before the
device finishes, so a host clock measures the enqueue; CUDA events on the
current stream measure the device.  No loop differencing is needed.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_time_ms(fn: Callable[[], object], iterations: int = 20,
                 warmup: int = 3) -> dict:
    """Median and spread of ``fn()``'s device time (ms) on the current
    CUDA stream: ``warmup`` untimed calls, then ``iterations`` calls each
    between a pair of events, one synchronise at the end."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(iterations)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "n": iterations}
