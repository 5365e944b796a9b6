"""Loop of the SDDMM cells: calls enqueued back to back on one pattern,
each on a fresh operand pair from a pool made from the seed.

``sddmm_gflops`` is 2 * nnz * K times the calls completed over the window,
which begins after a synchronize and ends with one.  The outputs judged
are the last call's of every pool pair and one early call's, drawn from the
seed, all against the float64 reference."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import counts, reference
from perfbench.trace import span

#: early calls, counted from the window's first, one of which is judged
EARLY = 64


class Loop:
    kind = "sddmm"

    def __init__(self, system, pattern, config, traffic, device, seed: int):
        self.system, self.pattern = system, pattern
        self.k, self.pool = int(traffic["k"]), int(traffic["pool"])
        self.mode = config["compute_mode"]
        m, n, k = pattern.m, pattern.n, self.k
        gen = torch.Generator(device=device).manual_seed(seed)
        # U[0, 2) operands with a zero pad row, the runner's padded layout
        self.a = torch.rand((self.pool, m + 1, k), generator=gen,
                            device=device).mul_(2)
        self.bt = torch.rand((self.pool, n + 1, k), generator=gen,
                             device=device).mul_(2)
        self.a[:, m] = 0
        self.bt[:, n] = 0
        self.early = int(np.random.default_rng(seed).integers(EARLY))
        self.kept = {}          # call index -> (pool index, output)
        self.calls = 0
        for i in range(self.pool):
            self.call(i)
        self.sync()
        self.kept, self.calls = {}, 0

    def sync(self):
        if self.a.is_cuda:
            torch.cuda.synchronize()

    def call(self, i: int):
        j = i % self.pool
        out = self.system.call(self.system.prepare(self.a[j], self.bt[j]))
        self.keep(i, j, out)

    def keep(self, i, j, out):
        self.kept[j] = (j, out)
        if i == self.early:
            self.kept["early"] = (j, out)

    def traced_call(self, i: int):
        j = i % self.pool
        with span("prepare"):
            ops = self.system.prepare(self.a[j], self.bt[j])
        with span("call"):
            out = self.system.call(ops)
        self.keep(i, j, out)

    def window(self, seconds: float):
        self.sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.call(n)
            n += 1
        self.sync()
        elapsed = time.perf_counter() - t0
        rate = 2.0 * self.pattern.nnz * self.k * n / elapsed / 1e9
        return {"sddmm_gflops": rate}, n

    def host_probe(self, calls: int) -> list:
        out = []
        for i in range(calls):
            self.sync()
            t0 = time.perf_counter()
            self.call(i)
            out.append(time.perf_counter() - t0)
        self.sync()
        return out

    def ops(self) -> list:
        p = self.pattern
        return [counts.sddmm_op(p.m, p.n, self.k, p.nnz)]

    def release(self):
        """Drop the program's state; what it produced stays."""
        self.system = None

    def readings(self) -> dict:
        return {key: out for key, (_, out) in self.kept.items()}

    def control_readings(self, precision: str) -> dict:
        return {key: reference.sddmm(self.pattern, self.a[j], self.bt[j],
                                     precision)
                for key, (j, _) in self.kept.items()}

    def judge(self, readings: dict) -> dict:
        """max over the judged outputs of max |out - ref| / |ref|."""
        worst = 0.0
        for key, (j, _) in self.kept.items():
            ref = reference.sddmm(self.pattern, self.a[j], self.bt[j])
            err = float(((readings[key].double() - ref).abs()
                         / ref.abs()).max())
            worst = max(worst, err if math.isfinite(err) else math.inf)
        return {"max_rel_err": worst}
