#!/usr/bin/env python3
"""The gather-dot kernel's CSR baseline under every plan shape, on one card.

    python scripts/gather_sweep.py [--cells clustered16,banded] [--iters 20]

For each K=128 cell of ``chip_smoke.py`` (generated as it does), times the
CSR baseline (the gather-dot kernel through ``residual_gather_dot``)
walking the entries in CSR order (no plan) and walking plans of 2, 4, 8
and 16 rows a group, rows taken in the pattern's order and in
``similar_rows_order``, beside ``torch.sparse.sampled_addmm``: the device
time of a call from ``torch.profiler`` (``scripts/torch_profile.py``'s
``profile``, ``--iters`` calls after 3 warm-ups) and its CUDA-event time
(median of ``--iters``).  One JSON line per (cell, order, group size):
both times, the plan's items and groups, the plan model's cost per entry
on the sample (``gather_plan.sample_costs``), and the host seconds of the
plan.  This is
what the group-size model of ``gather_plan`` is fitted to.  Needs a CUDA
card; imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
K = 128


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="clustered16,clustered128,powerlaw,"
                    "banded,dlmc")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script times the "
                 "card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spec = importlib.util.spec_from_file_location(
        "torch_profile", ROOT / "scripts" / "torch_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops import gather_plan as gp
    from sddmm_tpu_torch.ops.hybrid import residual_gather_dot
    from sddmm_tpu_torch.utils.timing import cuda_time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gens = smoke.suite()
    for name in args.cells.split(","):
        csr = gens[name]()
        a = torch.as_tensor(generate.make_dense(csr.m, K, seed=1),
                            device="cuda")
        b = generate.make_dense(K, csr.n, seed=2)
        bt = torch.as_tensor(np.ascontiguousarray(b.T), device="cuda")
        rows_np = csr.row_indices()
        rows = torch.as_tensor(rows_np, dtype=torch.int32, device="cuda")
        cols = torch.as_tensor(csr.col_idx, dtype=torch.int32, device="cuda")
        want = residual_gather_dot(a, bt, rows, cols)
        lib = smoke.sampled_addmm_ms(torch, a, bt, rows, cols, args.iters)

        def timed(fn):
            """(device ms of the gather-dot a call, event ms)."""
            dev = prof.profile(torch, fn, args.iters)["by_group_ms"].get(
                "gather_dot")
            return dev, cuda_time_ms(fn, args.iters)["median_ms"]

        def emit(order, gr, times, plan=None, secs=None, cost=None):
            print(json.dumps({
                "card": card, "cell": f"{name}@K{K}", "order": order,
                "group_rows": gr, "device_ms": times[0], "ms": times[1],
                "sampled_addmm_ms": lib, "entries": csr.nnz,
                "items": None if plan is None else len(plan.items),
                "groups": None if plan is None else len(plan.groups),
                "model_cost": cost, "plan_s": secs}), flush=True)

        emit("entries", 1, timed(lambda: residual_gather_dot(a, bt, rows,
                                                             cols)))
        for order_name, order in (
                ("natural", None),
                ("similar", gp.similar_rows_order(csr.row_ptr,
                                                  csr.col_idx))):
            costs = gp.sample_costs(rows_np, csr.col_idx, order)
            for gr in gp.GATHER_GROUPS:
                t0 = time.perf_counter()
                plan = gp.gather_plan(rows_np, csr.col_idx, order, gr)
                secs = time.perf_counter() - t0
                plan_d = plan.to("cuda")
                got = residual_gather_dot(a, bt, rows, cols, plan=plan_d)
                err = float(((got - want).abs() / want.abs()).max())
                if not err <= 1e-6:
                    sys.exit(f"{name} {order_name} GR={gr}: max rel {err} "
                             "against the entry-order walk")
                emit(order_name, gr, timed(lambda: residual_gather_dot(
                    a, bt, rows, cols, plan=plan_d)), plan, secs, costs[gr])
        del a, bt, rows, cols, want
    if "jax" in sys.modules:
        sys.exit("jax was imported")


if __name__ == "__main__":
    main()
