#!/usr/bin/env python3
"""A/B of CSR-entry-order delivery on a bench matrix's committed packing,
on the card: the packed-order call alone against the call plus its
CSR-order conversion, interleaved in one process.  The counterpart of
scripts/probe_csr_order.py, importing nothing of JAX; its flags and lines,
plus ``--device`` (the card unless ``--device cpu``).

The port has one CSR-order strategy, ``gather``: ``flat[inv_idx]``, one
gather after the call (K5).  The JAX script's ``window`` and ``mxu``
strategies are ``ops/csr_order.py``, the window plan that exists because
scalar gathers are slow on the TPU; the port does not carry it, and the
script prints both as absent.  The committed config is folded as the bench
folds it (``bench.fold_config``, every key), where the JAX script takes
alpha, delta, G, C, merge and hub only.  On the card each round also
prints ``device X ms`` (``utils.timing.queued_time_ms``).

Usage:
    python scripts/torch_probe_csr_order.py --matrix clustered16 --k 128
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

#: the JAX script's strategies that the port does not carry
ABSENT = ("window", "mxu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--matrix", default="clustered16")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    import torch
    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.ops.reference import sddmm_reference
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.timing import gflops, queued_time_ms

    dev = check_device(args.device)
    print(f"card: {bench.card_label(dev)}", flush=True)
    cfg = bench.load_tuned_config(args.matrix, args.k) or {
        "alpha": 0.3, "delta": 0.05}
    if cfg.get("dense"):
        print(f"{args.matrix} k{args.k} is committed to the dense "
              "strategy; csr-order there is a plain (M,N)->nnz gather — "
              "probing the hybrid fallback config instead")
        cfg = {"alpha": 0.3, "delta": 0.05}
    csr = bench.suite(False)[args.matrix]()
    t0 = time.perf_counter()
    cdt = cfg.get("dtype", "tf32")
    tuned = bench.fold_config(csr, args.k, cfg, cdt)
    runner = HybridSDDMM(tuned.packed, compute_dtype=cdt,
                         k_chunks=tuned.k_chunks,
                         use_pallas=tuned.use_pallas,
                         a_layout=tuned.a_layout, device=dev)
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    ops = runner.prepare_operands(a, b=b)
    print(f"{args.matrix} k{args.k}: nnz={csr.nnz} "
          f"flat={tuned.packed.packed_size} "
          f"[{time.perf_counter()-t0:.0f}s prep]", flush=True)
    for strat in ABSENT:
        print(f"contract[{strat}] absent: ops/csr_order.py (the TPU's "
              "window plan) is not ported", flush=True)

    # correctness gate before timing anything
    golden = sddmm_reference(a, b, csr)
    with torch.no_grad():
        flat = runner.run_padded(*ops, order="packed")
        got = runner.to_csr_order(flat).cpu().numpy()
    res = check_values(golden, got)
    print(f"contract[gather] {'PASS' if res.passed else 'FAIL'} "
          f"max_rel={res.max_rel_err:.2e}", flush=True)
    if not res.passed:
        return 1

    strategies = {"packed": "packed", "csr:gather": "csr"}
    times = {tag: [] for tag in strategies}
    for r in range(args.rounds):
        for tag, order in strategies.items():
            ms = runner.measure_kernel_ms(
                *ops, iterations=args.iterations, repeats=3, order=order)
            times[tag].append(ms)
            line = (f"  round {r} [{tag}]: {ms:.4f} ms "
                    f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)")
            if dev.type == "cuda":
                def call(order=order):
                    with torch.no_grad():
                        runner.run_padded(*ops, order=order)
                with torch.cuda.device(dev):
                    line += (f" device "
                             f"{queued_time_ms(call, args.iterations):.4f} ms")
            print(line, flush=True)
    print("--- medians ---")
    med_packed = float(np.median(times["packed"]))
    for tag in strategies:
        med = float(np.median(times[tag]))
        print(f"[{tag}]: {med:.4f} ms "
              f"({gflops(csr.nnz, args.k, med):.0f} GFLOPS) "
              f"x{med / med_packed:.2f} vs packed "
              f"sessions={[round(x, 4) for x in times[tag]]}")
    for strat in ABSENT:
        print(f"[csr:{strat}]: absent (not ported)")
    best = min((t for t in strategies if t != "packed"),
               key=lambda t: np.median(times[t]))
    print(f"winner: [{best}] {float(np.median(times[best])):.4f} ms "
          f"(x{float(np.median(times[best])) / med_packed:.2f} vs "
          "packed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
