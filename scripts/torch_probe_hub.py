#!/usr/bin/env python3
"""A/B of the dense hub-column slab (pack.py "Dense hub slab") on a
bench-suite matrix, on the card: the counterpart of scripts/probe_hub.py,
importing nothing of JAX.  Same (alpha, delta), H swept, interleaved within
one process so that a drift of the card between processes cannot fake a
winner; the JAX script's lines and flags, plus ``--device`` (the card
unless ``--device cpu``).  Timing is ``HybridSDDMM.measure_kernel_ms``
(CUDA events around back-to-back calls); on the card each round also
prints ``device X ms`` (``utils.timing.queued_time_ms``, the device's work
alone).  ``est`` is the layout model's score (``TunedConfig.est_ms``), in
the units of its loaded constants.

Usage:
    python scripts/torch_probe_hub.py --matrix powerlaw --k 128 \\
        --alpha 0.1 --delta 0.05 --hubs 0,640,1024,1280
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--matrix", default="powerlaw")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--compute-dtype", default="tf32")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--g", type=int, default=1)
    p.add_argument("--c", type=int, default=1)
    p.add_argument("--hubs", default="0,640,1024")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.reorder.autotune import from_params
    from sddmm_tpu_torch.utils.timing import gflops
    from torch_probe_configs import device_ms

    dev = check_device(args.device)
    print(f"card: {bench.card_label(dev)}", flush=True)
    csr = bench.suite(False)[args.matrix]()
    hubs = [int(x) for x in args.hubs.split(",")]
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)

    runners = {}
    for h in hubs:
        t0 = time.perf_counter()
        tuned = from_params(csr, args.k, alpha=args.alpha,
                            delta=args.delta, group_size=args.g,
                            k_chunks=args.c, hub_cols=h,
                            compute_dtype=args.compute_dtype)
        runner = HybridSDDMM(tuned.packed,
                             compute_dtype=args.compute_dtype,
                             k_chunks=args.c, device=dev)
        ops = runner.prepare_operands(a, b=b)
        pk = tuned.packed
        print(f"H={h}: tiles=({pk.num_super},{pk.num_quads},"
              f"{pk.num_pairs},{pk.num_groups}) res={pk.nnz_res} "
              f"hub={pk.nnz_hub} packed={pk.packed_size} "
              f"est={tuned.est_ms:.3f}ms  [{time.perf_counter()-t0:.0f}s "
              f"prep]", flush=True)
        runners[h] = (runner, ops)

    times = {h: [] for h in hubs}
    for r in range(args.rounds):
        for h in hubs:  # interleaved: drift hits all H equally
            runner, ops = runners[h]
            ms = runner.measure_kernel_ms(
                *ops, iterations=args.iterations, repeats=3,
                order="packed")
            times[h].append(ms)
            line = (f"  round {r} H={h}: {ms:.4f} ms "
                    f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)")
            if dev.type == "cuda":
                line += (f" device "
                         f"{device_ms(runner, ops, args.iterations):.4f} ms")
            print(line, flush=True)
    print("--- medians ---")
    for h in hubs:
        med = float(np.median(times[h]))
        print(f"H={h}: {med:.4f} ms  ({gflops(csr.nnz, args.k, med):.0f} "
              f"GFLOPS)  sessions={[round(x, 4) for x in times[h]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
