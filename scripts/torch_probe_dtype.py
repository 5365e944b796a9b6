#!/usr/bin/env python3
"""A/B of the compute modes on one fixed packing, on the card: the
counterpart of scripts/probe_dtype.py, importing nothing of JAX.  Each mode
is checked against the fp64 golden model first (its contract status), then
all are timed in rotation within one process; the JAX script's lines and
flags, plus ``--device`` (the card unless ``--device cpu``).  On the card
each round also prints ``device X ms`` (``utils.timing.queued_time_ms``).

A mode ``X+pallas`` (the JAX script's manual Pallas tile dot) is the same
program as ``X`` here: every dense tile goes through the tile kernel
(``csrc/tile_dot.cu``, one instance per mode), and the runner ignores
``use_pallas``; the script says so beside its contract line.

Usage:
    python scripts/torch_probe_dtype.py --matrix clustered16 --k 128 \\
        --alpha 0.3 --delta 0.05 --dtypes tf32,mixed
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--matrix", default="clustered16")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--g", type=int, default=1)
    p.add_argument("--c", type=int, default=1)
    p.add_argument("--hub", type=int, default=0)
    p.add_argument("--dtypes", default="tf32,mixed")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    import torch
    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.ops.reference import sddmm_reference
    from sddmm_tpu_torch.reorder.autotune import from_params
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.timing import gflops
    from torch_probe_configs import device_ms

    dev = check_device(args.device)
    print(f"card: {bench.card_label(dev)}", flush=True)
    csr = bench.suite(False)[args.matrix]()
    dtypes = args.dtypes.split(",")
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)

    tuned = from_params(csr, args.k, alpha=args.alpha, delta=args.delta,
                        group_size=args.g, k_chunks=args.c,
                        hub_cols=args.hub)
    pk = tuned.packed
    print(f"{args.matrix}: tiles=({pk.num_super},{pk.num_quads},"
          f"{pk.num_pairs},{pk.num_groups}) res={pk.nnz_res} "
          f"hub={pk.nnz_hub}", flush=True)
    golden = sddmm_reference(a, b, csr)

    runners = {}
    for dt in dtypes:
        runner = HybridSDDMM(pk, compute_dtype=dt.split("+")[0],
                             k_chunks=args.c,
                             use_pallas=dt.endswith("+pallas"), device=dev)
        ops = runner.prepare_operands(a, b=b)
        with torch.no_grad():
            got = runner.run_padded(*ops, order="csr").cpu().numpy()
        res = check_values(golden, got)
        print(f"{dt}: contract "
              f"{'PASS' if res.passed else 'FAIL'} max_rel="
              f"{res.max_rel_err:.2e}", flush=True)
        if dt.endswith("+pallas"):
            print(f"{dt}: the same program as {dt.split('+')[0]} on this "
                  "runner (it ignores use_pallas)", flush=True)
        runners[dt] = (runner, ops)

    times = {dt: [] for dt in dtypes}
    for r in range(args.rounds):
        for dt in dtypes:
            runner, ops = runners[dt]
            ms = runner.measure_kernel_ms(
                *ops, iterations=args.iterations, repeats=3,
                order="packed")
            times[dt].append(ms)
            line = (f"  round {r} {dt}: {ms:.4f} ms "
                    f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)")
            if dev.type == "cuda":
                line += (f" device "
                         f"{device_ms(runner, ops, args.iterations):.4f} ms")
            print(line, flush=True)
    print("--- medians ---")
    for dt in dtypes:
        med = float(np.median(times[dt]))
        print(f"{dt}: {med:.4f} ms ({gflops(csr.nnz, args.k, med):.0f} "
              f"GFLOPS) sessions={[round(x, 4) for x in times[dt]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
