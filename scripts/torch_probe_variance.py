#!/usr/bin/env python3
"""Repeated-session timing of ONE fixed hybrid config on the card, to
measure the run-to-run spread of its time: the counterpart of
scripts/probe_variance.py, importing nothing of JAX.

Each "session" is an independent ``measure_kernel_ms`` call (event time,
the median of ``--iterations`` calls, the median of ``--repeats``), the
sessions ``--gap`` seconds apart; on the card each also prints ``device X
ms`` (``utils.timing.queued_time_ms``, the device's work alone).  The last
line gives min/median/max and ``spread=(max-min)/median``, the noise
yardstick a probe winner's margin is read against.  The packing is built
as the JAX script builds it, with ``BSMR``, ``cluster_columns`` and
``pack`` (so a config's hub, slabs, sort keys and A layout are not
taken); ``--merge`` is always on, as there.

Usage:
    python scripts/torch_probe_variance.py --matrix clustered16 --k 128 \\
        --alpha 0.3 --delta 0.05 --sessions 8
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
    p.add_argument("--matrix", default="clustered16")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--compute-dtype", default="tf32")
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--g", type=int, default=1)
    p.add_argument("--c", type=int, default=1)
    p.add_argument("--merge", action="store_true", default=True)
    p.add_argument("--sessions", type=int, default=8)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--gap", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.reorder.bsmr import BSMR
    from sddmm_tpu_torch.reorder.cols import cluster_columns
    from sddmm_tpu_torch.reorder.pack import pack
    from sddmm_tpu_torch.utils.timing import gflops
    from torch_probe_configs import device_ms

    dev = check_device(args.device)
    print(f"card: {bench.card_label(dev)}", flush=True)
    csr = bench.suite(False)[args.matrix]()
    rank = None
    if args.g > 1:
        order = cluster_columns(csr, args.alpha)
        rank = np.empty(csr.n, dtype=np.int64)
        rank[order] = np.arange(csr.n)
    bsmr = BSMR(args.alpha, args.delta, csr, group_size=args.g,
                col_rank=rank)
    packed = pack(csr, bsmr, k_hint=args.k,
                  merge_superpanels=args.merge,
                  compute_dtype=args.compute_dtype)
    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype,
                         k_chunks=args.c, device=dev)
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    ops = runner.prepare_operands(a, b=b)
    print(f"matrix={args.matrix} nnz={csr.nnz} k={args.k} "
          f"cfg=(a={args.alpha} d={args.delta} G={args.g} C={args.c}) "
          f"tiles=({packed.num_super},{packed.num_quads},"
          f"{packed.num_pairs},{packed.num_groups}) res={packed.nnz_res}")
    times = []
    for s in range(args.sessions):
        t0 = time.perf_counter()
        ms = runner.measure_kernel_ms(*ops, iterations=args.iterations,
                                      repeats=args.repeats, order="packed")
        times.append(ms)
        dev_str = (f"  device {device_ms(runner, ops, args.iterations):.4f}"
                   " ms" if dev.type == "cuda" else "")
        print(f"  session {s}: {ms:.4f} ms  ({gflops(csr.nnz, args.k, ms):.0f}"
              f" GFLOPS){dev_str}  [{time.perf_counter() - t0:.1f}s wall]",
              flush=True)
        time.sleep(args.gap)
    t = np.array(times)
    med = float(np.median(t))
    print(f"min={t.min():.4f} median={med:.4f} max={t.max():.4f} "
          f"spread=(max-min)/median={float((t.max() - t.min()) / med):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
