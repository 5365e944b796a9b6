#!/usr/bin/env python3
"""Does the tile kernel's B^T read rate depend on the ADDRESS order of the
grouped B^T rows?  On the card the question is L2 locality: renumbering
the physical group rows into first-use order (consecutive work-table
entries touch nearby rows) could speed the kernel's ``cp.async`` reads
without changing what it reads.  The counterpart of
scripts/probe_gid_order.py, importing nothing of JAX: an interleaved A/B
of the identical packing with (a) the stock column-rank group order and
(b) first-use order, on one bench matrix; its flags and lines, plus
``--device`` (the card unless ``--device cpu``; on the card each round
also prints ``device X ms``, ``utils.timing.queued_time_ms``).

Usage:
    python scripts/torch_probe_gid_order.py --matrix clustered16 --k 128
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np


def first_use_remap(packed):
    """PackedMatrix with physical group rows renumbered into the order
    the kernel first touches them (hub-free packings only)."""
    if packed.hub_cols:
        raise ValueError("the hub slab pins the leading ranks")
    NG = packed.num_col_groups
    G = packed.group_size
    issue = np.concatenate([
        packed.super_gids.reshape(-1), packed.quad_gids.reshape(-1),
        packed.pair_gids.reshape(-1), packed.group_gids.reshape(-1),
        packed.res_gids.reshape(-1)])
    issue = issue[issue < NG]
    first = np.full(NG, np.iinfo(np.int64).max, dtype=np.int64)
    pos = np.arange(len(issue), dtype=np.int64)
    # reversed so earlier positions overwrite later ones
    first[issue[::-1]] = pos[::-1]
    rank = np.empty(NG + 1, dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(NG)
    rank[NG] = NG  # sentinel stays sentinel

    inv = np.empty(NG, dtype=np.int64)
    inv[rank[:NG]] = np.arange(NG)
    col_order = packed.col_order.reshape(NG, G)[inv].reshape(-1)

    def remap(g):
        return rank[g.astype(np.int64)].astype(g.dtype)

    return dataclasses.replace(
        packed, col_order=col_order,
        super_gids=remap(packed.super_gids),
        quad_gids=remap(packed.quad_gids),
        pair_gids=remap(packed.pair_gids),
        group_gids=remap(packed.group_gids),
        res_gids=remap(packed.res_gids))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--matrix", default="clustered16")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--skip-check", action="store_true")
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
    tuned = from_params(csr, args.k, alpha=args.alpha, delta=args.delta)
    packs = {"stock": tuned.packed,
             "first-use": first_use_remap(tuned.packed)}
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    golden = None if args.skip_check else sddmm_reference(a, b, csr)

    tagged = []
    for tag, pk in packs.items():
        runner = HybridSDDMM(pk, compute_dtype="tf32", device=dev)
        ops = runner.prepare_operands(a, b=b)
        if golden is not None:
            with torch.no_grad():
                got = runner.run_padded(*ops, order="csr").cpu().numpy()
            res = check_values(golden, got)
            print(f"[{tag}] contract {'PASS' if res.passed else 'FAIL'} "
                  f"max_rel={res.max_rel_err:.2e}", flush=True)
        tagged.append((tag, runner, ops))

    times = {tag: [] for tag, _, _ in tagged}
    for r in range(args.rounds):
        for tag, runner, ops in tagged:
            ms = runner.measure_kernel_ms(*ops,
                                          iterations=args.iterations,
                                          repeats=3, order="packed")
            times[tag].append(ms)
            line = (f"  round {r} [{tag}]: {ms:.4f} ms "
                    f"({gflops(csr.nnz, args.k, ms):.0f} GFLOPS)")
            if dev.type == "cuda":
                line += (f" device "
                         f"{device_ms(runner, ops, args.iterations):.4f} ms")
            print(line, flush=True)
    print("--- medians ---")
    for tag, _, _ in tagged:
        med = float(np.median(times[tag]))
        print(f"[{tag}]: {med:.4f} ms "
              f"({gflops(csr.nnz, args.k, med):.0f} GFLOPS)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
