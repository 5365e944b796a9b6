#!/usr/bin/env python3
"""Multi-rank scaling harness for the sharded hybrid SDDMM of the PyTorch
port: the counterpart of scripts/scaling_bench.py, importing nothing of
JAX.

For each rank count c it starts c ranks (``parallel.launch.spawn``) on a
('rows', 'feat') mesh of (c // feat, feat), feat = 2 where c >= 4 is even
(as the JAX script builds it), runs ``DistributedHybridSDDMM`` and checks
it against the single-device runner (``max_rel_err``), audits the packed
step's collectives from each runner's ``collectives`` log (no all-gather;
exactly one all-reduce, over 'feat', when feat = 2) where the JAX script
audits the compiled HLO, and times the step: each rank's median step time
by ``utils.timing.call_times_ms`` (CUDA events on the card, the host clock
on the CPU), the slowest rank's taken.  Where there is a card a rank the
ranks run over NCCL (nnz/s at 1..N cards and the scaling efficiency);
else they share one device over gloo — ``--virtual N``, ``--device cpu``,
or more ranks than cards — on a small matrix, and their numbers are
labelled "ranks share one card: not a scaling number" (on the CPU, "ranks
share the CPU"), as the JAX script labels its virtual mesh.

Usage:
    python scripts/torch_scaling_bench.py --virtual 4 --device cpu  # CPU
    python scripts/torch_scaling_bench.py --devices 1 2 4   # the card(s)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the JAX script's collective names (``count_collectives``), by the
#: ``collectives`` log's kinds
COLLECTIVES = {"all-gather": "all_gather", "all-reduce": "all_reduce",
               "reduce-scatter": "reduce_scatter",
               "collective-permute": "collective_permute",
               "all-to-all": "all_to_all"}


def rank_step(rank, world, shape, packed, a, b, iterations, backend,
              device):
    """One rank of a mesh of ``shape``: its CSR-order values (rank 0), the
    packed step's collectives, its median step time (ms) and the rows
    ranks' tile balance (rank 0)."""
    import torch

    from sddmm_tpu_torch.parallel import DistributedHybridSDDMM, make_mesh
    from sddmm_tpu_torch.utils.timing import call_times_ms

    mesh = make_mesh(shape, backend=backend, device=device)
    runner = DistributedHybridSDDMM(packed, mesh, compute_dtype="float32",
                                    device=device)
    with torch.no_grad():
        ops = runner.prepare_operands(a, b=b)
        vals = runner.run_padded(*ops, order="csr")
        runner.collectives.clear()
        runner.run_padded(*ops, order="packed")
        coll = list(runner.collectives)
        ms = call_times_ms(lambda: runner.run_padded(*ops, order="packed"),
                           mesh.device, iterations)["median_ms"]
    return {"vals": vals.cpu().numpy() if rank == 0 else None,
            "collectives": coll, "ms": ms,
            "balance": runner.tile_balance() if rank == 0 else None}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--virtual", type=int, default=0,
                   help="run up to this many ranks on one device over gloo")
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="rank counts to measure (a card a rank where there "
                   "are that many)")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.parallel import launch
    from sddmm_tpu_torch.reorder.bsmr import BSMR
    from sddmm_tpu_torch.reorder.pack import pack
    from sddmm_tpu_torch.utils.logger import device_name

    dev = check_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_avail = args.virtual or max(cards, 1)
    counts = args.devices or sorted(
        {c for c in (1, 2, 4, 8) if c <= n_avail})
    # ranks share one device unless every count has a card a rank
    virtual = args.virtual > 0 or max(counts) > cards
    backend = "gloo" if virtual else "nccl"
    label = ("ranks share the CPU" if dev.type == "cpu"
             else "ranks share one card")

    csr = generate.block_clustered(
        64 if virtual else 1024, 64 if virtual else 1024,
        block_prob=0.08 if virtual else 0.008,
        block_density=0.65, noise_density=1e-5, seed=42)
    k = args.k
    bsmr = BSMR(0.3, 0.05, csr, device=dev)
    packed = pack(csr, bsmr)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)

    # Single-device reference values for correctness.
    ref_runner = HybridSDDMM(packed, compute_dtype="float32", device=dev)
    with torch.no_grad():
        ref_vals = ref_runner(a, b, order="csr").cpu().numpy()
    del ref_runner

    results = []
    for c in counts:
        feat = 2 if c >= 4 and c % 2 == 0 else 1
        shape = (c // feat, feat)
        ranks = launch.spawn(c, rank_step, (shape, packed, a, b,
                                            args.iterations, backend,
                                            str(dev)),
                             backend=backend, timeout_s=600)
        vals = ranks[0]["vals"]
        err = float(np.max(np.abs(vals - ref_vals))
                    / (np.abs(ref_vals).max() + 1e-12))
        # Collective audit of the packed-order step (each runner's
        # ``collectives`` log): the flat value vector must stay sharded (no
        # all-gather); the only collective is the sum over 'feat', one
        # all-reduce.
        steps = [r["collectives"] for r in ranks]
        coll = {name: max(sum(x["kind"] == kind for x in s) for s in steps)
                for name, kind in COLLECTIVES.items()}
        if coll["all-gather"]:
            raise RuntimeError(f"devices={c}: unexpected all-gather in the "
                               f"sharded step ({coll})")
        if feat == 2 and any([x["group"] for x in s] != ["feat"]
                             for s in steps):
            raise RuntimeError(f"devices={c}: the step's collectives are "
                               f"not one all-reduce over 'feat' "
                               f"({steps[0]})")
        balance = ranks[0]["balance"]
        bal_ratio = float(balance.max() / max(balance.mean(), 1.0))
        ms = max(r["ms"] for r in ranks)
        nnz_s = csr.nnz / (ms / 1e3)
        results.append({"devices": c, "mesh": [c // feat, feat],
                        "max_rel_err": err,
                        "nnz_per_s": round(nnz_s / 1e6, 1),
                        "collectives": coll,
                        "tile_balance_max_over_mean": round(bal_ratio, 3)})
        print(f"devices={c}: max_rel_err={err:.2e} "
              f"nnz/s={nnz_s/1e6:.1f}M collectives={coll} "
              f"balance={bal_ratio:.2f}"
              + (f"  [{label}: not a scaling number]" if virtual else ""),
              flush=True)

    if len(results) > 1 and not virtual:
        base = results[0]["nnz_per_s"]
        for r in results[1:]:
            r["scaling_efficiency"] = round(
                r["nnz_per_s"] / (base * r["devices"]), 3)
    print(json.dumps({"virtual": virtual, "k": k, "results": results,
                      "backend": backend, "device": device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
