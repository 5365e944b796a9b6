#!/usr/bin/env python3
"""Component-level time breakdown of the hybrid SDDMM on the card: the
counterpart of scripts/probe_breakdown.py, importing nothing of JAX.

Times each part of one hybrid call apart, on the operands of the call
itself, so that perf work targets the measured bottleneck:

  full_hybrid     ``run_padded`` packed order: the tile launch and, with a
                  residual, the gather-dot launch
  tile_launch     the tile kernel's one launch over the work table (every
                  dense segment, chunk and slab: K1 with K2, K4)
  residual_path   the residual gather-dot's one launch on its plan (K3)
  csr_gather      CSR order from the packed vector, ``flat[inv_idx]`` (K5)
  hybrid_csr      ``run_padded`` into CSR order
  dense_class     ``DenseSDDMM`` on the same matrix (K6), packed order

Each line gives the event time (``utils.timing.session_median_ms``: CUDA
events around back-to-back calls, which read the host's enqueue where a
call's wrapper outlasts its kernels) and, on the card, ``device X ms``
(``utils.timing.queued_time_ms``: the calls queued behind a held stream,
the device's work alone).

The JAX script's parts are XLA programs that the card does not run (its
B and A gathers, the MXU dots on pre-gathered operands, the panel-major A
gather, the hub slab's matmul): here they are one launch, and the tile
kernel gathers by ``cp.async`` inside it.  Its descriptor accounting
(``descriptor_floor_ms``, the ``_ELEM_BYTES`` floors) prices XLA's gather
engine on the TPU and is left out.

Usage:
    python scripts/torch_probe_breakdown.py --matrix powerlaw --k 128
    python scripts/torch_probe_breakdown.py --matrix clustered16 --k 32 --g 4
    python scripts/torch_probe_breakdown.py --matrix banded --committed
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--matrix", default="powerlaw")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--compute-dtype", default="tf32")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--g", type=int, default=None, help="override G")
    p.add_argument("--c", type=int, default=None, help="override k_chunks")
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--delta", type=float, default=None)
    p.add_argument("--committed", action="store_true",
                   help="dissect the committed config for this (matrix, K) "
                        "instead of the layout model's pick")
    p.add_argument("--file", default=None, help="matrix file instead of "
                   "a bench-suite name")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    import torch
    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data import generate, io
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import (HybridSDDMM, check_device,
                                            residual_gather_dot)
    from sddmm_tpu_torch.reorder.autotune import autotune
    from sddmm_tpu_torch.utils.timing import (gflops, queued_time_ms,
                                              session_median_ms)

    dev = check_device(args.device)
    print(f"card: {bench.card_label(dev)}", flush=True)
    csr = (io.load(args.file) if args.file
           else bench.suite(False)[args.matrix]())
    # this probe dissects the hybrid call's parts, never the dense class
    # alone (which is one launch)
    use_pallas, a_layout = False, "rows"
    if args.committed:
        cfg = bench.load_tuned_config(args.matrix, args.k)
        if not cfg or cfg.get("dense"):
            print(f"no committed hybrid config for {args.matrix} "
                  f"K={args.k}; nothing to dissect")
            return 1
        args.compute_dtype = cfg.get("dtype", args.compute_dtype)
        tuned = bench.fold_config(csr, args.k, cfg, args.compute_dtype)
        use_pallas, a_layout = tuned.use_pallas, tuned.a_layout
    else:
        tuned = autotune(
            csr, k=args.k, compute_dtype=args.compute_dtype, measure=False,
            alphas=(args.alpha,) if args.alpha is not None else (0.3,),
            deltas=(args.delta,) if args.delta is not None
            else (0.0, 0.05, 0.3),
            allow_dense=False, device=dev)
    g = args.g if args.g is not None else tuned.group_size
    c = args.c if args.c is not None else tuned.k_chunks
    if g != tuned.group_size:
        # re-derive the packing at the requested G
        from sddmm_tpu_torch.reorder.bsmr import BSMR
        from sddmm_tpu_torch.reorder.cols import cluster_columns
        from sddmm_tpu_torch.reorder.pack import pack
        rank = None
        if g > 1:
            order = cluster_columns(csr, tuned.alpha)
            rank = np.empty(csr.n, dtype=np.int64)
            rank[order] = np.arange(csr.n)
        bsmr = BSMR(tuned.alpha, tuned.delta, csr, group_size=g,
                    col_rank=rank)
        packed = pack(csr, bsmr, k_hint=args.k,
                      compute_dtype=args.compute_dtype)
    else:
        packed = tuned.packed

    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype,
                         k_chunks=c, use_pallas=use_pallas,
                         a_layout=a_layout, device=dev)
    a = generate.make_dense(csr.m, args.k, seed=1)
    b = generate.make_dense(args.k, csr.n, seed=2)
    a_ops, bt_phys = runner.prepare_operands(a, b=b)

    print(f"matrix={args.matrix} m={csr.m} n={csr.n} nnz={csr.nnz} "
          f"k={args.k} cfg=(a={tuned.alpha} d={tuned.delta} G="
          f"{packed.group_size} C={c} H={packed.hub_cols} "
          f"pallas={use_pallas} aL={a_layout} "
          f"dt={args.compute_dtype} merge={tuned.merge_superpanels})")
    print(f"tiles: nS={packed.num_super} nQ={packed.num_quads} "
          f"nP={packed.num_pairs} nG={packed.num_groups} "
          f"res={packed.nnz_res} hub={packed.nnz_hub} "
          f"packed={packed.packed_size} "
          f"table_entries={runner.table.entries.shape[0]}")

    it = args.iterations

    def report(name, fn):
        def call():
            with torch.no_grad():
                fn()
        ms = session_median_ms(call, dev, it, 4)
        line = (f"  {name:18s} {ms:8.3f} ms   "
                f"({gflops(csr.nnz, args.k, ms):7.1f} GFLOPS-equiv)")
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                line += f"  device {queued_time_ms(call, it):8.4f} ms"
        print(line, flush=True)

    flat = torch.empty(packed.packed_size, dtype=torch.float32, device=dev)
    report("full_hybrid",
           lambda: runner.run_padded(a_ops, bt_phys, order="packed"))
    report("tile_launch", lambda: runner.run_tiles(a_ops, bt_phys, flat))
    if packed.nnz_res:
        res_args = runner.residual_call(a_ops, bt_phys)
        plan = runner.res_plan
        out = flat[flat.shape[0] - packed.nnz_res:]
        report("residual_path",
               lambda: residual_gather_dot(*res_args, out=out, plan=plan))
    report("csr_gather", lambda: runner.to_csr_order(flat))
    report("hybrid_csr",
           lambda: runner.run_padded(a_ops, bt_phys, order="csr"))
    del runner, a_ops, bt_phys, flat
    dense = DenseSDDMM.from_csr(csr, compute_dtype=args.compute_dtype,
                                device=dev)
    d_ops = dense.prepare_operands(a, b=b)
    report("dense_class", lambda: dense.run_padded(*d_ops, order="packed"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
