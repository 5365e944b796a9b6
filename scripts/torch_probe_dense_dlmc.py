#!/usr/bin/env python3
"""Probe: at true-DLMC density (about 0.2) is a hybrid packing or the dense
class the right kernel on the card?  The counterpart of
scripts/probe_dense_dlmc.py, importing nothing of JAX.

Candidates (effective GFLOPS = 2*nnz*K/t, as everywhere else), each timed
with CUDA events (``measure_kernel_ms``, or ``session_median_ms`` for the
library calls), the operands on ``--device`` (the card unless
``--device cpu``):

  hybrid       the JAX script's config, a=0.3 d=0.05 (all supertiles at
               this density), ``HybridSDDMM`` on its packing
  dense class  ``DenseSDDMM`` as the bench runs it: one launch of the tile
               kernel over the identity work table, the (M, N) product
  einsum       ``torch.einsum('aik,bjk->abij')`` tile-major, yardstick
  plain dot    ``torch.matmul(A, B^T)`` row-major, yardstick
  dot+x        the plain dot and one flat gather into the hybrid's packed
               order, yardstick

The yardsticks are cuBLAS in full fp32 (``tile_dot.full_fp32_matmul``):
NVIDIA's TF32 keeps 10 bits, which fails the reference's contract, so no
cuBLAS product at the tile kernel's bf16x3 precision exists.  On the card
the hybrid and the dense class also print ``device X ms``
(``utils.timing.queued_time_ms``, the device's work alone).

Lines ``scripts/torch_autofold.py`` (and the JAX ``r3_autofold.py``)
parse: ``hybrid: nS=.. res=.. X ms``, ``plain dot: X ms`` and, new here,
``dense class: X ms``: on the card the dense class is the port's own tile
kernel, not a library dot, so the port's arbitration reads it.

Left out of the JAX script: ``_force_write``, the ``1e-38`` carry chains
and the "no write barrier" diagnostic, which keep XLA from eliding or
fusing the (M, N) write inside its timing loop; a CUDA event times the
call as it is.

Usage:
    python scripts/torch_probe_dense_dlmc.py --k 128
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the bench's dlmc matrix (``bench.suite``): 4096 x 4096, density 0.2
SEED = 46


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--m", type=int, default=4096)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--density", type=float, default=0.2)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    import torch
    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.ops.tile_dot import full_fp32_matmul
    from sddmm_tpu_torch.reorder.autotune import from_params
    from sddmm_tpu_torch.utils.timing import (gflops, queued_time_ms,
                                              session_median_ms)

    dev = check_device(args.device)
    if args.m % 128 or args.n % 128:
        raise ValueError(f"--m {args.m} and --n {args.n} must be multiples "
                         "of 128 (the tile-major einsum)")
    print(f"card: {bench.card_label(dev)}", flush=True)
    csr = generate.random_sparse(args.m, args.n, density=args.density,
                                 seed=SEED)
    k, nnz, it = args.k, csr.nnz, args.iterations
    print(f"m={args.m} n={args.n} d={args.density} nnz={nnz} k={k}",
          flush=True)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)

    def device(runner, ops):
        if dev.type != "cuda":
            return ""

        def call():
            with torch.no_grad():
                runner.run_padded(*ops, order="packed")

        with torch.cuda.device(dev):
            return f"  device {queued_time_ms(call, it):.4f} ms"

    # --- hybrid (the JAX script's config) ---
    t0 = time.perf_counter()
    cfg = from_params(csr, k, alpha=0.3, delta=0.05, device=dev)
    runner = HybridSDDMM(cfg.packed, compute_dtype="tf32", device=dev)
    ops = runner.prepare_operands(a, b=b)
    ms = runner.measure_kernel_ms(*ops, iterations=it, repeats=4)
    print(f"hybrid: nS={cfg.packed.num_super} res={cfg.packed.nnz_res} "
          f"{ms:.4f} ms  {gflops(nnz, k, ms):.0f} GFLOPS "
          f"(host prep {time.perf_counter() - t0:.1f}s)"
          + device(runner, ops), flush=True)
    pk = cfg.packed
    del runner, ops, cfg

    # --- the dense class, as the bench runs it ---
    dense = DenseSDDMM.from_csr(csr, compute_dtype="tf32", device=dev)
    ops = dense.prepare_operands(a, b=b)
    ms = dense.measure_kernel_ms(*ops, iterations=it, repeats=4)
    print(f"dense class: {ms:.4f} ms  {gflops(nnz, k, ms):.0f} GFLOPS"
          + device(dense, ops), flush=True)
    del dense, ops

    # --- cuBLAS yardsticks, full fp32 ---
    a_d = torch.as_tensor(a, device=dev)
    bt_d = torch.as_tensor(np.ascontiguousarray(b.T), device=dev)
    a_blk = a_d.view(args.m // 128, 128, k)
    bt_blk = bt_d.view(args.n // 128, 128, k)

    def timed(fn, iterations=it):
        def call():
            with torch.no_grad():
                fn()
        return session_median_ms(call, dev, iterations, 4)

    with full_fp32_matmul():
        ms = timed(lambda: torch.einsum("aik,bjk->abij", a_blk, bt_blk))
        print(f"einsum tile-major: {ms:.4f} ms  "
              f"{gflops(nnz, k, ms):.0f} GFLOPS", flush=True)
        ms = timed(lambda: torch.matmul(a_d, bt_d.T))
        print(f"plain dot: {ms:.4f} ms  {gflops(nnz, k, ms):.0f} GFLOPS",
              flush=True)
        if pk.packed_rows is not None:
            # packed slots on the sentinel row or column read any valid cell
            flat_idx = np.clip(pk.packed_rows.astype(np.int64) * args.n
                               + pk.packed_cols.astype(np.int64), 0,
                               args.m * args.n - 1)
            flat_d = torch.as_tensor(flat_idx, device=dev)
            ms = timed(lambda: torch.matmul(a_d, bt_d.T).view(-1)[flat_d],
                       max(it // 2, 10))
            print(f"dot+extract: {ms:.4f} ms  "
                  f"{gflops(nnz, k, ms):.0f} GFLOPS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
