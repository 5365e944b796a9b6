"""Command-line driver of the PyTorch/CUDA port — the reference's
BSMR-sddmm executable (src/main.cu + src/sddmm.cu) on one card.

Counterpart of ``sddmm_tpu/cli.py``, with the same flags
(include/Options.hpp:52-69): ``-f`` matrix file, ``-k`` K, ``-a`` alpha,
``-d`` delta, ``-t`` test mode, ``-l`` log directory, ``-i`` iterations,
the positional fallback ``FILE [K]``, ``--compute-dtype``, ``--method``,
``--order``, ``--validate`` and ``--tune``; and ``--device`` (the card
unless the caller asks for ``cpu``; without a card the default raises).
A run prints the reference's ``[key : value]`` log (``utils.logger``);
``-l DIR`` also writes it to ``BSMR_torch_k_{K}.log``.  Test mode sweeps
alpha x delta x K (``SWEEP_ALPHAS``, ``SWEEP_DELTAS``, ``SWEEP_KS``),
reusing one row reordering per alpha (reference src/sddmm.cu:62-118), and
appends each cell's log to ``BSMR_k_{K}_a_{alpha}_d_{delta}.log``, the
names scripts/analyze_results.py aggregates.  Kernel times are
``measure_kernel_ms``: CUDA-event time on the card.

Usage:
    python -m sddmm_tpu_torch.cli -f matrix.mtx -k 128 [--validate]
    python -m sddmm_tpu_torch.cli -f matrix.mtx -t 1 -l results/
    python -m sddmm_tpu_torch.cli -f matrix.mtx -k 32 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

from sddmm_tpu_torch import config

#: test mode's grid (reference src/sddmm.cu:62-118)
SWEEP_ALPHAS = (0.1, 0.3, 0.5, 0.7, 0.9)
SWEEP_DELTAS = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.1)
SWEEP_KS = (32, 64, 128, 256)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sddmm_tpu_torch.cli",
        description="BSMR SDDMM (hybrid dense-tile + residual) on the card")
    p.add_argument("file_pos", nargs="?", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("k_pos", nargs="?", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("-f", "--file", default=None, help="matrix file "
                   "(.mtx/.smtx/.txt)")
    p.add_argument("-k", type=int, default=config.DEFAULT_K,
                   help="dense feature dim K")
    p.add_argument("-a", "--alpha", type=float, default=config.DEFAULT_ALPHA,
                   help="row-similarity threshold")
    p.add_argument("-d", "--delta", type=float, default=config.DEFAULT_DELTA,
                   help="block density threshold")
    p.add_argument("-t", "--test-mode", type=int, default=0,
                   help="1 = alpha/delta/K sweep")
    p.add_argument("-l", "--log-dir", default=None,
                   help="directory for log files")
    p.add_argument("-i", "--iterations", type=int,
                   default=config.DEFAULT_NUM_ITERATIONS)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "tf32", "mixed", "float16", "bfloat16"])
    p.add_argument("--method", default="auto",
                   choices=["auto", "greedy", "batched", "none"],
                   help="row clustering algorithm")
    p.add_argument("--order", default="packed", choices=["packed", "csr"],
                   help="output layout timed/produced")
    p.add_argument("--validate", action="store_true",
                   help="check against the CPU golden model")
    p.add_argument("--tune", action="store_true",
                   help="autotune the configuration — strategy (hybrid "
                        "packed vs dense tiling), alpha, delta, G, C — "
                        "instead of the fixed -a/-d; times the shoot-out's "
                        "finalists on the card (the model's pick on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p


def _time_and_check(runner, csr, k, args, log, validate):
    """Time the runner's call (``--order``) into ``log`` and, with
    ``validate``, check CSR order against the fp64 golden model."""
    from sddmm_tpu_torch.data import generate
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    a_pad, bt_pad = runner.prepare_operands(a, b=b)
    log.sddmm_time_ms = runner.measure_kernel_ms(
        a_pad, bt_pad, iterations=max(args.iterations, 10), order=args.order)
    if validate:
        from sddmm_tpu_torch.ops.reference import sddmm_reference
        from sddmm_tpu_torch.utils.check import check_values
        got = runner(a, b, order="csr").detach().cpu().numpy()
        res = check_values(sddmm_reference(a, b, csr), got)
        log.error_rate = res.error_rate
        log.check_passed = res.passed
        print(str(res), file=sys.stderr)


def _packing_log(log, bsmr, packed, t_pack_ms=None):
    """The packing's fields of a RunLog."""
    log.num_row_panels = bsmr.num_row_panels
    log.num_clusters = bsmr.num_clusters
    log.row_reordering_ms = bsmr.row_reordering_ms
    log.col_reordering_ms = bsmr.col_reordering_ms
    if t_pack_ms is not None:
        log.packing_ms = t_pack_ms
    log.num_dense_block = packed.num_blocks
    log.average_density = packed.average_block_density
    log.dense_grid = (packed.num_super, packed.num_quads, packed.num_pairs,
                      packed.num_groups)
    log.sparse_grid = (packed.nnz_res, 0, 0)
    log.num_dense_data = packed.nnz_dense
    log.num_sparse_data = packed.nnz_res


def run_once(csr, k, alpha, delta, args, input_file, device):
    """One full pipeline run; returns the RunLog."""
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    from sddmm_tpu_torch.reorder.bsmr import (BSMR,
                                              original_matrix_block_stats)
    from sddmm_tpu_torch.reorder.pack import pack
    from sddmm_tpu_torch.utils.logger import RunLog, device_name
    from sddmm_tpu_torch.utils.timing import Timer

    bsmr = BSMR(alpha, delta, csr, method=args.method, device=device)
    with Timer() as t_pack:
        packed = pack(csr, bsmr)
    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype,
                         device=device)
    log = RunLog(input_file=str(input_file), device=device_name(device),
                 k=k, alpha=alpha, delta=delta,
                 num_iterations=args.iterations,
                 matrix_a_type=args.compute_dtype,
                 matrix_b_type=args.compute_dtype)
    _packing_log(log, bsmr, packed, t_pack.ms)
    log.tile_k = k
    log.set_matrix(csr)
    ob, od = original_matrix_block_stats(csr, delta)
    log.original_num_dense_block = ob
    log.original_average_density = od
    _time_and_check(runner, csr, k, args, log, args.validate)
    return log


def run_tuned(csr, k, args, input_file, device):
    """Autotuned pipeline run: the layout model ranks, and on the card the
    shoot-out's finalists are timed (``reorder.autotune``); the dense class
    (``ops.dense``) competes at DLMC densities."""
    from sddmm_tpu_torch.reorder.autotune import autotune
    from sddmm_tpu_torch.utils.logger import RunLog, device_name
    from sddmm_tpu_torch.utils.timing import Timer

    with Timer() as t_tune:
        tuned = autotune(csr, k=k, compute_dtype=args.compute_dtype,
                         method=args.method,
                         measure=device.type == "cuda", device=device)
    if tuned.dense:
        from sddmm_tpu_torch.ops.dense import DenseSDDMM
        runner = DenseSDDMM.from_csr(csr, compute_dtype=args.compute_dtype,
                                     device=device)
    else:
        from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
        runner = HybridSDDMM(tuned.packed, compute_dtype=args.compute_dtype,
                             k_chunks=tuned.k_chunks,
                             use_pallas=tuned.use_pallas,
                             a_layout=tuned.a_layout, device=device)
    log = RunLog(input_file=str(input_file), device=device_name(device),
                 k=k, alpha=tuned.alpha, delta=tuned.delta,
                 num_iterations=args.iterations,
                 matrix_a_type=args.compute_dtype,
                 matrix_b_type=args.compute_dtype,
                 packing_ms=t_tune.ms)
    log.tile_k = k
    log.set_matrix(csr)
    if tuned.packed is not None:
        _packing_log(log, tuned.bsmr, tuned.packed)
    print(f"[tuned strategy : {'dense' if tuned.dense else 'hybrid'}] "
          f"[a={tuned.alpha} d={tuned.delta} G={tuned.group_size} "
          f"C={tuned.k_chunks} H={tuned.hub_cols} "
          f"pallas={tuned.use_pallas} aL={tuned.a_layout}]",
          file=sys.stderr)
    _time_and_check(runner, csr, k, args, log, args.validate)
    return log


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # Positional fallback: argv[1]=file [argv[2]=K] (reference
    # include/Options.hpp:120-123).
    if args.file is None:
        if args.file_pos is None:
            parser.error("matrix file required (-f or positional)")
        args.file = args.file_pos
        if args.k_pos is not None:
            try:
                args.k = int(args.k_pos)
            except ValueError:
                parser.error(f"positional K must be an integer, got "
                             f"{args.k_pos!r}")
    elif args.file_pos is not None:
        parser.error("cannot mix -f with positional arguments")
    from sddmm_tpu_torch.data import io
    from sddmm_tpu_torch.ops.hybrid import check_device
    from sddmm_tpu_torch.reorder.bsmr import BSMR
    from sddmm_tpu_torch.utils.util import to_trimmed_string

    device = check_device(args.device)
    csr = io.load(args.file)
    log_dir = Path(args.log_dir) if args.log_dir else None
    if log_dir:
        log_dir.mkdir(parents=True, exist_ok=True)

    if not args.test_mode:
        if args.tune:
            log = run_tuned(csr, args.k, args, args.file, device)
        else:
            log = run_once(csr, args.k, args.alpha, args.delta, args,
                           args.file, device)
        text = log.print_log(sys.stdout)
        if log_dir:
            (log_dir / f"BSMR_torch_k_{args.k}.log").write_text(text)
        return 0

    # Test mode: alpha x delta x K sweep, reusing the row reordering per
    # alpha (reference src/sddmm.cu:64-89 reuses bsmr.rowReordering).
    for alpha in SWEEP_ALPHAS:
        shared = BSMR(alpha, 0.0, csr, method=args.method, compute=False,
                      device=device)
        shared.run_row_reordering(csr)
        for delta in SWEEP_DELTAS:
            for k in SWEEP_KS:
                log = _run_sweep_cell(csr, shared, k, alpha, delta, args,
                                      device)
                name = (f"BSMR_k_{k}_a_{to_trimmed_string(alpha)}"
                        f"_d_{to_trimmed_string(delta)}.log")
                text = log.print_log()
                if log_dir:
                    with open(log_dir / name, "a") as f:
                        f.write(text)
                else:
                    sys.stdout.write(f"=== {name} ===\n{text}")
    return 0


def _run_sweep_cell(csr, shared_bsmr, k, alpha, delta, args, device):
    """One sweep cell reusing the shared row reordering."""
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    from sddmm_tpu_torch.reorder.pack import pack
    from sddmm_tpu_torch.utils.logger import RunLog, device_name
    from sddmm_tpu_torch.utils.timing import Timer

    bsmr = copy.copy(shared_bsmr)
    bsmr.run_col_reordering(csr, delta=delta)
    with Timer() as t_pack:
        packed = pack(csr, bsmr)
    runner = HybridSDDMM(packed, compute_dtype=args.compute_dtype,
                         device=device)
    log = RunLog(input_file=str(args.file), device=device_name(device),
                 k=k, alpha=alpha, delta=delta,
                 num_iterations=args.iterations)
    _packing_log(log, bsmr, packed, t_pack.ms)
    log.tile_k = k
    log.set_matrix(csr)
    _time_and_check(runner, csr, k, args, log, validate=False)
    return log


if __name__ == "__main__":
    sys.exit(main())
