#!/usr/bin/env python3
"""Run the PyTorch port's CLI over a directory of matrix files: the
counterpart of scripts/run_bench_suite.py, importing nothing of JAX.

Loops every matrix file under a directory, runs
``sddmm_tpu_torch.cli`` at each K (or its alpha/delta/K test mode with
``--sweep``) on ``--device`` (the card unless ``--device cpu``), and
writes the per-run logs (``<LOG_DIR>/<matrix>/BSMR_torch_k_<K>.log``)
that scripts/torch_analyze_results.py aggregates.

Usage:
    python scripts/torch_run_bench_suite.py MATRIX_DIR LOG_DIR \\
        [--ks 32 128] [--sweep]   # --sweep = the full alpha/delta test mode
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("matrix_dir", type=Path)
    p.add_argument("log_dir", type=Path)
    p.add_argument("--ks", type=int, nargs="+", default=[32, 64, 128, 256])
    p.add_argument("--sweep", action="store_true",
                   help="full alpha x delta x K test mode per matrix")
    p.add_argument("--compute-dtype", default="float32")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch import cli
    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    files = sorted(
        f for suffix in ("*.mtx", "*.smtx", "*.txt")
        for f in args.matrix_dir.rglob(suffix))
    if not files:
        print(f"no matrix files under {args.matrix_dir}", file=sys.stderr)
        return 1
    args.log_dir.mkdir(parents=True, exist_ok=True)

    dev = ["--device", args.device]
    for i, f in enumerate(files):
        print(f"[{i + 1}/{len(files)}] {f.name}", file=sys.stderr)
        t0 = time.perf_counter()
        sub = args.log_dir / f.stem
        if args.sweep:
            cli_args = ["-f", str(f), "-t", "1", "-l", str(sub)]
        else:
            cli_args = ["-f", str(f), "-l", str(sub)]
            for k in args.ks:
                cli.main(cli_args + ["-k", str(k),
                                     "--compute-dtype", args.compute_dtype]
                         + (["--validate"] if args.validate else []) + dev)
            print(f"   done in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
            continue
        cli.main(cli_args + ["--compute-dtype", args.compute_dtype] + dev)
        print(f"   done in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
