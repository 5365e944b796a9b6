#!/usr/bin/env python3
"""Aggregate per-run ``[key : value]`` log files into results CSVs, with
the PyTorch port's log parser: the counterpart of
scripts/analyze_results.py, importing nothing of JAX.

Python re-design of the reference's scripts/analyze_results.cpp (1386 LoC
of hand-rolled parsing): reads a directory tree of log files produced by
``python -m sddmm_tpu_torch.cli`` or scripts/torch_run_baselines.py (or
either package's, or the reference binary's — same schema), computes
per-matrix GFLOPS tables and speedups, and writes ``results_<K>.csv`` with
one row per matrix and one column per tool, matching the reference's CSV
layout (analyze_results.cpp:789-796).  Reading logs is host work;
``--device`` is checked as in every harness script (the card unless
``--device cpu``).

Usage:
    python scripts/torch_analyze_results.py LOGDIR [--k 128] \
        [--out results.csv] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import math
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sddmm_tpu_torch.utils.logger import parse_log  # noqa: E402


_META_KEYS = ("bsmr_numClusters", "bsmr_numDenseBlock",
              "bsmr_averageDensity", "bsmr_rowReordering",
              "bsmr_colReordering", "NNZ")


def collect(log_dir: Path, k: int):
    """-> {matrix: {tool: gflops}} from all logs under log_dir."""
    table = defaultdict(dict)
    for path in sorted(log_dir.rglob("*.log")):
        entries = parse_log(path.read_text(),
                            prefer_nonzero=("_gflops", "Reordering",
                                            "numClusters",
                                            "numDenseBlock",
                                            "averageDensity"))
        if not entries or "File" not in entries:
            continue
        if int(float(entries.get("K", 0))) != k:
            continue
        matrix = Path(entries["File"]).stem
        for key, val in entries.items():
            if key.endswith("_gflops"):
                tool = key[: -len("_gflops")]
                try:
                    fval = float(val)
                except ValueError:
                    continue
                # merged multi-pass logs: a pass that didn't run this
                # tool emits a 0.0 placeholder (logger schema parity);
                # never let it clobber a real measurement
                if fval > 0.0 or tool not in table[matrix]:
                    table[matrix][tool] = fval
        # carry reordering metadata for the overhead figures
        for meta in _META_KEYS:
            if meta in entries:
                try:
                    table[matrix][meta] = float(entries[meta])
                except ValueError:
                    pass
    return table


def write_csv(table, out_path: Path):
    tools = sorted({t for row in table.values() for t in row})
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["matrix"] + tools)
        for matrix in sorted(table):
            w.writerow([matrix] + [table[matrix].get(t, "")
                                   for t in tools])


def geomean_speedups(table):
    """Geomean speedup of every tool vs every other (reference's summary)."""
    tools = sorted({t for row in table.values() for t in row
                    if t not in _META_KEYS})
    out = {}
    for a in tools:
        for b in tools:
            if a == b:
                continue
            logs = [math.log(row[a] / row[b]) for row in table.values()
                    if row.get(a) and row.get(b)]
            if logs:
                out[(a, b)] = math.exp(sum(logs) / len(logs))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("log_dir", type=Path)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    p.add_argument("--hybrid", action="store_true",
                   help="also write results_hybrid_<K>.csv (BSMR vs "
                   "dense-only vs residual-only, the reference's "
                   "results_hybrid layout)")
    args = p.parse_args(argv)

    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    table = collect(args.log_dir, args.k)
    if not table:
        print(f"no logs with K={args.k} found under {args.log_dir}",
              file=sys.stderr)
        return 1
    out = args.out or args.log_dir / f"results_{args.k}.csv"
    write_csv(table, out)
    if args.hybrid:
        hcols = ("bsmr", "bsmr_dense_only", "bsmr_residual_only")
        htable = {m: {t: row[t] for t in hcols if t in row}
                  for m, row in table.items()}
        htable = {m: r for m, r in htable.items() if r}
        hout = out.parent / f"results_hybrid_{args.k}.csv"
        write_csv(htable, hout)
        print(f"wrote {hout} ({len(htable)} matrices)")
    print(f"wrote {out} ({len(table)} matrices)")
    for (a, b), s in sorted(geomean_speedups(table).items()):
        print(f"  geomean {a} vs {b}: {s:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
