#!/usr/bin/env python3
"""Paper-figure plotters over the PyTorch port's logs: the counterpart of
scripts/plot_results.py, importing nothing of JAX.

Python re-design of the reference's scripts/plot_sddmm.py (fig 5:
GFLOPS-vs-NNZ rolling curves), plot_hybrid.py (fig 5b: hybrid vs
single-path), plot_reordering.py (fig 6: reordering quality) and
plot_reordering_overhead.py (fig 7: preprocessing cost), driven by the
``[key : value]`` logs that ``python -m sddmm_tpu_torch.cli`` and
scripts/torch_run_baselines.py write and torch_analyze_results.py
aggregates.  Plotting is an offline step: matplotlib is imported when a
figure is drawn, not when the module is; ``--device`` is checked as in
every harness script (the card unless ``--device cpu``).

Usage:
    python scripts/torch_plot_results.py sddmm LOGDIR [--k 128] \
        [--out fig5.png] [--device cpu]
    python scripts/torch_plot_results.py hybrid LOGDIR [--k 128]
    python scripts/torch_plot_results.py reordering LOGDIR [--k 128]
    python scripts/torch_plot_results.py overhead LOGDIR [--k 128]
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_analyze_results import collect, _META_KEYS  # noqa: E402

# Validated categorical palette (fixed slot order — never cycled).
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300"]
GRID = dict(color="#d9d8d0", linewidth=0.6)


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax, xlabel, ylabel, title):
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title, fontsize=11)
    ax.grid(True, **GRID)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)


def _tools(table):
    return sorted({t for row in table.values() for t in row
                   if t not in _META_KEYS})


def plot_sddmm(table, k, out):
    """Rolling-window geomean GFLOPS vs NNZ per tool (reference
    plot_sddmm.py: filters 1e5 <= NNZ <= 2e6, window curves)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=150)
    tools = _tools(table)
    for i, tool in enumerate(tools):
        pts = [(row["NNZ"], row[tool]) for row in table.values()
               if tool in row and "NNZ" in row and row[tool] > 0]
        if not pts:
            continue
        pts.sort()
        x = np.array([p[0] for p in pts])
        y = np.array([p[1] for p in pts])
        if len(x) >= 8:  # rolling geomean window over nnz-sorted runs
            w = max(3, len(x) // 8)
            ylog = np.log(y)
            ys = np.exp(np.convolve(ylog, np.ones(w) / w, mode="valid"))
            xs = x[w - 1:]
        else:
            xs, ys = x, y
        color = PALETTE[i % len(PALETTE)]
        ax.plot(xs, ys, color=color, linewidth=1.8, label=tool)
        ax.plot(x, y, ".", color=color, markersize=4, alpha=0.35)
    ax.set_xscale("log")
    _style(ax, "NNZ", "GFLOPS", f"SDDMM throughput, K={k}")
    ax.legend(frameon=False, fontsize=9)
    fig.tight_layout()
    fig.savefig(out)
    print(f"wrote {out}")


def plot_hybrid(table, k, out):
    """Hybrid vs tensor-only vs residual-only per matrix (reference
    results_hybrid CSV, analyze_results.cpp:1127-1134).  Expects logs for
    runs tagged bsmr / bsmr_dense_only / bsmr_residual_only."""
    plt = _pyplot()
    want = [t for t in ("bsmr", "bsmr_dense_only", "bsmr_residual_only")
            if any(t in row for row in table.values())]
    if len(want) < 2:
        want = _tools(table)[:3]
    matrices = sorted(m for m, row in table.items()
                      if any(t in row for t in want))
    fig, ax = plt.subplots(figsize=(max(6, 0.8 * len(matrices) + 2), 4),
                           dpi=150)
    width = 0.8 / max(len(want), 1)
    xs = np.arange(len(matrices))
    for i, tool in enumerate(want):
        vals = [table[m].get(tool, 0.0) for m in matrices]
        ax.bar(xs + i * width, vals, width * 0.92,
               color=PALETTE[i % len(PALETTE)], label=tool, linewidth=0)
    ax.set_xticks(xs + width * (len(want) - 1) / 2)
    ax.set_xticklabels(matrices, rotation=30, ha="right", fontsize=8)
    _style(ax, "", "GFLOPS", f"Hybrid vs single-path, K={k}")
    ax.legend(frameon=False, fontsize=9)
    fig.tight_layout()
    fig.savefig(out)
    print(f"wrote {out}")


def plot_reordering(table, k, out):
    """Dense-block count and density, reordered vs original (fig 6)."""
    plt = _pyplot()
    rows = [(m, r) for m, r in sorted(table.items())
            if "bsmr_numDenseBlock" in r]
    if not rows:
        print("no reordering metadata in logs", file=sys.stderr)
        return
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.8), dpi=150)
    names = [m for m, _ in rows]
    xs = np.arange(len(names))
    for ax, key, okey, label in (
            (axes[0], "bsmr_numDenseBlock", "original_numDenseBlock",
             "# dense blocks"),
            (axes[1], "bsmr_averageDensity", "original_averageDensity",
             "avg block density")):
        rv = [r.get(key, 0) for _, r in rows]
        ov = [r.get(okey, 0) for _, r in rows]
        ax.bar(xs - 0.2, ov, 0.37, color=PALETTE[1], label="original",
               linewidth=0)
        ax.bar(xs + 0.2, rv, 0.37, color=PALETTE[0], label="BSMR",
               linewidth=0)
        ax.set_xticks(xs)
        ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
        _style(ax, "", label, label)
        ax.legend(frameon=False, fontsize=9)
    fig.suptitle(f"Reordering quality, K={k}", fontsize=11)
    fig.tight_layout()
    fig.savefig(out)
    print(f"wrote {out}")


def plot_overhead(table, k, out):
    """Reordering time vs NNZ, plus cluster counts (fig 7)."""
    plt = _pyplot()
    rows = [(m, r) for m, r in sorted(table.items())
            if "bsmr_rowReordering" in r and "NNZ" in r]
    if not rows:
        print("no overhead metadata in logs", file=sys.stderr)
        return
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.8), dpi=150)
    nnz = np.array([r["NNZ"] for _, r in rows])
    o = np.argsort(nnz)
    nnz = nnz[o]
    rr = np.array([r["bsmr_rowReordering"] for _, r in rows])[o]
    cr = np.array([r.get("bsmr_colReordering", 0) for _, r in rows])[o]
    cl = np.array([r.get("bsmr_numClusters", 0) for _, r in rows])[o]
    axes[0].plot(nnz, rr, "o-", color=PALETTE[0], linewidth=1.8,
                 markersize=4, label="row reordering")
    axes[0].plot(nnz, cr, "o-", color=PALETTE[1], linewidth=1.8,
                 markersize=4, label="col reordering")
    axes[0].set_xscale("log")
    axes[0].set_yscale("log")
    _style(axes[0], "NNZ", "time (ms)", "Reordering overhead")
    axes[0].legend(frameon=False, fontsize=9)
    axes[1].plot(nnz, cl, "o-", color=PALETTE[2], linewidth=1.8,
                 markersize=4)
    axes[1].set_xscale("log")
    _style(axes[1], "NNZ", "# clusters", "Cluster counts")
    fig.suptitle(f"BSMR preprocessing, K={k}", fontsize=11)
    fig.tight_layout()
    fig.savefig(out)
    print(f"wrote {out}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("figure",
                   choices=["sddmm", "hybrid", "reordering", "overhead"])
    p.add_argument("log_dir", type=Path)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    table = collect(args.log_dir, args.k)
    if not table:
        print(f"no logs with K={args.k} under {args.log_dir}",
              file=sys.stderr)
        return 1
    out = args.out or args.log_dir / f"fig_{args.figure}_{args.k}.png"
    {"sddmm": plot_sddmm, "hybrid": plot_hybrid,
     "reordering": plot_reordering, "overhead": plot_overhead}[
        args.figure](table, args.k, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
