"""The CSR SpMM's panel path against its row groups on the card.

Times one launch (CUDA events over many) of ``ops/spmm.py::spmm_launch``
under the pattern's plan with panels and with the panel path off
(``SPMM_PANEL_REUSE`` infinite: the row groups and long rows alone), on:

- the benchmark cells' SpMMs: Longformer-base's aggregation (12 heads a
  launch with a head stride over one copy of the mask, K = 64) and V's
  gradient (the transpose read through ``vidx``, 12 heads a launch),
  MiMo-V2-Flash's full (causal) and window-128 layers' aggregation (64
  query heads over 4 or 8 V heads, K = 128) and V's gradient (the
  group's query heads summed);
- a sweep of banded patterns whose rows keep a share of a 512-column band
  at random (K = 64 and 128, 12 heads a launch with a head stride over
  one copy of the pattern), from which the break-even reuse
  (entries over distinct columns a panel) of ``SPMM_PANEL_REUSE`` is read.

Prints one JSON line per case and the card's name and power limit.  Run on
the card::

    python scripts/spmm_panel_sweep.py [--cells] [--sweep] [--reps N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sddmm_tpu_torch.models.block_sparse_attention import \
    make_attention_mask  # noqa: E402
from sddmm_tpu_torch.ops import spmm as sp  # noqa: E402


def causal(L, window=None):
    """(row_ptr, cols) of a causal mask, or of its window of keys."""
    lo = np.arange(L) - (L if window is None else window - 1)
    lo = np.maximum(lo, 0)
    lengths = np.arange(L) + 1 - lo
    row_ptr = np.r_[0, np.cumsum(lengths)]
    cols = np.arange(row_ptr[-1]) - np.repeat(row_ptr[:-1] - lo, lengths)
    return row_ptr, cols


def band(L, width, share, seed):
    """Each row keeps each column of its band of ``width`` at random with
    probability ``share`` (at least one)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(L):
        c = np.arange(max(0, i - width // 2), min(L, i + width // 2))
        keep = c[rng.random(len(c)) < share]
        rows.append(keep if len(keep) else c[:1])
    return np.r_[0, np.cumsum([len(r) for r in rows])], np.concatenate(rows)


def transpose(row_ptr, cols, n):
    """SpmmPattern's arguments for the transpose of (row_ptr, cols)."""
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    return cols, rows, n


def plan_of(row_ptr, cols, panels: bool):
    keep = sp.SPMM_PANEL_REUSE
    sp.SPMM_PANEL_REUSE = keep if panels else float("inf")
    try:
        return sp.spmm_plan(row_ptr, cols)
    finally:
        sp.SPMM_PANEL_REUSE = keep


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def case(name, row_ptr, cols, n, H, Hd, Ho, K, reps, vidx=None, seed=0):
    """Time spmm_launch over (row_ptr, cols) with and without panels."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    nnz = len(cols)
    values = torch.rand((H, nnz), device=dev, generator=gen)
    dense = torch.randn((Hd, 1, n, K), device=dev, generator=gen)
    m = len(row_ptr) - 1
    rp = torch.as_tensor(row_ptr, device=dev)
    cc = torch.as_tensor(cols, dtype=torch.int32, device=dev)
    vi = None if vidx is None else torch.as_tensor(vidx, dtype=torch.int32,
                                                   device=dev)
    res = {"case": name, "m": m, "nnz": nnz, "K": K, "H": H, "Hd": Hd,
           "Ho": Ho}
    outs = {}
    for panels in (True, False):
        host = plan_of(row_ptr, cols, panels)
        plan = host.to(dev)
        out = torch.empty((Ho, 1, m, K), device=dev)

        def run():
            sp.spmm_launch(plan, rp, cc, values, dense, out, vi)
        key = "panel" if panels else "groups"
        res[f"{key}_ms"] = time_ms(run, reps)
        outs[key] = out.clone()
        if panels:
            res["panel_share"] = host.panel_entries / nnz
            res["panels"] = len(host.panels)
            res["chunk_cols"] = int((host.chunk_cols >= 0).sum())
            res["tasks_left"] = len(host.tasks)
            if len(host.tasks) and len(host.panels):
                # the leftover row groups' launch alone, and the panels'
                rest = plan_of_parts(host, panels=False).to(dev)
                res["left_ms"] = time_ms(lambda: sp.spmm_launch(
                    rest, rp, cc, values, dense, out, vi), reps)
                only = plan_of_parts(host, tasks=False).to(dev)
                res["panels_only_ms"] = time_ms(lambda: sp.spmm_launch(
                    only, rp, cc, values, dense, out, vi), reps)
    res["speedup"] = res["groups_ms"] / res["panel_ms"]
    a, b = outs["panel"].double(), outs["groups"].double()
    res["rel_norm_diff"] = float((a - b).norm() / b.norm())
    res["products_T_per_s"] = H * nnz * K / res["panel_ms"] / 1e9
    if res["chunk_cols"]:
        res["reuse"] = nnz / res["chunk_cols"]
    print(json.dumps(res), flush=True)
    return res


def plan_of_parts(plan, panels=True, tasks=True):
    """The plan with its panels or its row-group tasks left out."""
    import dataclasses
    empty = {"panels": np.zeros((0, 2), np.int64),
             "panel_rows": np.zeros((0, sp.SPMM_PANEL_ROWS), np.int64)}
    kw = {} if panels else empty
    if not tasks:
        kw["tasks"] = np.zeros((0, 2), np.int64)
    return dataclasses.replace(plan, **kw)


def cells(reps):
    mask = make_attention_mask(4096, window=256, num_global=1)
    case("longformer.forward", mask.row_ptr, mask.col_idx, mask.n, 12, 12,
         12, 64, reps)
    t = sp.SpmmPattern(*transpose(mask.row_ptr, mask.col_idx, mask.n),
                       "cpu")
    vidx = None if t.vidx is None else t.vidx.numpy()
    case("longformer.dV", t._host[0], t._host[1], mask.m, 12, 12, 12, 64,
         reps, vidx)
    for kind, window, kv in (("full", None, 4), ("window", 128, 8)):
        row_ptr, cols = causal(4096, window)
        case(f"mimo.{kind}.forward", row_ptr, cols, 4096, 64, kv, 64, 128,
             max(2, reps // 4))
        t = sp.SpmmPattern(*transpose(row_ptr, cols, 4096), "cpu")
        vidx = None if t.vidx is None else t.vidx.numpy()
        case(f"mimo.{kind}.dV", t._host[0], t._host[1], 4096, 64, 64, kv,
             128, max(2, reps // 4), vidx)


def sweep(reps):
    for K in (64, 128):
        for share in (0.03, 0.06, 0.1, 0.15, 0.2, 0.3, 0.45, 0.7, 1.0):
            row_ptr, cols = band(4096, 512, share, seed=int(share * 100))
            keep = sp.SPMM_PANEL_REUSE
            sp.SPMM_PANEL_REUSE = 0.0
            try:
                case(f"band.{share}", row_ptr, cols, 4096, 12, 12, 12, K,
                     reps)
            finally:
                sp.SPMM_PANEL_REUSE = keep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmm_panel_sweep: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "threshold": sp.SPMM_PANEL_REUSE}),
          flush=True)
    if args.cells or not args.sweep:
        cells(args.reps)
    if args.sweep:
        sweep(args.reps)


if __name__ == "__main__":
    main()
