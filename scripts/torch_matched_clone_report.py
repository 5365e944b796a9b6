#!/usr/bin/env python3
"""Per-matrix reference-vs-port table for the matched clones: the
counterpart of scripts/matched_clone_report.py, importing nothing of JAX.

Joins the clone manifest (torch_make_matched_clones.py — each named
SuiteSparse matrix's BSMR GFLOPS as the reference paper measured it on an
RTX 4090) with the torch_run_baselines.py logs measured on the card, and
writes results/torch_matched_clones.csv:

  name, class, m, n, nnz_ref, nnz_clone, ref_bsmr_gflops_4090,
  card_bsmr_gflops, card_csr_gflops, device, ratio_vs_ref

``device`` is each log's ``Device`` (the card that ran it).
``ratio_vs_ref`` is the card's BSMR GFLOPS on the clone over the
reference's RTX 4090 GFLOPS on the real matrix: a comparison across
cards and across matrices of matched size and structure class, not an
H100 figure of the reference.  Reading logs is host work; ``--device`` is
checked as in every harness script (the card unless ``--device cpu``).

Usage:
    python scripts/torch_matched_clone_report.py /tmp/matched_clones \\
        results/torch_matched_clone_logs --k 128 \\
        -o results/torch_matched_clones.csv
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_log(path: Path) -> dict:
    from sddmm_tpu_torch.utils.logger import parse_log as _parse
    return _parse(path.read_text(),
                  prefer_nonzero=("bsmr_gflops", "csr_gflops"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("clone_dir", type=Path)
    p.add_argument("log_dir", type=Path)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("-o", "--output", type=Path,
                   default=Path("results/torch_matched_clones.csv"))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    manifest = json.loads(
        (args.clone_dir / "manifest.json").read_text())
    rows = []
    import numpy as np
    for clone, rec in sorted(manifest.items()):
        log = args.log_dir / f"{clone}_k{args.k}.log"
        if not log.exists():
            print(f"{clone}: no log yet, skipping")
            continue
        fields = parse_log(log)
        bsmr = float(fields.get("bsmr_gflops", 0.0))
        csrg = float(fields.get("csr_gflops", 0.0))
        rows.append({
            "name": clone.replace("clone_", ""),
            "class": rec["clone_class"], "m": rec["m"], "n": rec["n"],
            "nnz_ref": rec["nnz"], "nnz_clone": rec["clone_nnz"],
            "ref_bsmr_gflops_4090": rec["ref_bsmr_gflops"],
            "card_bsmr_gflops": round(bsmr, 1),
            "card_csr_gflops": round(csrg, 1),
            "device": fields.get("Device", ""),
            "ratio_vs_ref": round(bsmr / rec["ref_bsmr_gflops"], 3)
            if rec["ref_bsmr_gflops"] else None,
        })
    if not rows:
        print("no completed clone logs")
        return 1
    args.output.parent.mkdir(parents=True, exist_ok=True)
    cols = list(rows[0])
    with args.output.open("w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r[c]) for c in cols) + "\n")
    gm = float(np.exp(np.mean(np.log(
        [max(r["card_bsmr_gflops"], 1e-9) for r in rows]))))
    gmr = float(np.exp(np.mean(np.log(
        [max(r["ratio_vs_ref"], 1e-9) for r in rows
         if r["ratio_vs_ref"]]))))
    devices = sorted({r["device"] for r in rows})
    print(f"wrote {args.output} ({len(rows)} clones); "
          f"geomean card_bsmr={gm:.0f} GFLOPS on {', '.join(devices)}, "
          f"geomean ratio vs the reference's RTX 4090 GFLOPS on the named "
          f"matrices={gmr:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
