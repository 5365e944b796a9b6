#!/usr/bin/env python3
"""Matched-statistics clones of named SuiteSparse matrices, with the
PyTorch port's own sparse types and writers: the counterpart of
scripts/make_matched_clones.py, importing nothing of JAX.

The reference's performance claim rests on 503 real SuiteSparse matrices
(per-matrix name, M, N, NNZ and BSMR GFLOPS on an RTX 4090).  The real
matrices cannot be fetched here, so for a family-spanning subset of NAMED
reference matrices this script synthesizes a clone with

- the exact same (M, N) and NNZ within ~3%, and
- a structure class inferred from the matrix's domain (FEM/structural
  -> banded mesh; citation/co-author graph -> power-law; optimal power
  flow / Jacobian -> planted dense blocks; 'appu'-style random ->
  uniform),

writes them as .smtx plus a manifest carrying the reference's measured
per-matrix BSMR GFLOPS (RTX 4090), so scripts/torch_run_baselines.py +
scripts/torch_matched_clone_report.py give a per-matrix
reference-vs-port column.  Each clone's (m, n, nnz, ref_bsmr_gflops) is
read from the committed results/matched_clones_manifest.json (18 clones;
the JAX script read them from the reference's results CSV, which is not
in this repository).  Generation is host work; ``--device`` is checked as
in every harness script (the card unless ``--device cpu``).

Usage: python scripts/torch_make_matched_clones.py /tmp/matched_clones
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from sddmm_tpu_torch.data import io
from sddmm_tpu_torch.data.sparse import COO

#: each clone's reference sizes and GFLOPS (the JAX script's output)
REF_MANIFEST = (Path(__file__).resolve().parent.parent / "results"
                / "matched_clones_manifest.json")

# name -> (class, class params); sizes come from REF_MANIFEST
RECIPES = {
    "ca-AstroPh": ("powerlaw", {}),       # co-author graph
    "HEP-th": ("powerlaw", {}),           # citation graph
    "c-63": ("powerlaw", {}),             # optimization, skewed degrees
    "FEM_3D_thermal1": ("banded", {}),    # FEM mesh
    "Pres_Poisson": ("banded", {}),       # pressure Poisson mesh
    "Goodwin_040": ("banded", {}),        # fluid FEM
    "cage11": ("banded", {}),             # electrophoresis chain
    "bcsstk32": ("block", {"bs": 16}),    # structural stiffness
    "TSOPF_RS_b300_c1": ("block", {"bs": 128}),  # power flow, dense blk
    "TSOPF_FS_b162_c3": ("block", {"bs": 64}),
    "Zd_Jac2": ("block", {"bs": 32}),     # chemistry Jacobian
    "appu": ("uniform", {}),              # random-like benchmark
    # batch 2 (round-5 window): larger + more families
    "Ga3As3H12": ("block", {"bs": 32}),   # DFT chemistry, 3M nnz
    "F2": ("block", {"bs": 16}),          # structural, 2.7M nnz
    "G_n_pin_pout": ("uniform", {}),      # random graph benchmark
    "ASIC_100ks": ("powerlaw", {}),       # circuit netlist, skewed
    "LeGresley_87936": ("powerlaw", {}),  # power grid, hub buses
    "Chevron2": ("banded", {}),           # seismic FEM mesh
}


def ref_rows():
    """name -> the reference matrix's m, n, nnz and RTX 4090 BSMR GFLOPS,
    in the manifest's order."""
    manifest = json.loads(REF_MANIFEST.read_text())
    out = {}
    for clone, rec in manifest.items():
        name = clone[len("clone_"):]
        if name in RECIPES:
            out[name] = {key: rec[key]
                         for key in ("m", "n", "nnz", "ref_bsmr_gflops")}
    return out


def gen_class(cls: str, m: int, n: int, nnz: int, seed: int,
              params: dict) -> COO:
    rng = np.random.default_rng(seed)
    if cls == "uniform":
        flat = rng.choice(m * n, size=min(nnz, m * n), replace=False)
        return COO((m, n), (flat // n).astype(np.int64),
                   (flat % n).astype(np.int64),
                   rng.random(len(flat)).astype(np.float32))
    if cls == "banded":
        fill = 0.6
        bw = max(1, int(round(nnz / (m * 2 * fill))))
        r = np.repeat(np.arange(m, dtype=np.int64), 2 * bw + 1)
        c = r + np.tile(np.arange(-bw, bw + 1, dtype=np.int64), m)
        ok = (c >= 0) & (c < n)
        r, c = r[ok], c[ok]
        keep = rng.random(len(r)) < min(1.0, nnz / len(r))
        r, c = r[keep], c[keep]
        return COO((m, n), r, c, rng.random(len(r)).astype(np.float32))
    if cls == "powerlaw":
        avg = nnz / m
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = ranks ** (-1.0 / 1.1)
        w /= w.sum()
        deg = rng.poisson(avg * w * m / (avg * w * m).mean() * avg * 1.15)
        deg = np.clip(deg, 0, n - 1)
        r = np.repeat(np.arange(m, dtype=np.int64), deg)
        c = rng.choice(n, size=len(r), p=w)
        keys = r * n + c
        _, uniq = np.unique(keys, return_index=True)
        r, c = r[uniq], c[uniq]
        return COO((m, n), r, c, rng.random(len(r)).astype(np.float32))
    if cls == "block":
        bs = params.get("bs", 16)
        gr, gc = -(-m // bs), -(-n // bs)
        dens = 0.7
        want_blocks = nnz / (bs * bs * dens)
        prob = min(1.0, want_blocks / (gr * gc))
        act = rng.random((gr, gc)) < prob
        gi, gj = np.nonzero(act)
        rs, cs = [], []
        for bi, bj in zip(gi, gj):
            mask = rng.random((bs, bs)) < dens
            rr, cc = np.nonzero(mask)
            rs.append(bi * bs + rr)
            cs.append(bj * bs + cc)
        r = np.concatenate(rs).astype(np.int64) if rs else \
            np.zeros(0, np.int64)
        c = np.concatenate(cs).astype(np.int64) if cs else \
            np.zeros(0, np.int64)
        ok = (r < m) & (c < n)
        r, c = r[ok], c[ok]
        return COO((m, n), r, c, rng.random(len(r)).astype(np.float32))
    raise ValueError(cls)


def calibrated(cls, m, n, nnz, params):
    """One corrective iteration: scale the target so the realized nnz
    lands within ~3% of the reference count."""
    target = nnz
    for attempt in range(4):
        coo = gen_class(cls, m, n, target, seed=11 + attempt, params=params)
        got = len(coo.rows)
        if abs(got - nnz) <= 0.03 * nnz:
            return coo
        target = int(target * nnz / max(got, 1))
    return coo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir", type=Path)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, rec in ref_rows().items():
        cls, params = RECIPES[name]
        coo = calibrated(cls, rec["m"], rec["n"], rec["nnz"], params)
        csr = coo.to_csr()
        path = args.out_dir / f"clone_{name}.smtx"
        io.save_smtx(path, csr)
        manifest[f"clone_{name}"] = dict(
            rec, clone_class=cls, clone_nnz=csr.nnz,
            nnz_match=round(csr.nnz / rec["nnz"], 3))
        print(f"{name}: {cls} m={rec['m']} n={rec['n']} "
              f"nnz {csr.nnz}/{rec['nnz']} "
              f"({csr.nnz / rec['nnz']:.1%}) ref_bsmr="
              f"{rec['ref_bsmr_gflops']}")
    (args.out_dir / "manifest.json").write_text(
        json.dumps(manifest, indent=1))
    print(f"wrote {len(manifest)} clones + manifest to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
