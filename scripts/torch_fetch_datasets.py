#!/usr/bin/env python3
"""Dataset filter and offline suite, with the PyTorch port's own loaders
and generators: the counterpart of the offline subcommands of
scripts/fetch_datasets.py (``filter``, ``synth``), importing nothing of
JAX.  Its download subcommands (``suitesparse``, ``dlmc``) are not carried:
they fetch from the network.

Subcommands:
    filter DIR [--min-dim 10000] [--min-nnz 100000] [--move-to EXCLUDED]
    synth --out DIR                    # the four-regime suite bench.py runs

The filter mirrors exclude_invalid_dataset.py:46-49 (keep m,n >= 10000 and
nnz >= 100000) and moves rather than rewrites.  Both are host work;
``--device`` is checked as in every harness script (the card unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def filter_dir(root: Path, min_dim: int, min_nnz: int, move_to):
    """Keep matrices with m,n >= min_dim and nnz >= min_nnz (reference
    exclude_invalid_dataset.py:46-49)."""
    from sddmm_tpu_torch.data import io

    excluded = []
    for path in sorted(root.rglob("*")):
        if path.suffix not in (".mtx", ".smtx", ".txt"):
            continue
        try:
            csr = io.load(path)
            ok = csr.m >= min_dim and csr.n >= min_dim and \
                csr.nnz >= min_nnz
        except Exception as e:
            print(f"{path}: unreadable ({e}) -> excluded")
            ok = False
        if not ok:
            excluded.append(path)
    if move_to:
        dest = root / move_to
        dest.mkdir(exist_ok=True)
        for p in excluded:
            p.rename(dest / p.name)
        print(f"moved {len(excluded)} matrices to {dest}")
    else:
        for p in excluded:
            print(f"would exclude {p}")
    return excluded


def synth(out: Path):
    from sddmm_tpu_torch.data import generate, io

    out.mkdir(parents=True, exist_ok=True)
    suite = {
        "clustered16": generate.block_clustered(
            1024, 1024, block_prob=0.008, block_density=0.65,
            noise_density=0.00001, seed=42),
        "clustered128": generate.block_clustered(
            128, 128, group_rows=128, group_cols=128, block_prob=0.025,
            block_density=0.3, noise_density=0.00001, seed=43),
        "powerlaw": generate.powerlaw_graph(32768, avg_degree=40, seed=44),
        "banded": generate.banded(24576, 24576, bandwidth=45, fill=0.55,
                                  seed=45),
    }
    for name, csr in suite.items():
        io.save_mtx(out / f"{name}.mtx", csr)
        print(f"wrote {out / (name + '.mtx')} "
              f"({csr.m}x{csr.n}, nnz={csr.nnz})")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("filter")
    f.add_argument("dir", type=Path)
    f.add_argument("--min-dim", type=int, default=10000)
    f.add_argument("--min-nnz", type=int, default=100000)
    f.add_argument("--move-to", default=None)
    y = sub.add_parser("synth")
    y.add_argument("--out", type=Path, default=Path("dataset/synth"))
    args = p.parse_args(argv)

    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    if args.cmd == "filter":
        filter_dir(args.dir, args.min_dim, args.min_nnz, args.move_to)
    elif args.cmd == "synth":
        synth(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
