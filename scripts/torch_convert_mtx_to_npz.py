#!/usr/bin/env python3
"""Convert .mtx/.smtx/.txt matrices to the FlashSparse-style .npz graph
format (reference scripts/convert_mtx_to_npz.py) with the PyTorch port's
own loaders: the counterpart of scripts/convert_mtx_to_npz.py, importing
nothing of JAX.  Conversion is host work; ``--device`` is checked as in
every harness script (the card unless ``--device cpu``).

Usage:
    python scripts/torch_convert_mtx_to_npz.py MATRIX [MATRIX ...] -o OUTDIR
    python scripts/torch_convert_mtx_to_npz.py --list matrices.txt -o OUTDIR
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("matrices", nargs="*", help="matrix files")
    p.add_argument("--list", dest="list_file",
                   help="file with one matrix path per line")
    p.add_argument("-o", "--output-dir", default="converted_npz")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch.data import io
    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)
    paths = [Path(x) for x in args.matrices]
    if args.list_file:
        base = Path(args.list_file).parent
        for line in Path(args.list_file).read_text().splitlines():
            line = line.strip()
            if line:
                paths.append(base / line)
    if not paths:
        p.error("no matrices given")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for mp in paths:
        csr = io.load(mp)
        dest = out_dir / (mp.stem + ".npz")
        io.save_npz_graph(dest, csr)
        print(f"{mp} -> {dest}  (m={csr.m} n={csr.n} nnz={csr.nnz})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
