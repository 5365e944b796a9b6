#!/usr/bin/env python3
"""Clustering-stage throughput: host greedy (native C++ when built) vs
host batched (numpy) vs device batched (``method="device"``: the
clustering round K9, ``csrc/cluster_round.cu``, on the card) on a large
clusterable matrix: the counterpart of scripts/probe_cluster.py, importing
nothing of JAX.  The JAX script's flags and lines, plus ``--device`` (the
card unless ``--device cpu``, where the rounds run their plain version);
the device run is warmed once (the kernels' build and first launch), then
timed by the host clock around a whole clustering, as there.

Usage:
    python scripts/torch_probe_cluster.py --row-groups 6400 --col-groups 2048
    python scripts/torch_probe_cluster.py --row-groups 6400 --skip-greedy
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--row-groups", type=int, default=6400,
                   help="16-row block rows (m = 16 * this)")
    p.add_argument("--col-groups", type=int, default=2048)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--block-prob", type=float, default=0.004)
    p.add_argument("--skip-greedy", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch import bench, native
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import check_device
    from sddmm_tpu_torch.reorder.device_cluster import batched_cluster_device
    from sddmm_tpu_torch.reorder.rows import (_batched_cluster,
                                              _greedy_cluster,
                                              dispersion_scores,
                                              row_encodings)

    dev = check_device(args.device)
    print(f"card: {bench.card_label(dev)}", flush=True)
    csr = generate.block_clustered(
        args.row_groups, args.col_groups, block_prob=args.block_prob,
        block_density=0.6, noise_density=0.0, seed=71)
    print(f"m={csr.m} n={csr.n} nnz={csr.nnz}", flush=True)
    cbs = 16
    bp, bi, bc, nb = row_encodings(csr, cbs)
    disp = dispersion_scores(csr, bp, bc, cbs)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]
    print(f"rows to cluster: {len(order)}  blocks: {nb}", flush=True)

    if not args.skip_greedy:
        t0 = time.perf_counter()
        if native.available():
            g_cl, g_n = native.greedy_cluster(bp, bi, bc, order, csr.m,
                                              nb, args.alpha)
            tag = "host greedy (native C++)"
        else:
            g_cl, g_n = _greedy_cluster(order, bp, bi, bc, nb, args.alpha)
            tag = "host greedy (numpy)"
        t_greedy = time.perf_counter() - t0
        print(f"{tag}: {t_greedy:.2f}s  ({g_n} clusters)", flush=True)
    else:
        t_greedy = None

    t0 = time.perf_counter()
    h_cl, h_n = _batched_cluster(order, bp, bi, bc, nb, args.alpha,
                                 hat_dtype=np.float32)
    t_host = time.perf_counter() - t0
    print(f"host batched (numpy): {t_host:.2f}s  ({h_n} clusters)",
          flush=True)

    # warm (build, first launch) then timed
    batched_cluster_device(order, bp, bi, bc, nb, args.alpha, device=dev)
    t0 = time.perf_counter()
    d_cl, d_n = batched_cluster_device(order, bp, bi, bc, nb, args.alpha,
                                       device=dev)
    t_dev = time.perf_counter() - t0
    where = "K9 on the card" if dev.type == "cuda" else "plain, cpu"
    print(f"device batched ({where}): {t_dev:.2f}s  ({d_n} clusters)",
          flush=True)
    print(f"identical to host batched: "
          f"{np.array_equal(d_cl, h_cl) and d_n == h_n}")
    if t_greedy is not None:
        print(f"device vs host-greedy speedup: {t_greedy / t_dev:.1f}x")
    print(f"device vs host-batched speedup: {t_host / t_dev:.1f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
