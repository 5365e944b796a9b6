#!/usr/bin/env python3
"""Generate the synthetic benchmark corpus with the PyTorch port's own
generators: the counterpart of scripts/make_synth_suite.py, importing
nothing of JAX.  The same generator calls with the same seeds write the
same files, byte for byte.

The corpus spans the regimes the reference's 503-matrix SuiteSparse suite
covers: fine/coarse planted block structure, power-law graphs, banded
stencils, uniform random, rectangular shapes, and dense-ish pruned-NN-style
(DLMC-like) weights.  The first 21 matrices respect the reference's
dataset filter (m, n >= 10 000 and nnz >= 100 000,
scripts/exclude_invalid_dataset.py:46-49); the round-3 additions (extreme
aspect ratios, hypersparse mixtures, the true DLMC density class) do not
all, and are written with a note.  The JAX script asserts the filter on
every matrix, so it stops at the first of them (tall16x); this script
writes the whole corpus.  Generation is host work; ``--device`` is checked
as in every harness script (the card unless ``--device cpu``).

Usage:
    python scripts/torch_make_synth_suite.py OUTDIR [--only NAME ...] \
        [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def corpus():
    """name -> zero-arg generator, 20+ matrices across regimes."""
    from sddmm_tpu_torch.data import generate as g
    return {
        # fine-grained planted blocks (16x16), density / size spread
        "fineblock_sparse": lambda: g.block_clustered(
            768, 768, block_prob=0.01, block_density=0.4,
            noise_density=1e-5, seed=101),
        "fineblock_mid": lambda: g.block_clustered(
            1024, 1024, block_prob=0.008, block_density=0.65,
            noise_density=1e-5, seed=102),
        "fineblock_dense": lambda: g.block_clustered(
            896, 896, block_prob=0.009, block_density=0.9,
            noise_density=1e-5, seed=103),
        "fineblock_noisy": lambda: g.block_clustered(
            768, 768, block_prob=0.008, block_density=0.6,
            noise_density=2e-4, seed=104),
        # coarse blocks (64/128-wide)
        "coarse64": lambda: g.block_clustered(
            256, 256, group_rows=64, group_cols=64, block_prob=0.012,
            block_density=0.35, noise_density=1e-5, seed=111),
        "coarse128": lambda: g.block_clustered(
            128, 128, group_rows=128, group_cols=128, block_prob=0.025,
            block_density=0.3, noise_density=1e-5, seed=112),
        "coarse128_dense": lambda: g.block_clustered(
            96, 96, group_rows=128, group_cols=128, block_prob=0.03,
            block_density=0.7, noise_density=1e-5, seed=113),
        # power-law graphs, degree spread
        "powerlaw8": lambda: g.powerlaw_graph(16384, avg_degree=8,
                                              seed=121),
        "powerlaw40": lambda: g.powerlaw_graph(32768, avg_degree=40,
                                               seed=122),
        "powerlaw100": lambda: g.powerlaw_graph(16384, avg_degree=100,
                                                seed=123),
        # banded stencils
        "banded_narrow": lambda: g.banded(32768, 32768, bandwidth=8,
                                          fill=0.9, seed=131),
        "banded_mid": lambda: g.banded(24576, 24576, bandwidth=45,
                                       fill=0.55, seed=132),
        "banded_wide_sparse": lambda: g.banded(16384, 16384,
                                               bandwidth=128, fill=0.25,
                                               seed=133),
        # uniform random (worst case for reordering)
        "uniform_1e3": lambda: g.random_sparse(16384, 16384,
                                               density=1e-3, seed=141),
        "uniform_3e3": lambda: g.random_sparse(12288, 12288,
                                               density=3e-3, seed=142),
        # rectangular
        "tall4x": lambda: g.block_clustered(
            2560, 640, block_prob=0.008, block_density=0.6,
            noise_density=1e-5, seed=151),
        "wide4x": lambda: g.block_clustered(
            640, 2560, block_prob=0.008, block_density=0.6,
            noise_density=1e-5, seed=152),
        # DLMC-like pruned-NN weights: unstructured, high density
        "dlmc_like_80": lambda: g.random_sparse(10240, 10240,
                                                density=0.002, seed=161),
        "dlmc_like_dense": lambda: g.random_sparse(10240, 10240,
                                                   density=0.004,
                                                   seed=162),
        # mixed regime: blocks + heavy noise + a power-law tail
        "mixed_blocks_noise": lambda: g.block_clustered(
            640, 640, block_prob=0.012, block_density=0.55,
            noise_density=3e-4, seed=171),
        "banded_plus_random": lambda: g.banded(12288, 12288,
                                               bandwidth=24, fill=0.4,
                                               seed=172),
        # adversarial regimes (round 3, VERDICT #5: egress is blocked —
        # results/egress_proof_r3.md — so the synthetic corpus hardens
        # instead): extreme aspect ratios and hypersparse + dense-row/col
        # mixtures (the SuiteSparse "bus row / boundary condition" shape)
        "tall16x": lambda: g.block_clustered(
            2048, 128, block_prob=0.02, block_density=0.5,
            noise_density=1e-5, seed=181),
        "wide16x": lambda: g.block_clustered(
            128, 2048, block_prob=0.02, block_density=0.5,
            noise_density=1e-5, seed=182),
        "hypersparse_hubs": lambda: g.hypersparse_dense_mix(
            32768, 32768, density=3e-5, num_dense_rows=24,
            num_dense_cols=24, dense_fill=0.35, seed=183),
        "hypersparse_pure": lambda: g.hypersparse_dense_mix(
            49152, 49152, density=4e-4, num_dense_rows=0,
            num_dense_cols=0, seed=184),
        # TRUE DLMC density class (round 3): real pruned-ML weights are
        # 50-90% sparse (density 0.1-0.5, e.g. DLMC transformer
        # magnitude-pruning); the older dlmc_like_* entries above are
        # hypersparse (d=0.002-0.004) and kept as adversarial cases.
        # Square + rectangular (FFN-shaped) variants.
        "dlmc_dense_10": lambda: g.random_sparse(4096, 4096,
                                                 density=0.1, seed=191),
        "dlmc_dense_25": lambda: g.random_sparse(4096, 4096,
                                                 density=0.25, seed=192),
        "dlmc_ffn_20": lambda: g.random_sparse(2048, 8192,
                                               density=0.2, seed=193),
    }


def in_filter(csr) -> bool:
    """The reference's dataset filter: m, n >= 10 000 and nnz >= 100 000."""
    return csr.m >= 10000 and csr.n >= 10000 and csr.nnz >= 100000


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("outdir", type=Path)
    p.add_argument("--only", nargs="*", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from sddmm_tpu_torch.data import io
    from sddmm_tpu_torch.ops.hybrid import check_device

    check_device(args.device)

    args.outdir.mkdir(parents=True, exist_ok=True)
    for name, gen in corpus().items():
        if args.only and name not in args.only:
            continue
        dest = args.outdir / f"{name}.mtx"
        if dest.exists():
            print(f"{name}: exists, skipping")
            continue
        csr = gen()
        io.save_mtx(dest, csr)
        print(f"{name}: m={csr.m} n={csr.n} nnz={csr.nnz} -> {dest}"
              + ("" if in_filter(csr) else
                 "  (outside the reference's dataset filter)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
