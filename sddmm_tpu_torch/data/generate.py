"""Deterministic random matrix generators.

Equivalent capability to the reference's ``Matrix::makeData`` (seeded mt19937
U[0,2), src/Matrix.cpp:131-137), ``COO::makeData`` random sparse
(src/Matrix.cpp:766-824), and cuRAND seeding (src/cudaUtil.cu:25-36).
Additionally provides structured generators that mimic the SuiteSparse /
DLMC regimes used by the benchmark harness.
"""

from __future__ import annotations

import numpy as np

from sddmm_tpu_torch.data.sparse import COO, CSR


def make_dense(m: int, k: int, seed: int = 1337, dtype=np.float32,
               low: float = 0.0, high: float = 2.0) -> np.ndarray:
    """Random dense matrix, U[low, high) — reference default is U[0, 2)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=(m, k)).astype(dtype)


def random_sparse(m: int, n: int, density: float, seed: int = 0,
                  dtype=np.float32) -> CSR:
    """Uniform random sparsity pattern with U[0,1) values."""
    rng = np.random.default_rng(seed)
    nnz_target = max(1, int(round(m * n * density)))
    # Sample without replacement in flat index space.
    flat = rng.choice(m * n, size=min(nnz_target, m * n), replace=False)
    rows = (flat // n).astype(np.int64)
    cols = (flat % n).astype(np.int64)
    vals = rng.random(len(flat)).astype(dtype)
    return COO((m, n), rows, cols, vals).to_csr(dtype=dtype)


def powerlaw_graph(num_nodes: int, avg_degree: float, seed: int = 0,
                   exponent: float = 2.1, dtype=np.float32) -> CSR:
    """Scale-free-ish adjacency pattern: per-node degrees ~ Zipf-capped,
    neighbor choice preferential by degree weight.  Mimics the skewed
    row-length distributions of SuiteSparse graph matrices."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    weights = ranks ** (-1.0 / (exponent - 1.0))
    weights /= weights.sum()
    degrees = rng.poisson(avg_degree * weights * num_nodes /
                          (avg_degree * weights * num_nodes).mean()
                          * avg_degree)
    degrees = np.clip(degrees, 0, num_nodes - 1)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), degrees)
    cols = rng.choice(num_nodes, size=len(rows), p=weights)
    keys = rows * num_nodes + cols
    _, uniq = np.unique(keys, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = np.ones(len(rows), dtype=dtype)
    return COO((num_nodes, num_nodes), rows, cols, vals).to_csr(dtype=dtype)


def banded(m: int, n: int, bandwidth: int, seed: int = 0,
           fill: float = 0.8, dtype=np.float32) -> CSR:
    """Banded pattern with random dropout — a high-locality regime where
    BSMR-style reordering finds many dense blocks."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for r in range(m):
        lo = max(0, r - bandwidth)
        hi = min(n, r + bandwidth + 1)
        cols_r = np.arange(lo, hi)
        keep = rng.random(len(cols_r)) < fill
        cols_r = cols_r[keep]
        rows_l.append(np.full(len(cols_r), r, dtype=np.int64))
        cols_l.append(cols_r)
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, dtype=np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, dtype=np.int64)
    vals = rng.random(len(rows)).astype(dtype)
    return COO((m, n), rows, cols, vals).to_csr(dtype=dtype)


def block_clustered(num_row_groups: int, num_col_groups: int,
                    group_rows: int = 16, group_cols: int = 16,
                    block_density: float = 0.7,
                    block_prob: float = 0.1,
                    noise_density: float = 0.0005,
                    seed: int = 0, shuffle_rows: bool = True,
                    dtype=np.float32) -> CSR:
    """Planted block structure + noise, with rows optionally shuffled so
    reordering has real work to do (the regime BSMR targets)."""
    rng = np.random.default_rng(seed)
    m = num_row_groups * group_rows
    n = num_col_groups * group_cols
    rows_l, cols_l = [], []
    active = rng.random((num_row_groups, num_col_groups)) < block_prob
    gi, gj = np.nonzero(active)
    for bi, bj in zip(gi, gj):
        mask = rng.random((group_rows, group_cols)) < block_density
        rr, cc = np.nonzero(mask)
        rows_l.append(bi * group_rows + rr)
        cols_l.append(bj * group_cols + cc)
    # background noise
    noise = int(m * n * noise_density)
    if noise:
        flat = rng.choice(m * n, size=noise, replace=False)
        rows_l.append(flat // n)
        cols_l.append(flat % n)
    rows = np.concatenate(rows_l).astype(np.int64)
    cols = np.concatenate(cols_l).astype(np.int64)
    if shuffle_rows:
        perm = rng.permutation(m)
        rows = perm[rows]
    keys = rows * n + cols
    _, uniq = np.unique(keys, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = rng.random(len(rows)).astype(dtype)
    return COO((m, n), rows, cols, vals).to_csr(dtype=dtype)


def hypersparse_dense_mix(m: int, n: int, density: float = 5e-5,
                          num_dense_rows: int = 32,
                          num_dense_cols: int = 32,
                          dense_fill: float = 0.4, seed: int = 0,
                          dtype=np.float32) -> CSR:
    """Hypersparse uniform background plus a handful of dense rows and
    dense columns — the adversarial "scattered + hubs" regime common in
    real SuiteSparse matrices (boundary conditions, bus rows).  The
    dense columns are exactly what the hub-slab path (reorder/pack.py)
    targets; the dense rows stress per-panel column splits."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    background = int(m * n * density)
    if background:
        flat = rng.choice(m * n, size=background, replace=False)
        rows_l.append(flat // n)
        cols_l.append(flat % n)
    dr = rng.choice(m, size=min(num_dense_rows, m), replace=False)
    for r in dr:
        cc = np.nonzero(rng.random(n) < dense_fill)[0]
        rows_l.append(np.full(len(cc), r, dtype=np.int64))
        cols_l.append(cc)
    dc = rng.choice(n, size=min(num_dense_cols, n), replace=False)
    for c in dc:
        rr = np.nonzero(rng.random(m) < dense_fill)[0]
        rows_l.append(rr)
        cols_l.append(np.full(len(rr), c, dtype=np.int64))
    rows = np.concatenate(rows_l).astype(np.int64)
    cols = np.concatenate(cols_l).astype(np.int64)
    keys = rows * n + cols
    _, uniq = np.unique(keys, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = rng.random(len(rows)).astype(dtype)
    return COO((m, n), rows, cols, vals).to_csr(dtype=dtype)
