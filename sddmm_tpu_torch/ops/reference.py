"""CPU golden model for SDDMM.

Reference: src/host.cpp:44-125 (``sddmm_cpu``).  Semantics note, mirrored
exactly: the sparse matrix S is treated as a *pattern only* — the output at
each nonzero position is the raw dot product (A@B)_ij; the multiply by S's
stored values is intentionally omitted (reference src/host.cpp:122 comments
that line out, and all GPU kernels behave the same).  An opt-in
``scale_by_values`` flag provides the textbook SDDMM for callers that want
the Hadamard product.
"""

from __future__ import annotations

import numpy as np

from sddmm_tpu_torch.data.sparse import CSR


def sddmm_reference(a: np.ndarray, b: np.ndarray, s: CSR,
                    scale_by_values: bool = False,
                    chunk: int = 1 << 18) -> np.ndarray:
    """Compute P values at the nnz positions of ``s``: P_k = A[row_k] . B[:, col_k].

    a: (M, K) dense.  b: (K, N) dense.  Returns (nnz,) float64-accumulated
    values cast to a.dtype, in CSR entry order.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or m != s.m or n != s.n:
        raise ValueError("shape mismatch between A, B, S")
    rows = s.row_indices()
    cols = s.col_idx
    out = np.empty(s.nnz, dtype=np.float64)
    bt = np.ascontiguousarray(b.T, dtype=np.float64)
    a64 = np.asarray(a, dtype=np.float64)
    for start in range(0, s.nnz, chunk):
        end = min(start + chunk, s.nnz)
        out[start:end] = np.einsum(
            "ij,ij->i", a64[rows[start:end]], bt[cols[start:end]])
    if scale_by_values:
        out = out * np.asarray(s.values, dtype=np.float64)
    return out.astype(a.dtype)


def dense_mm_reference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dense matmul golden (reference ``dmm_cpu``, src/host.cpp:5-42)."""
    return (np.asarray(a, dtype=np.float64)
            @ np.asarray(b, dtype=np.float64)).astype(a.dtype)
