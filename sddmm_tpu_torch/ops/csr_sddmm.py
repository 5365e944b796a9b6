"""CSR SDDMM — the per-entry gather-dot baseline.

Counterpart of ``sddmm_tpu/ops/csr_sddmm.py`` (``csr_sddmm_jax``,
``_csr_sddmm_blocked``, ``csr_sddmm``): ``values[i] = a[rows[i]] .
bt[cols[i]]`` with fp32 products and sums, B taken transposed (``bt``
(N, K)) so that a column of B is a contiguous row.

On CUDA tensors ``csr_sddmm_torch`` is the residual gather-dot kernel
(``csrc/gather_dot.cu``) with C = G = 1: it reads each entry's two rows in
place and gathers nothing into memory, so it needs no blocking.  Its plain
version gathers both rows of every entry, so the host wrapper keeps the JAX
package's nnz blocking above ``max_gathered_mb`` there, and its memory
stays bounded.
"""

from __future__ import annotations

import numpy as np
import torch

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import (GATHER_STORAGE, check_device,
                                        check_no_grad, residual_gather_dot,
                                        residual_gather_dot_plain)


def csr_sddmm_torch(a: torch.Tensor, bt: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """values[i] = dot(a[rows[i]], bt[cols[i]]) in fp32.

    a (M, K), bt (N, K), each fp32, fp16 or bf16; rows and cols (nnz,)
    int32 and in range.  A storage pair the gather-dot has no instance for
    (fp16 beside fp32, say) is first cast to fp32, exactly, as the JAX
    package's ``astype(float32)`` does.  CUDA tensors go through the
    gather-dot kernel (or raise); CPU tensors through its plain version,
    unblocked."""
    check_no_grad("csr_sddmm_torch", a, bt)
    if (a.dtype, bt.dtype) not in GATHER_STORAGE:
        a, bt = a.to(torch.float32), bt.to(torch.float32)
    return residual_gather_dot(a, bt, rows, cols)


def csr_sddmm_blocked_plain(a: torch.Tensor, bt: torch.Tensor,
                            rows: torch.Tensor, cols: torch.Tensor,
                            block_nnz: int) -> torch.Tensor:
    """Plain version over nnz blocks of ``block_nnz`` entries, so the
    gathered rows of only one block are live (``rows``/``cols`` padded to
    a multiple of ``block_nnz``)."""
    if block_nnz < 1 or rows.shape[0] % block_nnz:
        raise ValueError(f"{rows.shape[0]} entries are not a multiple of "
                         f"block_nnz={block_nnz}")
    return torch.cat([
        residual_gather_dot_plain(a, bt, rows[i:i + block_nnz],
                                  cols[i:i + block_nnz])
        for i in range(0, rows.shape[0], block_nnz)])


def csr_sddmm(a, b, s: CSR, scale_by_values: bool = False,
              max_gathered_mb: float = 512.0, device="cuda") -> np.ndarray:
    """Host-convenience wrapper: numpy in, numpy out, CSR entry order."""
    dev = check_device(device)

    def put(x, dtype=None):
        x = np.ascontiguousarray(x)
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        return torch.as_tensor(x, dtype=dtype, device=dev)

    rows = put(s.row_indices(), torch.int32)
    cols = put(s.col_idx, torch.int32)
    a_t = put(np.asarray(a))
    bt = put(np.asarray(b).T)
    k = a_t.shape[1]
    gathered_mb = 2 * s.nnz * k * 4 / 1e6
    if dev.type == "cuda" or gathered_mb <= max_gathered_mb:
        vals = csr_sddmm_torch(a_t, bt, rows, cols)
    else:
        block_nnz = max(1, int(max_gathered_mb * 1e6 / (2 * k * 4)))
        block_nnz = min(block_nnz, s.nnz)
        pad = (-s.nnz) % block_nnz
        rows_p = torch.nn.functional.pad(rows, (0, pad))
        cols_p = torch.nn.functional.pad(cols, (0, pad))
        vals = csr_sddmm_blocked_plain(a_t, bt, rows_p, cols_p,
                                       block_nnz)[:s.nnz]
    vals = vals.cpu().numpy()
    if scale_by_values:
        vals = vals * np.asarray(s.values, dtype=vals.dtype)
    return vals
