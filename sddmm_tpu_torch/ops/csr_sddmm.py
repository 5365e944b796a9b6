"""CSR SDDMM — the per-entry gather-dot baseline.

Counterpart of ``sddmm_tpu/ops/csr_sddmm.py`` (``csr_sddmm_jax``,
``_csr_sddmm_blocked``, ``csr_sddmm``): ``values[i] = a[rows[i]] .
bt[cols[i]]`` with fp32 products and sums, B taken transposed (``bt``
(N, K)) so that a column of B is a contiguous row.

On CUDA tensors ``csr_sddmm_torch`` is the gather-dot kernel
(``csrc/gather_dot.cu``) with C = G = 1: it reads each entry's two rows in
place and gathers nothing into memory, so it needs no blocking.  Given the
pattern's plan (``csr_plan``, built once on the host), it reads each
distinct B^T row once for a group of rows that share it; without one it
walks the entries in their order, reusing an A row while the row repeats.
A batch of operand pairs over one pattern is one launch (a head stride).
Its plain version gathers both rows of every entry, so the host wrapper
keeps the JAX package's nnz blocking above ``max_gathered_mb`` there, and
its memory stays bounded.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.gather_plan import GatherPlan, csr_gather_plan
from sddmm_tpu_torch.ops.hybrid import (GATHER_STORAGE, check_device,
                                        check_no_grad, residual_gather_dot,
                                        residual_gather_dot_plain)


def csr_plan(s: CSR) -> GatherPlan:
    """The CSR baseline's gather-dot plan of the pattern ``s`` (numpy, on
    the host; ``.to(device)`` before a call): rows that share columns in
    groups, in the pattern's row order or ``similar_rows_order``, the
    group size chosen by the plan's time model."""
    return csr_gather_plan(s.row_ptr, s.col_idx)


def csr_sddmm_torch(a: torch.Tensor, bt: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor,
                    plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """values[i] = dot(a[rows[i]], bt[cols[i]]) in fp32.

    a (M, K), bt (N, K), each fp32, fp16 or bf16, or a batch (B, M, K) and
    (B, N, K) -> (B, nnz); rows and cols (nnz,) int32 and in range, any
    order.  ``plan``: ``csr_plan`` of the pattern whose entries ``rows``
    and ``cols`` list in CSR order, on the tensors' device.  A storage pair
    the gather-dot has no instance for (fp16 beside fp32, say) is first
    cast to fp32, exactly, as the JAX package's ``astype(float32)`` does.
    CUDA tensors go through the gather-dot kernel (one launch, or raise);
    CPU tensors through its plain version, unblocked."""
    check_no_grad("csr_sddmm_torch", a, bt)
    if (a.dtype, bt.dtype) not in GATHER_STORAGE:
        a, bt = a.to(torch.float32), bt.to(torch.float32)
    if a.dim() == 3:
        bt = bt[:, None]
    return residual_gather_dot(a, bt, rows, cols, plan=plan)


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
    if dev.type == "cuda":
        vals = csr_sddmm_torch(a_t, bt, rows, cols,
                               csr_plan(s).to(dev))
    elif gathered_mb <= max_gathered_mb:
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
