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

``csr_sddmm_torch`` is an autograd op (B4, the VJP of ``csr_sddmm_jax``):
``dA = (g ⊙ S)·B`` and ``dB^T = (g ⊙ S)^T·A``, two launches of the SpMM
kernel (``ops/spmm.py``) in fp32 over the pattern and its transpose, whose
CSR and plans (``spmm.GradPattern``) are built at the first backward and
kept on the pattern's plan (``spmm.pattern_grads``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.gather_plan import GatherPlan, csr_gather_plan
from sddmm_tpu_torch.ops.hybrid import (GATHER_STORAGE, check_device,
                                        residual_gather_dot,
                                        residual_gather_dot_plain)
from sddmm_tpu_torch.ops.spmm import pattern_grads


def csr_plan(s: CSR) -> GatherPlan:
    """The CSR baseline's gather-dot plan of the pattern ``s`` (numpy, on
    the host; ``.to(device)`` before a call): rows that share columns in
    groups, in the pattern's row order or ``similar_rows_order``, the
    group size chosen by the plan's time model."""
    return csr_gather_plan(s.row_ptr, s.col_idx)


class _CsrSddmmFn(torch.autograd.Function):
    """csr_sddmm_torch as an autograd op (B4)."""

    @staticmethod
    def forward(ctx, a, bt, rows, cols, plan):
        ctx.save_for_backward(a, bt, rows, cols)
        ctx.plan = plan
        a_s, bt_s = a, bt
        if (a.dtype, bt.dtype) not in GATHER_STORAGE:
            a_s, bt_s = a.to(torch.float32), bt.to(torch.float32)
        if a.dim() == 3:
            bt_s = bt_s[:, None]
        return residual_gather_dot(a_s, bt_s, rows, cols, plan=plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, bt, rows, cols = ctx.saved_tensors
        one = a.dim() == 2
        a3, bt3 = (a[None], bt[None]) if one else (a, bt)
        H, m, K = a3.shape
        n = bt3.shape[1]
        grads = pattern_grads(ctx.plan, rows, cols, (m, n), a.device)
        g = g.reshape(H, -1).to(torch.float32).contiguous()
        da = dbt = None
        if ctx.needs_input_grad[0]:
            da = torch.empty((H, m, K), dtype=torch.float32, device=a.device)
            grads.spmm(g, bt3.to(torch.float32)[:, None], da[:, None])
            da = da[0] if one else da
        if ctx.needs_input_grad[1]:
            dbt = torch.empty((H, n, K), dtype=torch.float32,
                              device=a.device)
            grads.spmm_t(g, a3.to(torch.float32)[:, None], dbt[:, None])
            dbt = dbt[0] if one else dbt
        return da, dbt, None, None, None


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
    CPU tensors through its plain version, unblocked.

    Differentiable in ``a`` and ``bt`` (B4): each cotangent is one SpMM
    launch in fp32 (the plain version on the CPU).  Their state is built
    at the first backward and kept on ``plan`` (``spmm.pattern_grads``);
    without a plan it is built for each backward."""
    return _CsrSddmmFn.apply(a, bt, rows, cols, plan)


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
