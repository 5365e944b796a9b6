"""CSR SpMM (sparse @ dense): the aggregation step of the attention models.

Counterpart of ``sddmm_tpu/ops/spmm.py`` (``csr_spmm_jax``, ``csr_spmm``):
``out[r] = sum_{i: rows[i] == r} values[i] * dense[cols[i]]``, with fp32
products and sums.  The JAX package gathers the dense rows, scales them and
segment-sums them into rows; here a CUDA tensor goes through the hand
kernel ``csrc/spmm.cu`` (one warp per row, reading the dense rows in place,
no atomics), and a CPU tensor through ``csr_spmm_plain`` (``index_add_``).
Row ids outside ``[0, num_rows)`` are dropped on both paths, as
``jax.ops.segment_sum`` drops them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import check_device, check_no_grad


def csr_spmm_plain(values: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, dense: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: gather, scale, ``index_add_`` into rows (in
    any row order); out-of-range row ids go to a dropped extra row."""
    rows = rows.long()
    rows = torch.where((rows >= 0) & (rows < num_rows), rows, num_rows)
    contrib = dense[cols.long()] * values.to(dense.dtype)[:, None]
    out = torch.zeros((num_rows + 1, dense.shape[1]), dtype=dense.dtype,
                      device=dense.device)
    return out.index_add_(0, rows, contrib)[:num_rows]


def csr_index(values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              num_rows: int):
    """``(row_ptr, cols, values)``, the kernel's CSR, of entries in any row
    order: a stable sort by row first where ``rows`` is not non-decreasing
    (so each row keeps its entries' order), then the (num_rows + 1,) int64
    row pointers, entry ``r`` the number of ids below ``r``, so that ids
    outside ``[0, num_rows)`` fall outside every row."""
    rows = rows.long()
    if rows.numel() > 1 and not bool((rows[1:] >= rows[:-1]).all()):
        rows, order = torch.sort(rows, stable=True)
        values, cols = values[order], cols[order]
    bounds = torch.arange(num_rows + 1, dtype=rows.dtype, device=rows.device)
    return torch.searchsorted(rows, bounds), cols, values


def _check(values, rows, cols, dense, num_rows, row_ptr):
    nnz = values.shape[0]
    if dense.dim() != 2 or dense.shape[1] < 1:
        raise ValueError(f"csr_spmm: want dense (N, K), K >= 1, got "
                         f"{tuple(dense.shape)}")
    if num_rows < 0:
        raise ValueError(f"csr_spmm: num_rows={num_rows} < 0")
    for name, t in (("values", values), ("rows", rows), ("cols", cols)):
        if t.shape != (nnz,):
            raise ValueError(f"csr_spmm: {name} {tuple(t.shape)} != ({nnz},)")
    if row_ptr is not None and row_ptr.shape != (num_rows + 1,):
        raise ValueError(f"csr_spmm: row_ptr {tuple(row_ptr.shape)} != "
                         f"({num_rows + 1},)")
    for name, t in (("values", values), ("rows", rows), ("cols", cols),
                    ("row_ptr", row_ptr)):
        if t is not None and t.device != dense.device:
            raise ValueError(f"csr_spmm: {name} is on {t.device}, dense on "
                             f"{dense.device}")
    for name, t in (("rows", rows), ("cols", cols), ("row_ptr", row_ptr)):
        if t is not None and t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"csr_spmm: {name} is {t.dtype}, want an int32 "
                            "or int64 index")


def csr_spmm_torch(values: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, dense: torch.Tensor, num_rows: int,
                   row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = sum over entries i with rows[i] == r of values[i] *
    dense[cols[i]]: values/rows/cols (nnz,), dense (N, K) -> (num_rows, K).

    The JAX signature, plus ``row_ptr``: the (num_rows + 1,) row pointers
    of ``rows`` when the caller has them (then ``rows`` must be
    non-decreasing and match them; the kernel reads only ``row_ptr``).
    Without it, the row pointers are made here, after a stable sort of the
    entries by row when ``rows`` is not non-decreasing.  cols must be in
    range.  CUDA tensors go through the kernel (dense fp32, values cast to
    fp32 as JAX's astype does) or raise; CPU tensors through
    ``csr_spmm_plain``."""
    check_no_grad("csr_spmm_torch", values, dense)
    _check(values, rows, cols, dense, num_rows, row_ptr)
    if dense.device.type == "cpu":
        return csr_spmm_plain(values, rows, cols, dense, num_rows)
    if dense.device.type != "cuda":
        raise ValueError(f"csr_spmm: unsupported device {dense.device}")
    if dense.dtype != torch.float32:
        raise TypeError(f"csr_spmm: the kernel takes fp32 dense, got "
                        f"{dense.dtype}")
    if dense.stride(1) != 1 and dense.shape[1] > 1:
        raise ValueError("csr_spmm: dense's rows must be contiguous")
    values = values.to(torch.float32)
    if row_ptr is None:
        row_ptr, cols, values = csr_index(values, rows, cols, num_rows)
    row_ptr = row_ptr.to(torch.int64).contiguous()
    cols = cols.to(torch.int32).contiguous()
    values = values.contiguous()
    out = torch.empty((num_rows, dense.shape[1]), dtype=torch.float32,
                      device=dense.device)
    if num_rows == 0:
        return out
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(_kernels.SPMM_ENTRY, row_ptr.data_ptr(),
                        cols.data_ptr(), values.data_ptr(), dense.data_ptr(),
                        dense.stride(0), out.data_ptr(), num_rows,
                        dense.shape[1], stream)
    return out


def csr_spmm(s: CSR, dense, values=None, device="cpu") -> np.ndarray:
    """Host wrapper: S @ dense with S's stored values (or ``values``),
    numpy in, numpy out."""
    dev = check_device(device)
    vals = s.values if values is None else values
    vals = torch.as_tensor(np.asarray(vals, dtype=np.float32), device=dev)
    dense_t = torch.as_tensor(np.ascontiguousarray(dense, dtype=np.float32),
                              device=dev)
    rows = torch.as_tensor(s.row_indices(), dtype=torch.int64, device=dev)
    cols = torch.as_tensor(s.col_idx, dtype=torch.int32, device=dev)
    row_ptr = torch.as_tensor(s.row_ptr, dtype=torch.int64, device=dev)
    return csr_spmm_torch(vals, rows, cols, dense_t, s.m,
                          row_ptr=row_ptr).cpu().numpy()
