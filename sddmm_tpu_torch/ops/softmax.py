"""Segment softmax: the attention models' row softmax of scaled scores.

Counterpart of ``sddmm_tpu/models/graph_attention.py::segment_softmax`` as
the JAX models apply it, to ``scale * scores`` (the graph layer divides by
sqrt(D), the block-sparse model multiplies by 1/sqrt(D)):

    p_e = exp(scale * s_e - max_row) / max(sum_row exp(.), 1e-30)

``segment_softmax`` is the torch-ops version under the JAX name
(``scatter_reduce`` amax, ``exp``, ``index_add_``, a divide), rows in any
order.  ``segment_softmax_torch`` reads the hybrid runner's packed scores
``flat`` (H, F) through its ``inv_idx`` (or scores already in CSR order)
and writes (H, nnz) in CSR order: on CUDA tensors the hand kernel
``csrc/segment_softmax.cu`` (one launch for all rows and heads; the gather
into CSR order and the scale are fused into its loads), on CPU tensors its
plain version ``segment_softmax_plain`` (the gather, the scale and
``segment_softmax``).

``segment_softmax_torch`` is an autograd op (B2, the VJP of
``segment_softmax`` as the models apply it): from the saved probabilities
p and the cotangent g, both (H, nnz) in CSR order,
``d scores = scale * p * (g - sum_row p * g)``, written at ``inv_idx``
into a zeroed (H, F) packed gradient (the transpose of the forward's fused
gather; the padding slots get 0).  On CUDA tensors it is a second entry of
``csrc/segment_softmax.cu`` (one launch), on CPU tensors
``segment_softmax_backward_plain``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import check_device

#: rows with more entries than this are a block of their own in the kernel
#: (csrc/segment_softmax.cu: 32 lanes x kPer entries in registers)
SOFTMAX_LONG_ROW = 640


def segment_softmax(scores: torch.Tensor, rows: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """Numerically stable softmax over per-row segments of edge scores:
    scores and rows (nnz,), row ids in ``[0, num_rows)`` in any order.

    The denominators are accumulated in fp64 and rounded once: on the card
    ``index_add_`` adds a row's terms one at a time, in any order, and in
    fp32 its rounding grows to about 1e-5 of the sum over a row of 200,000
    entries (a graph hub), more than the kernel it is the reference for
    errs by."""
    rows = rows.long()
    row_max = torch.full((num_rows,), -torch.inf, dtype=scores.dtype,
                         device=scores.device)
    row_max = row_max.scatter_reduce(0, rows, scores, "amax")
    exp = torch.exp(scores - row_max[rows])
    denom = torch.zeros((num_rows,), dtype=torch.float64,
                        device=scores.device).index_add_(0, rows,
                                                         exp.double())
    return exp / denom.clamp_min(1e-30).to(scores.dtype)[rows]


def find_long_rows(row_ptr) -> np.ndarray:
    """(n,) int64: the rows longer than ``SOFTMAX_LONG_ROW`` entries."""
    return np.flatnonzero(np.diff(np.asarray(row_ptr, dtype=np.int64))
                          > SOFTMAX_LONG_ROW).astype(np.int64)


def _csr_scores(flat, inv_idx):
    """(H, nnz) CSR-order scores of ``flat`` (H, F) or (H, nnz)."""
    return flat if inv_idx is None else flat[..., inv_idx.long()]


def _head_rows(row_ptr, heads, device):
    """(heads * nnz,) int64: the row of each entry of H heads' CSR-order
    values, head h's rows numbered h*m + r."""
    m = row_ptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(m, device=device),
                                   row_ptr.diff().long())
    return (torch.arange(heads, device=device)[:, None] * m
            + rows[None]).reshape(-1)


def segment_softmax_plain(flat: torch.Tensor, row_ptr: torch.Tensor,
                          scale: float = 1.0,
                          inv_idx: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: the CSR-order gather, the scale (an fp32
    multiply) and ``segment_softmax`` over every head's rows at once."""
    x = _csr_scores(flat, inv_idx) * scale
    heads, nnz = x.shape
    m = row_ptr.shape[0] - 1
    return segment_softmax(x.reshape(-1), _head_rows(row_ptr, heads,
                                                     x.device),
                           heads * m).reshape(heads, nnz)


def segment_softmax_backward_plain(p: torch.Tensor, g: torch.Tensor,
                                   row_ptr: torch.Tensor, scale: float = 1.0,
                                   inv_idx: Optional[torch.Tensor] = None,
                                   size: Optional[int] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the backward: the row sums of p * g by
    ``index_add_`` in fp64 (rounded once, as ``segment_softmax``'s
    denominators), ``scale * p * (g - sum)``, then an ``index_put`` at
    ``inv_idx`` into a zero (H, ``size``) (or the (H, nnz) itself without
    ``inv_idx``)."""
    heads, nnz = p.shape
    m = row_ptr.shape[0] - 1
    rows = _head_rows(row_ptr, heads, p.device)
    dot = torch.zeros(heads * m, dtype=torch.float64,
                      device=p.device).index_add_(
                          0, rows, (p * g).reshape(-1).double())
    d = scale * (p * (g - dot.to(p.dtype)[rows].view(heads, nnz)))
    if inv_idx is None:
        return d
    out = torch.zeros((heads, size), dtype=d.dtype, device=d.device)
    out[:, inv_idx.long()] = d
    return out


def segment_softmax_backward(p: torch.Tensor, g: torch.Tensor,
                             row_ptr: torch.Tensor, scale: float = 1.0,
                             inv_idx: Optional[torch.Tensor] = None,
                             size: Optional[int] = None,
                             long_rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The scores' cotangent of ``segment_softmax_torch`` from its output
    ``p`` and that output's cotangent ``g``, both (H, nnz) fp32 in CSR
    order: (H, ``size``) with ``inv_idx`` (the packed slots; the others
    0), else (H, nnz).  CUDA tensors go through the kernel's backward entry
    (one launch, or raise), CPU tensors through
    ``segment_softmax_backward_plain``."""
    heads, nnz = p.shape
    if g.shape != p.shape or p.dtype != torch.float32 or (
            g.dtype != torch.float32):
        raise ValueError(f"segment_softmax backward: p {tuple(p.shape)} "
                         f"{p.dtype} and g {tuple(g.shape)} {g.dtype}, want "
                         "one (H, nnz) float32 shape")
    if inv_idx is not None and (size is None or inv_idx.shape != (nnz,)):
        raise ValueError("segment_softmax backward: inv_idx needs the "
                         "packed size and one slot per entry")
    if p.device.type == "cpu":
        return segment_softmax_backward_plain(p, g, row_ptr, scale, inv_idx,
                                              size)
    if p.device.type != "cuda":
        raise ValueError(f"segment_softmax: unsupported device {p.device}")
    if long_rows is None:
        long_rows = torch.as_tensor(find_long_rows(row_ptr.cpu().numpy()),
                                    device=p.device)
    p, g = p.contiguous(), g.contiguous()
    out = (torch.zeros((heads, size), dtype=torch.float32, device=p.device)
           if inv_idx is not None else torch.empty_like(p))
    m = row_ptr.shape[0] - 1
    if heads == 0 or m == 0 or nnz == 0:
        return out
    row_ptr = row_ptr.contiguous()
    inv_idx = inv_idx.contiguous() if inv_idx is not None else None
    with torch.cuda.device(p.device):
        _kernels.launch(_kernels.SOFTMAX_BWD_ENTRY, p.data_ptr(),
                        p.stride(0), g.data_ptr(), g.stride(0),
                        inv_idx.data_ptr() if inv_idx is not None else None,
                        row_ptr.data_ptr(), m, long_rows.data_ptr(),
                        long_rows.shape[0], float(scale), out.data_ptr(),
                        out.stride(0), heads,
                        torch.cuda.current_stream().cuda_stream)
    return out


class _SoftmaxFn(torch.autograd.Function):
    """segment_softmax_torch on (H, F) scores as an autograd op (B2)."""

    @staticmethod
    def forward(ctx, flat, row_ptr, scale, inv_idx, long_rows, out):
        p = _softmax_forward(flat, row_ptr, scale, inv_idx, long_rows, out)
        if out is not None:
            ctx.mark_dirty(out)
        ctx.save_for_backward(p, row_ptr, inv_idx, long_rows)
        ctx.scale, ctx.size = scale, flat.shape[1]
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        p, row_ptr, inv_idx, long_rows = ctx.saved_tensors
        d = segment_softmax_backward(p, g.to(torch.float32), row_ptr,
                                     ctx.scale, inv_idx, ctx.size, long_rows)
        return d, None, None, None, None, None


def segment_softmax_torch(flat: torch.Tensor, row_ptr: torch.Tensor,
                          scale: float = 1.0,
                          inv_idx: Optional[torch.Tensor] = None,
                          long_rows: Optional[torch.Tensor] = None,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Row softmax of ``scale * scores`` over the CSR pattern ``row_ptr``
    (m+1,) int64, for H heads: ``flat`` (H, F) fp32 the packed scores and
    ``inv_idx`` (nnz,) int32 the packed slot of each CSR entry (the
    runner's ``inv_idx32``), or ``flat`` (H, nnz) already in CSR order and
    ``inv_idx`` None; a 1-D ``flat`` is one head.  -> (H, nnz) (or (nnz,))
    in CSR order.  ``long_rows``: ``find_long_rows(row_ptr)`` as an int64
    tensor on the device, when the caller keeps it (else it is found here,
    which reads the row pointers back to the host).  ``out``: an (H, nnz)
    fp32 tensor to write into (last dimension contiguous).  CUDA tensors go
    through the kernel (or raise); CPU tensors through
    ``segment_softmax_plain``.

    Differentiable in ``flat`` (B2; its backward is one kernel launch).
    An ``out`` that autograd tracks is written in place."""
    if flat.dim() == 1:
        return segment_softmax_torch(
            flat[None], row_ptr, scale, inv_idx, long_rows,
            None if out is None else out[None])[0]
    return _SoftmaxFn.apply(flat, row_ptr, scale, inv_idx, long_rows, out)


def _softmax_forward(flat, row_ptr, scale, inv_idx, long_rows, out):
    """segment_softmax_torch's forward on a 2-D ``flat``, checked."""
    if flat.dim() != 2 or flat.dtype != torch.float32:
        raise ValueError(f"segment_softmax: want flat (H, F) float32, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    if row_ptr.dim() != 1 or row_ptr.dtype != torch.int64:
        raise TypeError(f"segment_softmax: row_ptr must be (m+1,) int64, "
                        f"got {tuple(row_ptr.shape)} {row_ptr.dtype}")
    nnz = (inv_idx.shape[0] if inv_idx is not None else flat.shape[1])
    if inv_idx is not None and (inv_idx.dim() != 1
                                or inv_idx.dtype != torch.int32):
        raise TypeError(f"segment_softmax: inv_idx must be (nnz,) int32, "
                        f"got {tuple(inv_idx.shape)} {inv_idx.dtype}")
    for name, t in (("row_ptr", row_ptr), ("inv_idx", inv_idx),
                    ("long_rows", long_rows)):
        if t is not None and t.device != flat.device:
            raise ValueError(f"segment_softmax: {name} is on {t.device}, "
                             f"flat on {flat.device}")
    heads = flat.shape[0]
    if out is not None and (out.shape != (heads, nnz)
                            or out.dtype != torch.float32
                            or out.device != flat.device
                            or (nnz > 1 and out.stride(1) != 1)):
        raise ValueError(f"segment_softmax: out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}, want ({heads}, "
                         f"{nnz}) float32 rows on {flat.device}")
    if flat.device.type == "cpu":
        res = segment_softmax_plain(flat, row_ptr, scale, inv_idx)
        return res if out is None else out.copy_(res)
    if flat.device.type != "cuda":
        raise ValueError(f"segment_softmax: unsupported device {flat.device}")
    if flat.shape[1] > 1 and flat.stride(1) != 1:
        raise ValueError("segment_softmax: flat's rows must be contiguous")
    if long_rows is None:
        long_rows = torch.as_tensor(find_long_rows(row_ptr.cpu().numpy()),
                                     device=flat.device)
    if long_rows.dtype != torch.int64 or not long_rows.is_contiguous():
        raise TypeError("segment_softmax: long_rows must be contiguous "
                        "int64")
    if out is None:
        out = torch.empty((heads, nnz), dtype=torch.float32,
                          device=flat.device)
    m = row_ptr.shape[0] - 1
    if heads == 0 or m == 0 or nnz == 0:
        return out
    row_ptr = row_ptr.contiguous()
    inv_idx = inv_idx.contiguous() if inv_idx is not None else None
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(_kernels.SOFTMAX_ENTRY, flat.data_ptr(),
                        flat.stride(0),
                        inv_idx.data_ptr() if inv_idx is not None else None,
                        row_ptr.data_ptr(), m, long_rows.data_ptr(),
                        long_rows.shape[0], float(scale), out.data_ptr(),
                        out.stride(0), heads, stream)
    return out


def csr_softmax(s: CSR, scores, scale: float = 1.0,
                device="cuda") -> np.ndarray:
    """Host wrapper: the row softmax of ``scale * scores`` over the pattern
    ``s``, scores (nnz,) or (H, nnz) in CSR order, numpy in, numpy out."""
    dev = check_device(device)
    x = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=dev)
    row_ptr = torch.as_tensor(np.asarray(s.row_ptr, dtype=np.int64),
                              device=dev)
    return segment_softmax_torch(x, row_ptr, scale).cpu().numpy()
