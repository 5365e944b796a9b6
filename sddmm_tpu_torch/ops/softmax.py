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

``segment_softmax_sink`` is the same softmax with a learned sink logit
per head (MiMo-V2-Flash's sliding-window layers): ``b_h`` joins each row's
max and denominator as one more entry with no value, and its gradient is
``-sum_rows p_sink * sum_row p * g``; the kernel's entry points take the
sink as an optional pointer (null: the plain softmax, as above).

The kernel takes a row by its length (``softmax_plan``): a group of 8
lanes, a warp, a thread block (the rows of a causal mask, 641 to 4096
entries) or a cluster of 8 blocks (a graph hub); the block and cluster
rows' plain counterparts in the kernel's order of sums are
``block_softmax_plain`` and ``split_softmax_plain`` (and their
backward).

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

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import check_device
from sddmm_tpu_torch.utils import profiling

#: rows of up to this many entries are a group of 8 lanes in the kernel
#: (csrc/segment_softmax.cu: 16 entries a lane)
SOFTMAX_SUB_ROW = 128
#: rows with more entries than this are long: a thread block each, or
#: split over a cluster of blocks (the others are a warp each: 20 entries
#: a lane)
SOFTMAX_LONG_ROW = 640
#: threads of the kernel's block; a block row's thread takes entries t,
#: t + 256, ... (16 at most), a block row's backward 4-entry chunks
SOFTMAX_BLOCK_THREADS = 256
#: long rows of up to this many entries are a thread block each, their
#: entries in registers (16 a thread: the kernel's most); longer ones are
#: split over a cluster
SOFTMAX_BLOCK_ROW = 4096
#: blocks a split row's cluster takes, one piece each
SOFTMAX_SPLIT = 8


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
    """(n,) int64: the rows longer than ``SOFTMAX_LONG_ROW`` entries (the
    kernel's block and split rows)."""
    return np.flatnonzero(np.diff(np.asarray(row_ptr, dtype=np.int64))
                          > SOFTMAX_LONG_ROW).astype(np.int64)


#: the plan's row classes, in the order of its rows
CLASSES = ("short", "warp", "block", "split")


@dataclasses.dataclass
class SoftmaxPlan:
    """The kernel's rows by class, built once per pattern
    (``softmax_plan``): ``rows`` int64 on the device, the short rows (1 to
    ``SOFTMAX_SUB_ROW`` entries, ``n_sub``), then those up to
    ``SOFTMAX_LONG_ROW`` (``n_warp``), then those up to
    ``SOFTMAX_BLOCK_ROW`` (``n_block``, the longest first), then the
    longer ones (``n_split``); empty rows are in none.  ``entries``: the
    entries of each class's rows, in that order."""
    rows: torch.Tensor
    n_sub: int
    n_warp: int
    n_block: int
    n_split: int
    entries: tuple

    def counts(self) -> tuple:
        """The rows of each class: (n_sub, n_warp, n_block, n_split)."""
        return self.n_sub, self.n_warp, self.n_block, self.n_split

    def by_class(self) -> dict:
        """The plan cut into its row classes, each a plan of that class's
        rows alone: {"short": .., "warp": .., "block": .., "split": ..}
        (a class with no rows left out)."""
        parts, o = {}, 0
        for i, (name, n) in enumerate(zip(CLASSES, self.counts())):
            if n:
                counts, entries = [0] * 4, [0] * 4
                counts[i], entries[i] = n, self.entries[i]
                parts[name] = SoftmaxPlan(self.rows[o:o + n].contiguous(),
                                          *counts, tuple(entries))
            o += n
        return parts


def head_group(heads: int, backward: bool) -> int:
    """The heads a row's group walks in the kernel (the launch's second
    grid dimension takes the groups of heads): every head in the forward,
    half of them in the backward, the fastest of 1, 2, 3, 4, 6 and 12 at
    the Longformer shape on an H100 (``scripts/torch_kernel_cmp.py``;
    PERF.md §6)."""
    return max(1, -(-heads // 2) if backward else heads)


#: the heads of its grid.y group a block row's block takes, forward and
#: backward (``scripts/softmax_class_sweep.py``; PERF.md §6)
SOFTMAX_BLOCK_HEADS = (16, 32)


def block_head_group(heads: int, backward: bool) -> int:
    """The heads a block row's block takes in the kernel, of its grid.y
    group of ``head_group`` heads (the group's other heads go to more
    blocks of the same row)."""
    return max(1, min(heads, SOFTMAX_BLOCK_HEADS[backward]))


def softmax_plan(row_ptr, device) -> SoftmaxPlan:
    """The kernel's plan of the pattern ``row_ptr`` (m+1,) on ``device``
    (its rows contiguous int64, as the kernel reads them)."""
    if not SOFTMAX_LONG_ROW <= SOFTMAX_BLOCK_ROW <= 16 * SOFTMAX_BLOCK_THREADS:
        raise ValueError(f"softmax_plan: a block row takes "
                         f"{SOFTMAX_LONG_ROW + 1} to "
                         f"{16 * SOFTMAX_BLOCK_THREADS} entries, not "
                         f"{SOFTMAX_BLOCK_ROW}")
    lens = np.diff(np.asarray(row_ptr, dtype=np.int64))
    edges = (0, SOFTMAX_SUB_ROW, SOFTMAX_LONG_ROW, SOFTMAX_BLOCK_ROW)
    parts = [np.flatnonzero((lens > lo) & (lens <= hi))
             for lo, hi in zip(edges, edges[1:])]
    parts.append(np.flatnonzero(lens > SOFTMAX_BLOCK_ROW))
    # the longest block rows first, so that the grid ends on short ones
    parts[2] = parts[2][np.argsort(-lens[parts[2]], kind="stable")]
    rows = np.concatenate(parts).astype(np.int64)
    return SoftmaxPlan(torch.as_tensor(rows, device=device),
                       *(len(p) for p in parts),
                       tuple(int(lens[p].sum()) for p in parts))


def _pieces(n: int):
    """The kernel's pieces of a split row of ``n`` entries: ``SOFTMAX_SPLIT``
    (start, stop) ranges of ceil(n / SOFTMAX_SPLIT) entries, in rank
    order (the last ones may be short or empty)."""
    ps = -(-n // SOFTMAX_SPLIT)
    return [(min(k * ps, n), min((k + 1) * ps, n))
            for k in range(SOFTMAX_SPLIT)]


def split_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The split rows' softmax of ``x`` (H, n), one row of H heads, as the
    kernel's cluster takes it: each piece's (max, sum of exp(x - max)),
    combined in rank order, ``exp(x - max) / max(sum, 1e-30)``."""
    m_all = torch.full(x.shape[:1], -torch.inf, dtype=x.dtype,
                       device=x.device)
    s_all = torch.zeros_like(m_all)
    for a, b in _pieces(x.shape[1]):
        if a == b:
            continue
        m_k = x[:, a:b].amax(dim=1)
        s_k = torch.exp(x[:, a:b] - m_k[:, None]).sum(dim=1)
        mx = torch.maximum(m_all, m_k)
        live = mx > -torch.inf
        s_new = (s_all * torch.exp(m_all - mx) + s_k * torch.exp(m_k - mx))
        s_all = torch.where(live, s_new, s_all)
        m_all = torch.where(live, mx, m_all)
    return torch.exp(x - m_all[:, None]) / s_all.clamp_min(1e-30)[:, None]


def split_softmax_backward_plain(p: torch.Tensor, g: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """The split rows' backward of one row (H, n): each piece's sum of
    p * g, added in rank order, then ``scale * p * (g - sum)``."""
    dot = torch.zeros(p.shape[:1], dtype=p.dtype, device=p.device)
    for a, b in _pieces(p.shape[1]):
        dot = dot + (p[:, a:b] * g[:, a:b]).sum(dim=1)
    return scale * (p * (g - dot[:, None]))


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernel's block sum of v (H, 256), a value a thread: each
    warp's xor tree (lane l adds lane l ^ o's value, o = 16, 8, .., 1),
    then the 8 warps' sums in order."""
    lane = torch.arange(32, device=v.device)
    w = v.reshape(v.shape[0], -1, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ o]
    total = w[:, 0, 0]
    for k in range(1, w.shape[1]):
        total = total + w[:, k, 0]
    return total


def block_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The block rows' softmax of ``x`` (H, n), one row of H heads (n up
    to ``SOFTMAX_BLOCK_ROW``), as the kernel's block takes it: thread t's
    sum of exp(x - max) over entries t, t + 256, .. in order, then the
    block sum (``_block_sum``), ``exp(x - max) / max(sum, 1e-30)``."""
    T = SOFTMAX_BLOCK_THREADS
    heads, n = x.shape
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    slots = torch.zeros((heads, -(-n // T) * T), dtype=x.dtype,
                        device=x.device)
    slots[:, :n] = e
    slots = slots.view(heads, -1, T)
    part = slots[:, 0]
    for i in range(1, slots.shape[1]):
        part = part + slots[:, i]
    return e / _block_sum(part).clamp_min(1e-30)[:, None]


def block_softmax_backward_plain(p: torch.Tensor, g: torch.Tensor,
                                 scale: float, start: int) -> torch.Tensor:
    """The block rows' backward of one row (H, n) that starts at entry
    ``start`` of the CSR order, as the kernel's block takes it: the row's
    4-entry chunks from ``start & ~3``, thread t's chunks t, t + 256, ..,
    its sum of p * g over them in order, each term fused into the sum
    (float64 products, exact, rounded to fp32 once a term), then the block
    sum (``_block_sum``), ``scale * p * (g - sum)``."""
    T = SOFTMAX_BLOCK_THREADS
    heads, n = p.shape
    off = start % 4
    width = -(-(off + n) // (4 * T)) * 4 * T
    pp = torch.zeros((heads, width), dtype=torch.float64, device=p.device)
    gg = torch.zeros_like(pp)
    pp[:, off:off + n], gg[:, off:off + n] = p, g
    terms = (pp * gg).view(heads, -1, T, 4)
    part = torch.zeros((heads, T), dtype=p.dtype, device=p.device)
    for i in range(terms.shape[1]):
        for c in range(4):
            part = (part.double() + terms[:, i, :, c]).to(p.dtype)
    dot = _block_sum(part)
    return scale * (p * (g - dot[:, None]))


def segment_softmax_split_plain(flat: torch.Tensor, row_ptr: torch.Tensor,
                                scale: float = 1.0,
                                inv_idx: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """``segment_softmax_plain`` with the long rows (longer than
    ``SOFTMAX_LONG_ROW``) taken as the kernel takes them: a block row in
    the block's order (``block_softmax_plain``), a split row piece by
    piece as the kernel's cluster combines them (``split_softmax_plain``):
    the plain counterpart of the long rows' sums."""
    out = segment_softmax_plain(flat, row_ptr, scale, inv_idx)
    x = _csr_scores(flat, inv_idx) * scale
    rp = row_ptr.tolist()
    for r in find_long_rows(rp).tolist():
        a, b = rp[r], rp[r + 1]
        take = (block_softmax_plain if b - a <= SOFTMAX_BLOCK_ROW
                else split_softmax_plain)
        out[:, a:b] = take(x[:, a:b])
    return out


def segment_softmax_backward_split_plain(p: torch.Tensor, g: torch.Tensor,
                                         row_ptr: torch.Tensor,
                                         scale: float = 1.0,
                                         inv_idx: Optional[torch.Tensor]
                                         = None,
                                         size: Optional[int] = None
                                         ) -> torch.Tensor:
    """``segment_softmax_backward_plain`` with the long rows' sums taken
    as the kernel takes them: a block row's in the block's order
    (``block_softmax_backward_plain``), a split row's piece by piece in
    rank order (``split_softmax_backward_plain``)."""
    d = segment_softmax_backward_plain(p, g, row_ptr, scale)
    rp = row_ptr.tolist()
    for r in find_long_rows(rp).tolist():
        a, b = rp[r], rp[r + 1]
        if b - a <= SOFTMAX_BLOCK_ROW:
            d[:, a:b] = block_softmax_backward_plain(p[:, a:b], g[:, a:b],
                                                     scale, a)
        else:
            d[:, a:b] = split_softmax_backward_plain(p[:, a:b], g[:, a:b],
                                                     scale)
    if inv_idx is None:
        return d
    out = torch.zeros((p.shape[0], size), dtype=d.dtype, device=d.device)
    out[:, inv_idx.long()] = d
    return out


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


def backward_rel_err(d: torch.Tensor, want: torch.Tensor, p: torch.Tensor,
                     g: torch.Tensor, row_ptr: torch.Tensor,
                     scale: float) -> float:
    """The largest, over the entries, of ``|d - want|`` over the size of
    the terms that make the entry, ``|scale| * p * (|g| + sum_row |p *
    g|)``: the backward ``d`` held to its reference ``want``, all (H, nnz)
    in CSR order, beside the softmax output ``p`` and the cotangent ``g``
    it was computed from.  Each entry is held to its own terms, so a wrong
    row sum shows in a hub row whose values are small, and a row whose
    ``g - sum`` cancels is not held to its cancelled value (an entry with
    no terms must be exact; inf if it is not)."""
    heads, nnz = want.shape
    if not nnz:
        return 0.0
    m = row_ptr.shape[0] - 1
    rows = _head_rows(row_ptr, heads, want.device)
    pg = (p * g).abs().reshape(-1).double()
    row_abs = torch.zeros(heads * m, dtype=torch.float64,
                          device=want.device).index_add_(0, rows, pg)
    terms = (abs(scale) * p.double().reshape(-1)
             * (g.double().abs().reshape(-1) + row_abs[rows]))
    err = (d.double() - want.double()).abs().reshape(-1)
    rel = torch.where(err > 0, err / terms, torch.zeros_like(err))
    return float(rel.max())


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


def segment_softmax_sink_plain(flat: torch.Tensor, row_ptr: torch.Tensor,
                               scale: float, inv_idx: Optional[torch.Tensor],
                               sink: torch.Tensor):
    """Plain PyTorch version of the softmax with a sink: (p (H, nnz) in
    CSR order, p_sink (H, m)), the sink ``sink[h]`` one more entry of each
    of head h's rows (in its max and, last, in its fp64 denominator)."""
    x = _csr_scores(flat, inv_idx) * scale
    heads, nnz = x.shape
    m = row_ptr.shape[0] - 1
    rows = _head_rows(row_ptr, heads, x.device)
    b = sink.detach().to(x.dtype).repeat_interleave(m)
    row_max = b.scatter_reduce(0, rows, x.detach().reshape(-1), "amax")
    e = torch.exp(x.reshape(-1) - row_max[rows])
    e_sink = torch.exp(sink.to(x.dtype).repeat_interleave(m) - row_max)
    denom = torch.zeros(heads * m, dtype=torch.float64,
                        device=x.device).index_add_(0, rows, e.double())
    denom = (denom + e_sink.double()).clamp_min(1e-30).to(x.dtype)
    return ((e / denom[rows]).view(heads, nnz),
            (e_sink / denom).view(heads, m))


def segment_softmax_backward(p: torch.Tensor, g: torch.Tensor,
                             row_ptr: torch.Tensor, scale: float = 1.0,
                             inv_idx: Optional[torch.Tensor] = None,
                             size: Optional[int] = None,
                             plan: Optional[SoftmaxPlan] = None,
                             p_sink: Optional[torch.Tensor] = None,
                             plain: bool = False):
    """The scores' cotangent of ``segment_softmax_torch`` from its output
    ``p`` and that output's cotangent ``g``, both (H, nnz) fp32 in CSR
    order: (H, ``size``) with ``inv_idx`` (the packed slots; the others
    0), else (H, nnz).  CUDA tensors go through the kernel's backward entry
    (one launch, or raise) over ``plan`` (``softmax_plan(row_ptr)``, found
    here if None), CPU tensors (and ``plain``) through
    ``segment_softmax_backward_plain``.  With ``p_sink`` (H, m), the
    forward's sink probabilities: (that cotangent, the sinks' (H,)
    gradient), each row's share ``-p_sink * sum_row p * g`` summed over the
    rows in order."""
    heads, nnz = p.shape
    if g.shape != p.shape or p.dtype != torch.float32 or (
            g.dtype != torch.float32):
        raise ValueError(f"segment_softmax backward: p {tuple(p.shape)} "
                         f"{p.dtype} and g {tuple(g.shape)} {g.dtype}, want "
                         "one (H, nnz) float32 shape")
    if inv_idx is not None and (size is None or inv_idx.shape != (nnz,)):
        raise ValueError("segment_softmax backward: inv_idx needs the "
                         "packed size and one slot per entry")
    m = row_ptr.shape[0] - 1
    if plain or p.device.type == "cpu":
        d = segment_softmax_backward_plain(p, g, row_ptr, scale, inv_idx,
                                           size)
        if p_sink is None:
            return d
        dot = torch.zeros(heads * m, dtype=torch.float64,
                          device=p.device).index_add_(
                              0, _head_rows(row_ptr, heads, p.device),
                              (p * g).reshape(-1).double())
        d_rows = -p_sink * dot.to(p.dtype).view(heads, m)
        return d, d_rows.sum(dim=1)
    if p.device.type != "cuda":
        raise ValueError(f"segment_softmax: unsupported device {p.device}")
    if plan is None:
        with profiling.span("plan.build"):
            plan = softmax_plan(row_ptr.cpu().numpy(), p.device)
    _check_plan(plan, p.device)
    p, g = p.contiguous(), g.contiguous()
    out = (torch.zeros((heads, size), dtype=torch.float32, device=p.device)
           if inv_idx is not None else torch.empty_like(p))
    d_rows = None
    if p_sink is not None:
        p_sink = p_sink.contiguous()
        d_rows = torch.zeros((heads, m), dtype=torch.float32,
                             device=p.device)
    if heads == 0 or m == 0 or nnz == 0:
        return out if d_rows is None else (out, d_rows.sum(dim=1))
    row_ptr = row_ptr.contiguous()
    inv_idx = inv_idx.contiguous() if inv_idx is not None else None
    softmax_launch(plan, (p, g), row_ptr, scale, out, inv_idx, p_sink,
                   d_rows)
    return out if d_rows is None else (out, d_rows.sum(dim=1))


def softmax_launch(plan: SoftmaxPlan, ins: tuple, row_ptr: torch.Tensor,
                   scale: float, out: torch.Tensor,
                   inv_idx: Optional[torch.Tensor] = None,
                   sink: Optional[torch.Tensor] = None,
                   sink_out: Optional[torch.Tensor] = None) -> None:
    """One launch of the kernel over ``plan``, its arguments checked by
    the caller: the forward with ``ins`` = (scores,), ``sink`` the logits
    and ``sink_out`` p_sink, or the backward with ``ins`` = (p, g),
    ``sink`` p_sink and ``sink_out`` the rows' gradient (each pair None
    without a sink); the heads are ``out``'s.  While spans are on, the
    plan's entries by class, times the heads, go to
    ``profiling.count_softmax``."""
    backward = len(ins) == 2
    heads = out.shape[0]
    if profiling.active():
        profiling.count_softmax(heads * sum(plan.entries),
                                heads * plan.entries[2],
                                heads * plan.entries[3])
    with torch.cuda.device(out.device):
        _kernels.launch(
            _kernels.SOFTMAX_BWD_ENTRY if backward else _kernels.SOFTMAX_ENTRY,
            *(a for t in ins for a in (t.data_ptr(), t.stride(0))),
            None if inv_idx is None else inv_idx.data_ptr(),
            row_ptr.data_ptr(), plan.rows.data_ptr(), *plan.counts(),
            float(scale), out.data_ptr(), out.stride(0), heads,
            head_group(heads, backward), block_head_group(heads, backward),
            None if sink is None else sink.data_ptr(),
            None if sink_out is None else sink_out.data_ptr(),
            row_ptr.shape[0] - 1, torch.cuda.current_stream().cuda_stream)


class _SoftmaxFn(torch.autograd.Function):
    """segment_softmax_torch and segment_softmax_sink on (H, F) scores as
    one autograd op (B2): the kernel's two entry points, with the sink or
    without one (its null pointers), or the plain versions."""

    @staticmethod
    def forward(ctx, flat, sink, row_ptr, scale, inv_idx, plan, out, plain):
        p, plan, *p_sink = _softmax_forward(flat, row_ptr, scale, inv_idx,
                                            plan, out, sink, plain)
        if out is not None:
            ctx.mark_dirty(out)
        p_sink = p_sink[0] if p_sink else None
        ctx.save_for_backward(p, p_sink, row_ptr, inv_idx)
        ctx.scale, ctx.size, ctx.plan = scale, flat.shape[1], plan
        ctx.plain, ctx.span = plain, profiling.current()
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        p, p_sink, row_ptr, inv_idx = ctx.saved_tensors
        with profiling.span("softmax.backward", ctx.span):
            d = segment_softmax_backward(
                p, g.to(torch.float32), row_ptr, ctx.scale, inv_idx,
                ctx.size, ctx.plan, p_sink, ctx.plain)
        d, d_sink = d if p_sink is not None else (d, None)
        return d, d_sink, None, None, None, None, None, None


def segment_softmax_torch(flat: torch.Tensor, row_ptr: torch.Tensor,
                          scale: float = 1.0,
                          inv_idx: Optional[torch.Tensor] = None,
                          plan: Optional[SoftmaxPlan] = None,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Row softmax of ``scale * scores`` over the CSR pattern ``row_ptr``
    (m+1,) int64, for H heads: ``flat`` (H, F) fp32 the packed scores and
    ``inv_idx`` (nnz,) int32 the packed slot of each CSR entry (the
    runner's ``inv_idx32``), or ``flat`` (H, nnz) already in CSR order and
    ``inv_idx`` None; a 1-D ``flat`` is one head.  -> (H, nnz) (or (nnz,))
    in CSR order.  ``plan``: ``softmax_plan(row_ptr, device)``, the
    kernel's rows by class, when the caller keeps it (else it is built
    here, which reads the row pointers back to the host).  ``out``: an (H, nnz)
    fp32 tensor to write into (last dimension contiguous).  CUDA tensors go
    through the kernel (or raise); CPU tensors through
    ``segment_softmax_plain``.

    Differentiable in ``flat`` (B2; its backward is one kernel launch).
    An ``out`` that autograd tracks is written in place."""
    if flat.dim() == 1:
        return segment_softmax_torch(
            flat[None], row_ptr, scale, inv_idx, plan,
            None if out is None else out[None])[0]
    return _SoftmaxFn.apply(flat, None, row_ptr, scale, inv_idx, plan, out,
                            False)


def segment_softmax_sink(flat: torch.Tensor, sink: Optional[torch.Tensor],
                         row_ptr: torch.Tensor, scale: float,
                         inv_idx: Optional[torch.Tensor] = None,
                         plan: Optional[SoftmaxPlan] = None,
                         plain: bool = False) -> torch.Tensor:
    """``segment_softmax_torch`` with a learned sink logit a head: ``flat``
    (H, F) (or (H, nnz) without ``inv_idx``), ``sink`` (H,) fp32 ->
    (H, nnz) in CSR order, each row's probabilities summing to 1 less its
    sink's share (``sink`` None: the plain softmax).  Differentiable in
    ``flat`` and ``sink``; one launch of the kernel's forward and one of
    its backward on the card, the plain versions on the CPU or with
    ``plain``."""
    return _SoftmaxFn.apply(flat, sink, row_ptr, scale, inv_idx, plan, None,
                            plain)


def _check_plan(plan, device):
    if not isinstance(plan, SoftmaxPlan):
        raise TypeError("segment_softmax: plan must be a SoftmaxPlan "
                        f"(softmax_plan), got {type(plan).__name__}")
    if plan.rows.device != device:
        raise ValueError(f"segment_softmax: the plan is on "
                         f"{plan.rows.device}, the scores on {device}")


def _softmax_forward(flat, row_ptr, scale, inv_idx, plan, out, sink=None,
                     plain=False):
    """segment_softmax_torch's forward on a 2-D ``flat``, checked: (the
    probabilities, the plan the kernel took or None), or with a ``sink``
    (H,) fp32 (the probabilities, the plan, p_sink (H, m))."""
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
    for name, t in (("row_ptr", row_ptr), ("inv_idx", inv_idx)):
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
    if sink is not None and (sink.shape != (heads,) or sink.dtype
                             != torch.float32 or sink.device != flat.device):
        raise ValueError(f"segment_softmax: sink {tuple(sink.shape)} "
                         f"{sink.dtype} on {sink.device}, want ({heads},) "
                         f"float32 on {flat.device}")
    m = row_ptr.shape[0] - 1
    if plain or flat.device.type == "cpu":
        if sink is not None:
            res, p_sink = segment_softmax_sink_plain(flat, row_ptr, scale,
                                                     inv_idx, sink)
            return (res if out is None else out.copy_(res)), plan, p_sink
        res = segment_softmax_plain(flat, row_ptr, scale, inv_idx)
        return (res if out is None else out.copy_(res)), plan
    if flat.device.type != "cuda":
        raise ValueError(f"segment_softmax: unsupported device {flat.device}")
    if flat.shape[1] > 1 and flat.stride(1) != 1:
        raise ValueError("segment_softmax: flat's rows must be contiguous")
    if plan is None:
        with profiling.span("plan.build"):
            plan = softmax_plan(row_ptr.cpu().numpy(), flat.device)
    _check_plan(plan, flat.device)
    if out is None:
        out = torch.empty((heads, nnz), dtype=torch.float32,
                          device=flat.device)
    p_sink = None
    if sink is not None:
        sink = sink.contiguous()
        # an empty row's mass is all the sink's
        p_sink = torch.ones((heads, m), dtype=torch.float32,
                            device=flat.device)
    done = (out, plan) if sink is None else (out, plan, p_sink)
    if heads == 0 or m == 0 or nnz == 0:
        return done
    row_ptr = row_ptr.contiguous()
    inv_idx = inv_idx.contiguous() if inv_idx is not None else None
    softmax_launch(plan, (flat,), row_ptr, scale, out, inv_idx, sink, p_sink)
    return done


def csr_softmax(s: CSR, scores, scale: float = 1.0,
                device="cuda") -> np.ndarray:
    """Host wrapper: the row softmax of ``scale * scores`` over the pattern
    ``s``, scores (nnz,) or (H, nnz) in CSR order, numpy in, numpy out."""
    dev = check_device(device)
    x = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=dev)
    row_ptr = torch.as_tensor(np.asarray(s.row_ptr, dtype=np.int64),
                              device=dev)
    return segment_softmax_torch(x, row_ptr, scale).cpu().numpy()
