"""CSR SpMM (sparse @ dense): the aggregation step of the attention models.

Counterpart of ``sddmm_tpu/ops/spmm.py`` (``csr_spmm_jax``, ``csr_spmm``):
``out[r] = sum_{i: rows[i] == r} values[i] * dense[cols[i]]``, with fp32
products and sums.  The JAX package gathers the dense rows, scales them and
segment-sums them into rows; here a CUDA tensor goes through the hand
kernel ``csrc/spmm.cu``, and a CPU tensor through ``csr_spmm_plain``
(``index_add_``).  The kernel walks a plan built once on the host from the
pattern (``spmm_plan``): groups of 2 or 4 rows that share
columns, a warp each, reading each dense row their rows share once; and
each row longer than ``SPMM_LONG_ROW`` entries split into 8 pieces across
the warps of one block, whose partial sums are added in a fixed order
(``spmm_pieces`` lists what each row adds, in the kernel's order;
``csr_spmm_split_plain`` is that order in PyTorch ops).  No atomics: the
result is deterministic.  Row ids outside ``[0, num_rows)`` are dropped on
both paths, as ``jax.ops.segment_sum`` drops them.

One launch runs a batch of H x C products over one pattern
(``spmm_launch``: head and chunk strides on values, dense and out, and a
row stride on out), which the backward passes use.  ``csr_spmm_torch`` is
an autograd op (B3, the VJP of ``csr_spmm_jax``): the values' cotangent is
the gather-dot at the pattern and the dense operand's the SpMM on the
transposed pattern.  What a pattern's backward needs (``SpmmPattern``, the
SpMM's CSR of an entry list; ``GradPattern``, a pattern and its transpose
and the gather-dot's plan) is built at the first backward and kept on the
pattern's forward plan (``pattern_grads``), so a forward pays nothing for
it and a caller keeps one object per pattern.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.gather_plan import (gather_plan, group_items,
                                             occurrences)
from sddmm_tpu_torch.ops.hybrid import (GATHER_STORAGE, check_device,
                                        residual_gather_dot,
                                        residual_gather_dot_plain)
from sddmm_tpu_torch.ops.tile_dot import head_shift
from sddmm_tpu_torch.utils import profiling

#: rows with more entries than this are split across the warps of a block
SPMM_LONG_ROW = 1024
#: warps per block of the kernel (csrc/spmm.cu kWarpsPerBlock): the row
#: groups of a task, and the pieces of a long row
SPMM_WARPS = 8
#: the group sizes the kernel has instances for (csrc/spmm.cu GR): rows of
#: a group, whose shared columns are read once
SPMM_GROUPS = (2, 4)
#: rows of the pattern's head whose sharing picks the group size
SPMM_SAMPLE_ROWS = 8192
#: a group is kept where its distinct columns are at most this share of its
#: entries; otherwise its rows become groups of one row
SPMM_SHARE = 0.75


@dataclasses.dataclass
class SpmmPlan:
    """The SpMM kernel's plan of one pattern (``spmm_plan``) for groups of
    up to ``group_rows`` (GR) rows: ``tasks`` (T, 2) int64, a block each,
    ``[first group, count 1..8]`` or ``[row, 0]`` for one long row;
    ``groups`` (G, 2 + GR) int64 ``[first item, end item, its 1..GR rows,
    -1 past them]``; ``items`` (I, 1 + GR) int32, each a distinct column
    of its group and the entry of each of the group's rows there (-1 where
    the row has none), ascending by column within a group.  A group of one
    row has no items: it walks its CSR entries.  numpy arrays, or tensors
    after ``to``.  ``grads``: the pattern's backward state
    (``pattern_grads``)."""
    tasks: object
    groups: object
    items: object
    group_rows: int
    grads: Optional["GradPattern"] = None

    def to(self, device) -> "SpmmPlan":
        return SpmmPlan(*(torch.as_tensor(x, device=device).contiguous()
                          for x in (self.tasks, self.groups, self.items)),
                        self.group_rows)


def spmm_plan(row_ptr, cols, row_order=None, group_rows=None) -> SpmmPlan:
    """The plan of the CSR pattern ``(row_ptr, cols)``, in numpy.  Every
    row longer than ``SPMM_LONG_ROW`` entries is a task of its own (first,
    so that they start early).  The other rows, taken in ``row_order`` (a
    permutation of the rows; default 0..m-1), go in groups of
    ``group_rows`` consecutive rows; a group whose distinct columns are
    more than ``SPMM_SHARE`` of its entries is split into groups of one
    row.  8 groups a task.  A column that a row holds twice gets an item
    per occurrence.

    ``group_rows`` None picks one of ``SPMM_GROUPS`` from what the pattern
    shows: the plan of its first ``SPMM_SAMPLE_ROWS`` short rows (in the
    order) at each size, costed as items x (2 + GR), since a warp's work
    per item grows with the rows it carries (on the card, GR = 4 took 1.3x
    GR = 2's time on the graph model's aggregation for 0.75x its items)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m = len(row_ptr) - 1
    order = (np.arange(m) if row_order is None
             else np.asarray(row_order, dtype=np.int64))
    if not np.array_equal(np.sort(order), np.arange(m)):
        raise ValueError("spmm_plan: row_order is not a permutation of the "
                         f"{m} rows")
    lengths = np.diff(row_ptr)
    is_long = lengths > SPMM_LONG_ROW
    short = order[~is_long[order]]
    sampled = {}
    if group_rows is None:
        head = short[:SPMM_SAMPLE_ROWS]
        sampled = {gr: _plan_groups(row_ptr, cols, head, gr)
                   for gr in SPMM_GROUPS}
        group_rows = min(SPMM_GROUPS, key=lambda gr: len(
            sampled[gr][1]) * (2 + gr))
        if len(head) < len(short):
            sampled = {}
    if group_rows not in SPMM_GROUPS:
        raise ValueError(f"spmm_plan: group_rows={group_rows}, want one of "
                         f"{SPMM_GROUPS}")
    # a sample that held every short row is the plan itself
    groups, items = sampled.get(group_rows) or _plan_groups(
        row_ptr, cols, short, group_rows)
    long_rows = np.flatnonzero(is_long)
    t0 = np.arange(0, len(groups), SPMM_WARPS)
    tasks = np.concatenate([
        np.stack([long_rows, np.zeros_like(long_rows)], axis=1),
        np.stack([t0, np.minimum(SPMM_WARPS, len(groups) - t0)], axis=1)
    ]).astype(np.int64).reshape(-1, 2)
    return SpmmPlan(tasks, groups, items, group_rows)


def _plan_groups(row_ptr, cols, short, gr):
    """(groups (G, 2 + gr) int64, items (I, 1 + gr) int32) of the rows
    ``short``, in that order, as ``spmm_plan`` lays them out."""
    m = len(row_ptr) - 1
    lengths = np.diff(row_ptr)
    # candidate groups: gr consecutive rows of the order
    cand_of_row = np.full(m, -1, dtype=np.int64)
    slot_of_row = np.zeros(m, dtype=np.int64)
    cand_of_row[short] = np.arange(len(short)) // gr
    slot_of_row[short] = np.arange(len(short)) % gr
    n_cand = -(-len(short) // gr)
    row_of = np.repeat(np.arange(m), lengths)
    ent = np.flatnonzero(cand_of_row[row_of] >= 0)
    e_row, e_col = row_of[ent], cols[ent]
    # the occurrence of a column within its row (0 unless repeated)
    occ = occurrences(e_row, e_col)
    e_cand = cand_of_row[e_row]
    items, item_cand = group_items(e_cand, slot_of_row[e_row], e_col, occ,
                                   ent, gr)
    keep = (np.bincount(item_cand, minlength=n_cand)
            <= SPMM_SHARE * np.bincount(e_cand, minlength=n_cand))
    # kept candidates stay groups; the rows of the others, groups of one
    rows_of_cand = np.full((n_cand, gr), -1, dtype=np.int64)
    rows_of_cand.reshape(-1)[:len(short)] = short
    kept = np.flatnonzero(keep)
    items = items[keep[item_cand]]
    item_group = np.searchsorted(kept, item_cand[keep[item_cand]])
    singles = rows_of_cand[~keep].reshape(-1)
    singles = singles[singles >= 0]
    n_groups = len(kept) + len(singles)
    g_rows = np.full((n_groups, gr), -1, dtype=np.int64)
    g_rows[:len(kept)] = rows_of_cand[kept]
    g_rows[len(kept):, 0] = singles
    bounds = np.searchsorted(item_group, np.arange(n_groups + 1))
    groups = np.concatenate([bounds[:-1, None], bounds[1:, None], g_rows],
                            axis=1).astype(np.int64)
    return groups, items


def spmm_pieces(plan: SpmmPlan, row_ptr) -> list:
    """``[(row, entry ids)]``: what each row adds, piece by piece, in the
    kernel's order (a group row's entries in item order, a lone row's in
    CSR order; a long row's 8
    pieces of ``ceil(n / SPMM_WARPS)`` entries, the last ones shorter or
    empty)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    groups, items = np.asarray(plan.groups), np.asarray(plan.items)
    out = []
    for first, count in np.asarray(plan.tasks):
        if count == 0:
            e0, e1 = row_ptr[first], row_ptr[first + 1]
            piece = -(-(e1 - e0) // SPMM_WARPS)
            for w in range(SPMM_WARPS):
                p0 = min(e1, e0 + w * piece)
                out.append((first, np.arange(p0, min(e1, p0 + piece))))
            continue
        for g in groups[first:first + count]:
            if g[3] < 0:
                out.append((g[2], np.arange(row_ptr[g[2]],
                                            row_ptr[g[2] + 1])))
                continue
            for r, row in enumerate(g[2:]):
                if row >= 0:
                    e = items[g[0]:g[1], 1 + r]
                    out.append((row, e[e >= 0].astype(np.int64)))
    return out


def csr_spmm_split_plain(values: torch.Tensor, cols: torch.Tensor,
                         dense: torch.Tensor, row_ptr,
                         plan: SpmmPlan) -> torch.Tensor:
    """The kernel's plan in PyTorch ops: each piece of ``spmm_pieces``
    summed apart, a row's pieces added in order; fp32 products and sums.
    (m, K) for the (m+1,) ``row_ptr``."""
    m = len(row_ptr) - 1
    out = torch.zeros((m, dense.shape[1]), dtype=torch.float32,
                      device=dense.device)
    vals = values.to(torch.float32)
    for row, e in spmm_pieces(plan, row_ptr):
        e = torch.as_tensor(e, device=dense.device)
        part = (dense[cols[e].long()].to(torch.float32)
                * vals[e, None]).sum(dim=0)
        out[row] = out[row] + part
    return out


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


def _spmm_forward(values, rows, cols, dense, num_rows, row_ptr, plan):
    """csr_spmm_torch's forward, checked: the kernel or the plain version."""
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
    K = dense.shape[1]
    out = torch.empty((num_rows, K), dtype=torch.float32,
                      device=dense.device)
    if num_rows == 0:
        return out
    if plan is None:
        with profiling.span("plan.build"):
            plan = spmm_plan(row_ptr.cpu().numpy(),
                             cols.cpu().numpy()).to(dense.device)
    spmm_launch(plan, row_ptr, cols, values.contiguous()[None],
                dense[None, None], out[None, None])
    return out


def spmm_launch(plan: SpmmPlan, row_ptr: torch.Tensor, cols: torch.Tensor,
                values: torch.Tensor, dense: torch.Tensor, out: torch.Tensor,
                vidx: Optional[torch.Tensor] = None) -> None:
    """One launch of the SpMM kernel for H x C products over one CSR
    pattern: ``out[h, c] = S(values[h]) . dense[h, c]``.  row_ptr (m+1,)
    int64 and cols (nnz,) int32, contiguous, with their plan (``SpmmPlan``
    on the card); values (H, nnz) fp32 with contiguous rows (the C chunks
    share them), or (H, n) read through ``vidx`` (nnz,) int32, entry e's
    value being ``values[h, vidx[e]]`` (in range: the caller's
    guarantee); dense (H, C, N, K) and out (H, C, m, K) fp32 views whose
    last dimension is contiguous, any other strides (a chunk of out may be
    K columns of a wider row).  CUDA tensors only.

    Grouped-query attention's heads: values of ``Hin`` heads, dense of
    ``Hin >> s`` (input head i reads dense head ``i >> s``, ``s =
    head_shift``: the query heads reading their group's V) and out of
    ``Hin / S`` heads (out head o sums input heads ``o*S .. o*S + S-1`` in
    order: V's gradient summed over the group)."""
    Ho, C, m, K = out.shape
    dev = out.device
    nnz = cols.shape[0]
    H = values.shape[0] if values.dim() == 2 else -1
    sum_heads = H // Ho if Ho else 0
    if (dense.dim() != 4 or dense.shape[1] != C or dense.shape[3] != K
            or values.dim() != 2 or sum_heads * Ho != H or sum_heads < 1
            or row_ptr.shape != (m + 1,)
            or (vidx is None and values.shape[1] != nnz)
            or (vidx is not None and vidx.shape != (nnz,))):
        raise ValueError(f"spmm_launch: values {tuple(values.shape)}, dense "
                         f"{tuple(dense.shape)}, out {tuple(out.shape)} and "
                         f"row_ptr {tuple(row_ptr.shape)} do not fit")
    for name, t, dt in (("values", values, torch.float32),
                        ("dense", dense, torch.float32),
                        ("out", out, torch.float32),
                        ("row_ptr", row_ptr, torch.int64),
                        ("cols", cols, torch.int32),
                        ("vidx", vidx, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"spmm_launch: {name} is {t.dtype} on "
                            f"{t.device}, want {dt} on {dev}")
        if t.numel() > 1 and t.stride(-1) != 1:
            raise ValueError(f"spmm_launch: {name}'s last dimension must be "
                             "contiguous")
    gr = plan.group_rows
    for name, t, dt, w in (("tasks", plan.tasks, torch.int64, 2),
                           ("groups", plan.groups, torch.int64, 2 + gr),
                           ("items", plan.items, torch.int32, 1 + gr)):
        if (not isinstance(t, torch.Tensor) or t.dim() != 2
                or t.shape[1] != w or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"csr_spmm: plan.{name} must be spmm_plan's, "
                             "contiguous, on dense's device (SpmmPlan.to)")
    kv_shift = head_shift(H, dense.shape[0])
    if m == 0 or H == 0 or C == 0 or K == 0:
        return
    # columns per lane: float4 or float2 loads where K, the strides and the
    # pointers allow them
    strides = (dense.stride(0), dense.stride(1), dense.stride(2),
               out.stride(0), out.stride(1), out.stride(2))
    vec = 4 if K > 64 else 2 if K > 32 else 1
    while vec > 1 and (K % vec or any(st % vec for st in strides)
                       or dense.data_ptr() % (4 * vec)
                       or out.data_ptr() % (4 * vec)):
        vec //= 2
    with torch.cuda.device(dev):
        _kernels.launch(_kernels.SPMM_ENTRY, plan.tasks.data_ptr(),
                        plan.tasks.shape[0], plan.groups.data_ptr(),
                        plan.items.data_ptr(), gr, row_ptr.data_ptr(),
                        cols.data_ptr(), values.data_ptr(),
                        None if vidx is None else vidx.data_ptr(),
                        values.stride(0), dense.data_ptr(), dense.stride(2),
                        dense.stride(0), dense.stride(1), out.data_ptr(),
                        out.stride(2), out.stride(0), out.stride(1), K, Ho, C,
                        sum_heads, kv_shift, vec,
                        torch.cuda.current_stream().cuda_stream)


class SpmmPattern:
    """An entry list as the SpMM kernel's CSR, for the backward passes:
    ``out[r] = sum over entries e with rows[e] == r of values[e] *
    dense[cols[e]]``, for ``num_rows`` rows (rows[e] in range).

    Built once on the host (numpy, vectorised): the entries sorted by row,
    then column (``vidx``, int32: the position in ``values`` of each CSR
    entry, which the kernel reads its values through, None where it is the
    identity), the row pointers, and the kernel's plan at first use on the
    card.  ``entries`` (optional, one per entry, below 2^31) is the
    position of each entry's value in the values vector a call passes: a
    packed slot, say, so that the caller need not order its values."""

    def __init__(self, rows, cols, num_rows: int, device, entries=None):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        self.num_rows = int(num_rows)
        self.device = torch.device(device)
        if len(rows) and (rows.min() < 0 or rows.max() >= num_rows):
            raise ValueError(f"SpmmPattern: a row id is outside [0, "
                             f"{num_rows})")
        width = int(cols.max()) + 1 if len(cols) else 1
        order = np.argsort(rows * width + cols, kind="stable")
        perm = order if entries is None else np.asarray(
            entries, dtype=np.int64)[order]
        if len(perm) and perm.max() >= 2 ** 31:
            raise ValueError("SpmmPattern: value positions must fit int32")
        self.n_entries = len(rows)
        self.vidx = (None if np.array_equal(perm, np.arange(len(perm)))
                     else torch.as_tensor(perm, dtype=torch.int32,
                                          device=self.device))
        rows, cols = rows[order], cols[order]
        self._host = (np.searchsorted(rows, np.arange(num_rows + 1)), cols)
        self.rows = torch.as_tensor(rows, device=self.device)
        self.cols = torch.as_tensor(cols, dtype=torch.int32,
                                    device=self.device)
        self.row_ptr = torch.as_tensor(self._host[0], device=self.device)
        self._plan = None

    def plan(self) -> SpmmPlan:
        """The kernel's plan (``spmm_plan``), built at the first call."""
        if self._plan is None:
            with profiling.span("plan.build"):
                self._plan = spmm_plan(*self._host).to(self.device)
        return self._plan

    def __call__(self, values: torch.Tensor, dense: torch.Tensor,
                 out: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """values (H, n) (its entries at ``entries``, or in the list's
        order); dense (H, C, N, K) and out (H, C, num_rows, K), both with a
        contiguous last dimension: ``out[h, c] = S(values[h]) .
        dense[h, c]``, written.  On the card one kernel launch for all H x C
        that reads the values through ``vidx`` (``plain`` takes
        ``csr_spmm_plain`` per product), on the CPU the plain version.
        Grouped heads as ``spmm_launch``: dense of fewer heads, read by
        ``head_shift``; out of fewer heads, each the sum of its group's
        products in head order."""
        if plain or out.device.type == "cpu":
            v = (values[:, :self.n_entries] if self.vidx is None
                 else values.index_select(1, self.vidx))
            H, Ho = v.shape[0], out.shape[0]
            shift, per = head_shift(H, dense.shape[0]), H // Ho
            for o in range(Ho):
                for c in range(out.shape[1]):
                    acc = None
                    for i in range(o * per, (o + 1) * per):
                        part = csr_spmm_plain(v[i], self.rows, self.cols,
                                              dense[i >> shift, c],
                                              self.num_rows)
                        acc = part if acc is None else acc + part
                    out[o, c] = acc
            return out
        v = values.to(torch.float32)
        if self.vidx is None:
            v = v[:, :self.n_entries]
        spmm_launch(self.plan(), self.row_ptr, self.cols, v.contiguous(),
                    dense, out, self.vidx)
        return out


class GradPattern:
    """One pattern's backward passes, for H heads that share it (a batch
    laid out head by head, as ``stacked`` lays out the heads' CSR).  From
    the entries (rows[e], cols[e]) of an (m, n) pattern (any order), each
    built at first use and then kept:

    - ``spmm``: the SpMM over the pattern (an SDDMM's dA = (g ⊙ S)·B);
    - ``spmm_t``: over its transpose (an SDDMM's dB^T, an SpMM's d dense
      = S^T·dOut);
    - ``sddmm``: the gather-dot at the pattern with its plan, ``row_order``
      grouping its rows (an SpMM's d values)."""

    def __init__(self, rows, cols, shape, device, row_order=None):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.shape = tuple(int(x) for x in shape)
        self.device = torch.device(device)
        self.row_order = row_order

    @functools.cached_property
    def spmm(self) -> SpmmPattern:
        with profiling.span("plan.build"):
            return SpmmPattern(self.rows, self.cols, self.shape[0],
                               self.device)

    @functools.cached_property
    def spmm_t(self) -> SpmmPattern:
        with profiling.span("plan.build"):
            return SpmmPattern(self.cols, self.rows, self.shape[1],
                               self.device)

    @functools.cached_property
    def gather_index(self):
        """(rows, cols) int32 on the device and the gather-dot's plan."""
        def put(x):
            return torch.as_tensor(x, dtype=torch.int32, device=self.device)
        with profiling.span("plan.build"):
            plan = gather_plan(self.rows, self.cols, self.row_order)
            return put(self.rows), put(self.cols), plan.to(self.device)

    def sddmm(self, a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
        """(H, nnz) fp32 dots ``a[h, rows[e]] . bt[h, cols[e]]`` of a (H, m,
        K) and bt (H, n, K): one gather-dot launch on the card."""
        rows, cols, plan = self.gather_index
        if (a.dtype, bt.dtype) not in GATHER_STORAGE:
            a, bt = a.to(torch.float32), bt.to(torch.float32)
        return residual_gather_dot(a.contiguous(), bt.contiguous()[:, None],
                                   rows, cols, plan=plan)


def pattern_grads(plan, rows: torch.Tensor, cols: torch.Tensor, shape,
                  device) -> GradPattern:
    """The backward state of the (m, n) pattern of ``rows`` and ``cols``
    whose forward plan (``SpmmPlan`` or ``GatherPlan``) is ``plan``: kept
    on the plan as ``plan.grads``, built at its first backward from the
    index read back to the host; built for the one call where the caller
    keeps no plan.  A caller whose entries are H heads' block-diagonal
    copies of one pattern (``stacked``) sets ``plan.grads`` to that one
    head's ``GradPattern`` beforehand, so the heads share it."""
    grads = None if plan is None else plan.grads
    if grads is None:
        m = shape[0]
        if rows.numel() and bool(((rows < 0) | (rows >= m)).any()):
            raise ValueError(f"backward: a row id is outside [0, {m}); the "
                             "backward needs them in range")
        with profiling.span("plan.build"):
            grads = GradPattern(rows.cpu().numpy(), cols.cpu().numpy(),
                                shape, device)
        if plan is not None:
            plan.grads = grads
    return grads


class _SpmmFn(torch.autograd.Function):
    """csr_spmm_torch as an autograd op (B3)."""

    @staticmethod
    def forward(ctx, values, dense, rows, cols, num_rows, row_ptr, plan):
        ctx.save_for_backward(values, dense, rows, cols)
        ctx.num_rows, ctx.plan = num_rows, plan
        ctx.span = profiling.current()
        return _spmm_forward(values, rows, cols, dense, num_rows, row_ptr,
                             plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with profiling.span("spmm.backward", ctx.span):
            values, dense, rows, cols = ctx.saved_tensors
            m, n = ctx.num_rows, dense.shape[0]
            grads = pattern_grads(ctx.plan, rows, cols, (m, n), dense.device)
            heads = m // grads.shape[0]
            K = dense.shape[1]
            g = g.contiguous()
            d_values = d_dense = None
            if ctx.needs_input_grad[0]:
                d_values = grads.sddmm(g.view(heads, -1, K),
                                       dense.view(heads, -1, K)).reshape(-1)
            if ctx.needs_input_grad[1]:
                d_dense = torch.empty((n, K), dtype=torch.float32,
                                      device=dense.device)
                grads.spmm_t(values.to(torch.float32).view(heads, -1),
                             g.view(heads, 1, -1, K),
                             d_dense.view(heads, 1, -1, K))
            return d_values, d_dense, None, None, None, None, None


def csr_spmm_torch(values: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, dense: torch.Tensor, num_rows: int,
                   row_ptr: Optional[torch.Tensor] = None,
                   plan: Optional[SpmmPlan] = None) -> torch.Tensor:
    """out[r] = sum over entries i with rows[i] == r of values[i] *
    dense[cols[i]]: values/rows/cols (nnz,), dense (N, K) -> (num_rows, K).

    The JAX signature, plus ``row_ptr``: the (num_rows + 1,) row pointers
    of ``rows`` when the caller has them (then ``rows`` must be
    non-decreasing and match them; the kernel reads only ``row_ptr``).
    Without it, the row pointers are made here, after a stable sort of the
    entries by row when ``rows`` is not non-decreasing.  cols must be in
    range.  ``plan``: ``spmm_plan(row_ptr, cols).to(device)``, when the
    caller keeps one (else it is built here, which reads the row pointers
    and columns back to the host).  CUDA tensors go through the kernel (dense
    fp32, values cast to fp32 as JAX's astype does) or raise; CPU tensors
    through ``csr_spmm_plain``.

    Differentiable in ``values`` and ``dense`` (B3): d values is one
    gather-dot launch at the pattern, d dense one SpMM launch on the
    transpose, each taking the plain version on the CPU; it needs every row
    id in range.  Their state is built at the first backward and kept on
    ``plan`` (``pattern_grads``); without a plan it is built for each
    backward, as the forward then builds its plan for each call."""
    return _SpmmFn.apply(values, dense, rows, cols, num_rows, row_ptr, plan)


class HeadAggregation:
    """One pattern's aggregation for the H query heads of a grouped-query
    layer over the Hkv heads of V: ``out[h] = S(values[h]) . V[h >> s]``
    (``head_shift``), one SpMM launch over the pattern with a head stride,
    so no block-diagonal copy of the pattern a head and no copy of V a
    query head.  Built once per pattern: its CSR on the device, the
    kernel's plan (rows grouped in ``row_order``) and the backward's
    ``GradPattern``, whose pieces are built at the first backward."""

    def __init__(self, csr: CSR, device, row_order=None):
        self.device = torch.device(device)
        self.shape = csr.shape
        rows = csr.row_indices()
        self.rows = torch.as_tensor(rows, dtype=torch.int64,
                                    device=self.device)
        self.row_ptr = torch.as_tensor(csr.row_ptr, dtype=torch.int64,
                                       device=self.device)
        self.cols = torch.as_tensor(csr.col_idx, dtype=torch.int32,
                                    device=self.device)
        self.plan = spmm_plan(csr.row_ptr, csr.col_idx, row_order).to(
            self.device)
        self.grads = GradPattern(rows, csr.col_idx, csr.shape, self.device,
                                 row_order)


def _head_spmm_plain(agg, values, dense):
    shift = head_shift(values.shape[0], dense.shape[0])
    return torch.stack([csr_spmm_plain(values[h], agg.rows, agg.cols,
                                       dense[h >> shift], agg.shape[0])
                        for h in range(values.shape[0])])


class _HeadSpmmFn(torch.autograd.Function):
    """head_spmm as an autograd op: the values' cotangent is the gather-dot
    at the pattern (query head h against V of head h >> s), V's the SpMM on
    the transpose summing each group's query heads in order."""

    @staticmethod
    def forward(ctx, values, dense, agg, plain):
        ctx.save_for_backward(values, dense)
        ctx.agg, ctx.plain, ctx.span = agg, plain, profiling.current()
        if plain or dense.device.type == "cpu":
            return _head_spmm_plain(agg, values, dense)
        H, (m, _), K = values.shape[0], agg.shape, dense.shape[2]
        out = torch.empty((H, m, K), dtype=torch.float32,
                          device=dense.device)
        spmm_launch(agg.plan, agg.row_ptr, agg.cols, values.contiguous(),
                    dense[:, None], out[:, None])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, dense = ctx.saved_tensors
        agg, plain = ctx.agg, ctx.plain
        with profiling.span("spmm.backward", ctx.span):
            g = g.contiguous()
            d_values = d_dense = None
            if ctx.needs_input_grad[0]:
                if plain or g.device.type == "cpu":
                    rows, cols = agg.rows.to(torch.int32), agg.cols
                    s = head_shift(g.shape[0], dense.shape[0])
                    d_values = torch.stack([residual_gather_dot_plain(
                        g[h], dense[h >> s], rows, cols)
                        for h in range(g.shape[0])])
                else:
                    d_values = agg.grads.sddmm(g, dense)
            if ctx.needs_input_grad[1]:
                d_dense = torch.empty_like(dense)
                agg.grads.spmm_t(values.to(torch.float32), g[:, None],
                                 d_dense[:, None], plain)
            return d_values, d_dense, None, None


def head_spmm(values: torch.Tensor, dense: torch.Tensor,
              agg: HeadAggregation, plain: bool = False) -> torch.Tensor:
    """values (H, nnz) fp32 in the pattern's CSR order, dense (Hkv, n, K)
    fp32 -> (H, m, K): ``S(values[h]) . dense[h >> head_shift(H, Hkv)]``.
    Differentiable in both; the kernels on the card (one launch forward,
    one gather-dot and one SpMM backward), the plain versions on the CPU or
    with ``plain``."""
    if (values.dim() != 2 or dense.dim() != 3
            or values.shape[1] != agg.cols.shape[0]
            or dense.shape[1] != agg.shape[1]):
        raise ValueError(f"head_spmm: values {tuple(values.shape)} and dense "
                         f"{tuple(dense.shape)} do not fit the pattern "
                         f"{agg.shape} of {agg.cols.shape[0]} entries")
    head_shift(values.shape[0], dense.shape[0])
    return _HeadSpmmFn.apply(values, dense.contiguous(), agg, plain)


def csr_spmm(s: CSR, dense, values=None, device="cuda") -> np.ndarray:
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
