"""CSR SpMM (sparse @ dense): the aggregation step of the attention models.

Counterpart of ``sddmm_tpu/ops/spmm.py`` (``csr_spmm_jax``, ``csr_spmm``):
``out[r] = sum_{i: rows[i] == r} values[i] * dense[cols[i]]``, with fp32
products and sums.  The JAX package gathers the dense rows, scales them and
segment-sums them into rows; here a CUDA tensor goes through the hand
kernel ``csrc/spmm.cu``, and a CPU tensor through ``csr_spmm_plain``
(``index_add_``).  The kernel walks a plan built once on the host from the
pattern (``spmm_plan``): panels of ``SPMM_PANEL_ROWS`` rows that share
most of their columns (a band, a causal triangle), a block each, which
stage each distinct column's dense row once in shared memory for every
row of the panel; the other rows in groups of 2 or 4 rows that share
columns, a warp each, reading each dense row their rows share once; and
each row longer than ``SPMM_LONG_ROW`` entries outside a panel split into
8 pieces across the warps of one block, whose partial sums are added in a
fixed order (``spmm_pieces`` lists what each row adds, in the kernel's
order; ``csr_spmm_split_plain`` is that order in PyTorch ops, bit for
bit).  No atomics: the result is deterministic.  Row ids outside ``[0,
num_rows)`` are dropped on both paths, as ``jax.ops.segment_sum`` drops
them.

One launch runs a batch of H x C products over one pattern
(``spmm_launch``: head and chunk strides on values, dense and out, and a
row stride on out), which the attention layers' aggregation
(``head_spmm``) and the backward passes use.  ``csr_spmm_torch`` is
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
#: rows of a panel and distinct columns of one of its chunks (csrc/spmm.cu
#: kPanelRows, kChunkCols)
SPMM_PANEL_ROWS = 64
SPMM_PANEL_COLS = 32
#: a panel's rows take the panel path where its entries are at least this
#: many times its distinct columns (the dense rows it reads): the
#: break-even against the row groups on an NVIDIA H100 80GB HBM3 at 700 W,
#: 12-13 at K = 64 and 17-18 at K = 128, on banded rows that keep a share
#: of a 512-column band, 12 heads a launch with a head stride over one copy
#: of the pattern (``scripts/spmm_panel_sweep.py --sweep``); a panel costs
#: about its rows x distinct columns, whatever share of them holds an entry
SPMM_PANEL_REUSE = 18.0


@dataclasses.dataclass
class SpmmPlan:
    """The SpMM kernel's plan of one pattern (``spmm_plan``).

    Panels: ``panels`` (NP, 2) int64 ``[first chunk, end chunk]``, the
    heaviest first; ``panel_rows`` (NP, SPMM_PANEL_ROWS) int64, its rows
    (-1 past them); per chunk of ``SPMM_PANEL_COLS`` of a panel's distinct
    columns (ascending): ``chunk_cols`` (NCH, SPMM_PANEL_COLS) int32 the
    columns (-1 past them), ``chunk_masks`` (NCH, SPMM_PANEL_ROWS) int32
    bit j set where the panel's row holds column j of the chunk, and
    ``chunk_before`` (NCH, SPMM_PANEL_ROWS) int32 the row's entries in the
    panel's earlier chunks.  ``panel_entries``: the entries in panels.

    The other rows, in groups of up to ``group_rows`` (GR) rows: ``tasks``
    (T, 2) int64, a block each, ``[first group, count 1..8]`` or ``[row,
    0]`` for one long row; ``groups`` (G, 2 + GR) int64 ``[first item, end
    item, its 1..GR rows, -1 past them]``; ``items`` (I, 1 + GR) int32,
    each a distinct column of its group and the entry of each of the
    group's rows there (-1 where the row has none), ascending by column
    within a group.  A group of one row has no items: it walks its CSR
    entries.

    numpy arrays, or tensors after ``to``.  ``grads``: the pattern's
    backward state (``pattern_grads``)."""
    tasks: object
    groups: object
    items: object
    group_rows: int
    panels: object
    panel_rows: object
    chunk_cols: object
    chunk_masks: object
    chunk_before: object
    panel_entries: int
    grads: Optional["GradPattern"] = None

    def to(self, device) -> "SpmmPlan":
        return dataclasses.replace(self, grads=None, **{
            name: torch.as_tensor(getattr(self, name), device=device)
            .contiguous() for name in _PLAN_ARRAYS})


#: SpmmPlan's arrays: name -> (dtype, width; None: 2 + GR for groups, 1 + GR
#: for items)
_PLAN_ARRAYS = {"tasks": (torch.int64, 2), "groups": (torch.int64, None),
                "items": (torch.int32, None),
                "panels": (torch.int64, 2),
                "panel_rows": (torch.int64, SPMM_PANEL_ROWS),
                "chunk_cols": (torch.int32, SPMM_PANEL_COLS),
                "chunk_masks": (torch.int32, SPMM_PANEL_ROWS),
                "chunk_before": (torch.int32, SPMM_PANEL_ROWS)}


def spmm_plan(row_ptr, cols, row_order=None, group_rows=None) -> SpmmPlan:
    """The plan of the CSR pattern ``(row_ptr, cols)``, in numpy.  The rows,
    taken in ``row_order`` (a permutation of the rows; default 0..m-1), are
    cut into panels of ``SPMM_PANEL_ROWS`` consecutive rows; a panel whose
    rows each hold their columns once and in ascending order, and whose
    entries are at least ``SPMM_PANEL_REUSE`` times its distinct columns,
    goes to the panel path (``_plan_panels``).  Of the other rows, every
    row longer than ``SPMM_LONG_ROW`` entries is a task of its own (first,
    so that they start early), and the rest, in the order, go in groups of
    ``group_rows`` consecutive rows; a group whose distinct columns are
    more than ``SPMM_SHARE`` of its entries is split into groups of one
    row.  8 groups a task.  A column that a row holds twice gets an item
    per occurrence.

    ``group_rows`` None picks one of ``SPMM_GROUPS`` from what the pattern
    shows: the plan of its first ``SPMM_SAMPLE_ROWS`` short rows outside
    panels (in the order) at each size, costed as items x (2 + GR), since
    a warp's work per item grows with the rows it carries (on the card,
    GR = 4 took 1.3x GR = 2's time on the graph model's aggregation for
    0.75x its items)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m = len(row_ptr) - 1
    order = (np.arange(m) if row_order is None
             else np.asarray(row_order, dtype=np.int64))
    if not np.array_equal(np.sort(order), np.arange(m)):
        raise ValueError("spmm_plan: row_order is not a permutation of the "
                         f"{m} rows")
    if group_rows is not None and group_rows not in SPMM_GROUPS:
        raise ValueError(f"spmm_plan: group_rows={group_rows}, want one of "
                         f"{SPMM_GROUPS}")
    panels, in_panel = _plan_panels(row_ptr, cols, order)
    lengths = np.diff(row_ptr)
    is_long = lengths > SPMM_LONG_ROW
    short = order[~(is_long | in_panel)[order]]
    sampled = {}
    if group_rows is None:
        head = short[:SPMM_SAMPLE_ROWS]
        sampled = {gr: _plan_groups(row_ptr, cols, head, gr)
                   for gr in SPMM_GROUPS}
        group_rows = min(SPMM_GROUPS, key=lambda gr: len(
            sampled[gr][1]) * (2 + gr))
        if len(head) < len(short):
            sampled = {}
    # a sample that held every short row is the plan itself
    groups, items = sampled.get(group_rows) or _plan_groups(
        row_ptr, cols, short, group_rows)
    long_rows = np.flatnonzero(is_long & ~in_panel)
    t0 = np.arange(0, len(groups), SPMM_WARPS)
    tasks = np.concatenate([
        np.stack([long_rows, np.zeros_like(long_rows)], axis=1),
        np.stack([t0, np.minimum(SPMM_WARPS, len(groups) - t0)], axis=1)
    ]).astype(np.int64).reshape(-1, 2)
    return SpmmPlan(tasks, groups, items, group_rows, **panels)


def _plan_panels(row_ptr, cols, order):
    """The panel path's part of ``spmm_plan``: (its ``SpmmPlan`` fields,
    (m,) bool the rows it takes).  Candidates are ``SPMM_PANEL_ROWS``
    consecutive rows of ``order``; one is taken where its rows' columns
    strictly ascend and its entries are at least ``SPMM_PANEL_REUSE`` times
    its distinct columns.  Vectorised: one stable sort of the entries by
    (candidate, column)."""
    P, CH = SPMM_PANEL_ROWS, SPMM_PANEL_COLS
    m = len(row_ptr) - 1
    lengths = np.diff(row_ptr)
    rank = np.empty(m, dtype=np.int64)
    rank[order] = np.arange(m)
    cand_of_row, slot_of_row = rank // P, rank % P
    n_cand = -(-m // P)
    row_of = np.repeat(np.arange(m), lengths)
    e_cand = cand_of_row[row_of]
    # a candidate with a row whose columns do not strictly ascend is out
    out_of_order = (row_of[1:] == row_of[:-1]) & (cols[1:] <= cols[:-1])
    ok = np.bincount(e_cand[1:][out_of_order], minlength=n_cand) == 0
    width = int(cols.max()) + 1 if len(cols) else 1
    by_key = np.argsort(e_cand * width + cols, kind="stable")
    c_s, k_s = e_cand[by_key], cols[by_key]
    new = np.r_[True, (c_s[1:] != c_s[:-1]) | (k_s[1:] != k_s[:-1])] \
        if len(by_key) else np.zeros(0, dtype=bool)
    distinct = np.bincount(c_s[new], minlength=n_cand)
    entries = np.bincount(e_cand, minlength=n_cand)
    ok &= (entries > 0) & (entries >= SPMM_PANEL_REUSE * distinct)
    # the taken panels, the most chunks first, and their chunks in turn
    n_chunks = -(-distinct // CH)
    taken = np.flatnonzero(ok)
    taken = taken[np.argsort(-n_chunks[taken], kind="stable")]
    panel_of = np.full(n_cand, -1, dtype=np.int64)
    panel_of[taken] = np.arange(len(taken))
    chunk0 = np.zeros(n_cand, dtype=np.int64)
    chunk0[taken] = np.cumsum(n_chunks[taken]) - n_chunks[taken]
    n_ch = int(n_chunks[taken].sum())
    # each entry's position among its panel's distinct columns
    uniq_of = np.cumsum(new) - 1
    first_uniq = np.searchsorted(c_s[new], np.arange(n_cand))
    pos = np.empty(len(cols), dtype=np.int64)
    pos[by_key] = uniq_of - first_uniq[c_s]
    sel = np.flatnonzero(ok[e_cand])
    s_cand, s_pos = e_cand[sel], pos[sel]
    s_chunk = chunk0[s_cand] + s_pos // CH
    s_cell = s_chunk * P + slot_of_row[row_of[sel]]
    chunk_cols = np.full((n_ch, CH), -1, dtype=np.int32)
    chunk_cols.reshape(-1)[s_chunk * CH + s_pos % CH] = cols[sel]
    chunk_masks = np.bincount(
        s_cell, weights=np.ldexp(1.0, s_pos % CH), minlength=n_ch * P
    ).astype(np.int64).astype(np.uint32).view(np.int32).reshape(n_ch, P)
    # a row's entries before each chunk: its first entry there, less the
    # row's start (the entries are in CSR order, so ascending by column)
    first_in = np.r_[True, s_cell[1:] != s_cell[:-1]] if len(sel) \
        else np.zeros(0, dtype=bool)
    chunk_before = np.zeros(n_ch * P, dtype=np.int32)
    chunk_before[s_cell[first_in]] = (
        sel[first_in] - row_ptr[row_of[sel[first_in]]])
    panel_rows = np.full((len(taken), P), -1, dtype=np.int64)
    rows_in = np.flatnonzero(ok[cand_of_row])
    panel_rows[panel_of[cand_of_row[rows_in]], slot_of_row[rows_in]] = rows_in
    panels = np.stack([chunk0[taken], chunk0[taken] + n_chunks[taken]],
                      axis=1).reshape(-1, 2)
    return dict(panels=panels, panel_rows=panel_rows, chunk_cols=chunk_cols,
                chunk_masks=chunk_masks,
                chunk_before=chunk_before.reshape(n_ch, P),
                panel_entries=int(len(sel))), ok[cand_of_row]


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
    kernel's order (a panel row's entries and a lone row's in CSR order,
    which ascends by column in a panel; a group row's in item order; a long
    row's 8 pieces of ``ceil(n / SPMM_WARPS)`` entries, the last ones
    shorter or empty).  A row's pieces are consecutive."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    groups, items = _host(plan.groups), _host(plan.items)
    panel_rows = _host(plan.panel_rows)
    out = [(row, np.arange(row_ptr[row], row_ptr[row + 1]))
           for row in panel_rows[panel_rows >= 0]]
    for first, count in _host(plan.tasks):
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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def csr_spmm_split_plain(values: torch.Tensor, cols: torch.Tensor,
                         dense: torch.Tensor, row_ptr, plan: SpmmPlan,
                         vidx: Optional[torch.Tensor] = None,
                         out_heads: Optional[int] = None) -> torch.Tensor:
    """The kernel's sums in PyTorch ops, bit for bit: each piece of
    ``spmm_pieces`` summed entry by entry from 0 (each product rounded to
    fp32, then added in fp32), a row's pieces added in order to its first.
    values (nnz,) and dense (N, K) -> (m, K) for the (m+1,) ``row_ptr``.
    Or heads, as ``spmm_launch`` takes them: values (H, n), entry e's
    value at ``vidx[e]`` where given; dense (Hd, N, K), input head i
    reading dense head ``i >> head_shift(H, Hd)``; -> (out_heads, m, K),
    output head o summing input heads o*S .. o*S + S-1 (S = H //
    out_heads) in order, each piece's sum running on through them."""
    one = values.dim() == 1
    if one:
        values, dense = values[None], dense[None]
    H, dev, K = values.shape[0], dense.device, dense.shape[-1]
    Ho = H if out_heads is None else out_heads
    per, shift = H // Ho, head_shift(H, dense.shape[0])
    vals = values.to(torch.float32)
    if vidx is not None:
        vals = vals.index_select(1, vidx.long())
    cols = cols.long()
    pieces = spmm_pieces(plan, row_ptr)
    # the pieces longest first, so that step j adds to a prefix of them
    lens = np.array([len(e) for _, e in pieces], dtype=np.int64)
    by_len = np.argsort(-lens, kind="stable")
    flat = torch.as_tensor(np.concatenate(
        [pieces[p][1] for p in by_len] + [np.zeros(0, np.int64)]),
        device=dev)
    starts = torch.as_tensor(np.cumsum(lens[by_len]) - lens[by_len],
                             device=dev)
    live = [int((lens > j).sum()) for j in range(int(lens.max(initial=0)))]
    # a piece's rank among its row's pieces, and the rows of each rank
    rows = np.array([row for row, _ in pieces], dtype=np.int64)
    run = np.r_[True, rows[1:] != rows[:-1]] if len(rows) else rows > 0
    idx = np.arange(len(rows))
    rank = idx - np.maximum.accumulate(np.where(run, idx, 0))
    place = np.empty(len(rows), dtype=np.int64)
    place[by_len] = np.arange(len(rows))
    # every output head at once: its input head o*S + s at turn s
    acc = torch.zeros((Ho, len(rows), K), dtype=torch.float32, device=dev)
    for s in range(per):
        heads = torch.arange(Ho, device=dev) * per + s
        d = dense[heads >> shift].to(torch.float32)
        v = vals[heads]
        for j, n in enumerate(live):
            e = flat[starts[:n] + j]
            acc[:, :n] = acc[:, :n] + v[:, e, None] * d[:, cols[e]]
    out = torch.zeros((Ho, len(row_ptr) - 1, K), dtype=torch.float32,
                      device=dev)
    for k in range(int(rank.max(initial=-1)) + 1):
        sel = np.flatnonzero(rank == k)
        r = torch.as_tensor(rows[sel], device=dev)
        part = acc[:, torch.as_tensor(place[sel], device=dev)]
        out[:, r] = part if k == 0 else out[:, r] + part
    return out[0] if one else out


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
    order: V's gradient summed over the group).

    One kernel: the panels' (its grid running the plan's row groups too)
    where the plan has panels, else the row groups'.  While spans are on,
    the entries it sends down the panel path and all its entries, times
    its batches, go to ``profiling.count_spmm``."""
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
    group_args, panel_args = _plan_args(plan, dev)
    kv_shift = head_shift(H, dense.shape[0])
    if panel_args[1] and values.shape[1] >= 2 ** 31:
        raise ValueError("spmm_launch: the panel path takes below 2^31 "
                         "values a head")
    if m == 0 or H == 0 or C == 0 or K == 0:
        return
    if profiling.active():
        profiling.count_spmm(plan.panel_entries * H * C, nnz * H * C)
    # floats a copy or store: 4 or 2 where K, the strides and the pointers
    # allow them; the row groups' lanes take no more than K needs
    vec = 4
    while vec > 1 and (K % vec or dense.data_ptr() % (4 * vec)
                       or out.data_ptr() % (4 * vec)
                       or any(st % vec for st in (
                           dense.stride(0), dense.stride(1), dense.stride(2),
                           out.stride(0), out.stride(1), out.stride(2)))):
        vec //= 2
    with torch.cuda.device(dev):
        _kernels.launch(_kernels.SPMM_ENTRY, *group_args, row_ptr.data_ptr(),
                        cols.data_ptr(), values.data_ptr(),
                        None if vidx is None else vidx.data_ptr(),
                        values.stride(0), dense.data_ptr(), dense.stride(2),
                        dense.stride(0), dense.stride(1), out.data_ptr(),
                        out.stride(2), out.stride(0), out.stride(1), K, Ho, C,
                        sum_heads, kv_shift,
                        min(vec, 4 if K > 64 else 2 if K > 32 else 1),
                        *panel_args, vec,
                        torch.cuda.current_stream().cuda_stream)


def _plan_args(plan: SpmmPlan, dev) -> tuple:
    """The plan's arrays as the kernel's arguments: (tasks, their count,
    groups, items, the group size) and (panels, their count, panel_rows,
    chunk_cols, chunk_masks, chunk_before).  Raises unless the arrays are
    ``spmm_plan``'s on ``dev`` (``SpmmPlan.to``); checked and kept once for
    the arrays a plan holds."""
    arrays = tuple(getattr(plan, name) for name in _PLAN_ARRAYS)
    seen = plan.__dict__.get("_args")
    if (seen is not None and seen[0] == dev
            and all(a is b for a, b in zip(seen[1], arrays))):
        return seen[2]
    gr = plan.group_rows
    for (name, (dt, w)), t in zip(_PLAN_ARRAYS.items(), arrays):
        w = w or (2 + gr if name == "groups" else 1 + gr)
        if (not isinstance(t, torch.Tensor) or t.dim() != 2
                or t.shape[1] != w or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"csr_spmm: plan.{name} must be spmm_plan's, "
                             "contiguous, on dense's device (SpmmPlan.to)")
    tasks, groups, items, panels, *chunks = arrays
    args = ((tasks.data_ptr(), tasks.shape[0], groups.data_ptr(),
             items.data_ptr(), gr),
            (panels.data_ptr(), panels.shape[0],
             *(t.data_ptr() for t in chunks)))
    plan.__dict__["_args"] = (dev, arrays, args)
    return args


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
    laid out head by head).  From the entries (rows[e], cols[e]) of an (m,
    n) pattern (any order), each built at first use and then kept:

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
    keeps no plan."""
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
            g = g.contiguous()
            d_values = d_dense = None
            if ctx.needs_input_grad[0]:
                d_values = grads.sddmm(g[None], dense[None])[0]
            if ctx.needs_input_grad[1]:
                d_dense = torch.empty((n, dense.shape[1]), dtype=torch.float32,
                                      device=dense.device)
                grads.spmm_t(values.to(torch.float32)[None], g[None, None],
                             d_dense[None, None])
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
    """One pattern's aggregation for the H query heads of an attention
    layer over the Hkv heads of V (Hkv = H but in a grouped-query layer):
    ``out[h] = S(values[h]) . V[h >> s]`` (``head_shift``), one SpMM launch
    over the pattern with a head stride, so no copy of the pattern a head
    and no copy of V a query head.  Built once per pattern: its CSR on the
    device, the kernel's plan (rows grouped in ``row_order``) and the
    backward's ``GradPattern``, whose pieces are built at the first
    backward."""

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
