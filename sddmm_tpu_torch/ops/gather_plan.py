"""Row-group plans of the hand kernels, built once per pattern on the host.

Neighbouring rows of clustered, banded and attention patterns share most of
their columns, and a kernel that walks rows one by one reads a shared
column's dense row once per row that holds it.  A plan takes rows in groups
of up to GR and lists, per group, its distinct columns ("items"), each with
the entry of every row of the group there (or -1): a kernel then reads each
distinct column once for the whole group.  ``group_items`` is that listing;
``ops/spmm.py::spmm_plan`` (the SpMM's plan) and ``gather_plan`` here (the
gather-dot's, ``csrc/gather_dot.cu``) are both built on it.

The gather-dot's plan (``GatherPlan``) groups the distinct rows of a list
of entries ``(rows[e], keys[e])`` in a row order (the caller's, or
ascending), keeps a group where its distinct keys are at most
``GATHER_SHARE`` of its entries (else its rows become groups of one row),
and cuts each group's items into tasks of at most ``GATHER_TASK_ITEMS``
(a thread block each).  The group size comes from a cost on a sample of the
pattern; where no size beats the kernel's entry-order walk, the plan says
so (``group_rows == 1``, no arrays) and the kernel walks the entries in
their own order.  numpy only: plain code, tested on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the group sizes the gather-dot kernel has instances for (GR)
GATHER_GROUPS = (2, 4, 8, 16)
#: a group is kept where its distinct keys are at most this share of its
#: entries; otherwise its rows become groups of one row
GATHER_SHARE = 0.75
#: items per task (one thread block): a group with more is cut into tasks,
#: each of which stages the group's A rows again
GATHER_TASK_ITEMS = 512
#: entries of the sample the group size is chosen on, taken as blocks of
#: consecutive rows of the order spread over it
GATHER_SAMPLE_ENTRIES = 1 << 18
GATHER_SAMPLE_BLOCK = 256
#: column block of ``similar_rows_order``'s signatures
SIGNATURE_BLOCK = 16
#: the kernel's time model (ns), fitted by least squares to the device time
#: of 32 plans (clustered16, clustered128, banded and dlmc x 2 row orders x
#: 4 group sizes) of the CSR baseline at K=128 on an NVIDIA H100 80GB HBM3
#: at 700 W (``scripts/gather_sweep.py``; worst error 26 %): per task and
#: group row (the A rows a block stages), per batch of 32 items (their B^T
#: slices), and per row a batch computes, by group size
GATHER_NS_TASK_ROW = 0.98
GATHER_NS_BATCH = 2.49
GATHER_NS_BATCH_ROW = {2: 0.87, 4: 0.26, 8: 0.31, 16: 0.40}
#: and per entry of the entry-order walk (0.094-0.100 on the same cells)
GATHER_NS_ENTRY = 0.10


def group_items(e_group, e_slot, e_col, occ, ent, gr):
    """Items of entries tagged with their group and slot: the distinct
    (group, column, occurrence) triples ascending, as (items (I, 1 + gr)
    int32 ``[column, entry of each slot or -1]``, the group of each
    item)."""
    order = np.lexsort((occ, e_col, e_group))
    g_s, c_s, o_s = e_group[order], e_col[order], occ[order]
    new = (np.r_[True, (g_s[1:] != g_s[:-1]) | (c_s[1:] != c_s[:-1])
                 | (o_s[1:] != o_s[:-1])] if len(order)
           else np.zeros(0, dtype=bool))
    item_of = np.cumsum(new) - 1
    items = np.full((int(new.sum()), 1 + gr), -1, dtype=np.int32)
    items[item_of, 0] = c_s
    items[item_of, 1 + e_slot[order]] = ent[order]
    return items, g_s[new]


def occurrences(e_row, e_col):
    """Per entry, how many earlier entries of its row hold the same
    column (0 unless a column repeats within a row)."""
    n = len(e_row)
    occ = np.zeros(n, dtype=np.int64)
    if n < 2:
        return occ
    o = np.lexsort((np.arange(n), e_col, e_row))
    r_s, c_s = e_row[o], e_col[o]
    new = np.r_[True, (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])]
    if new.all():
        return occ
    idx = np.arange(n)
    occ[o] = idx - np.maximum.accumulate(np.where(new, idx, 0))
    return occ


@dataclasses.dataclass
class GatherPlan:
    """The gather-dot kernel's plan of one list of entries for groups of
    ``group_rows`` (GR) rows: ``tasks`` (T, 3) int32 ``[group, first item,
    end item]``, a thread block each; ``groups`` (NG, 2 + GR) int32
    ``[first item, end item, its 1..GR rows, -1 past them]``; ``items``
    (I, 1 + GR) int32 ``[key, entry of each row of the group or -1]``,
    ascending by key within a group.  ``n`` is the number of entries the
    plan covers.  ``group_rows == 1`` means the entry-order walk, with no
    arrays.  numpy arrays, or tensors after ``to``.  ``grads``: the
    pattern's backward state where the CSR baseline is differentiated
    (``spmm.pattern_grads``)."""
    tasks: object
    groups: object
    items: object
    group_rows: int
    n: int
    grads: object = None

    def to(self, device) -> "GatherPlan":
        return GatherPlan(*(torch.as_tensor(x, device=device).contiguous()
                            for x in (self.tasks, self.groups, self.items)),
                          self.group_rows, self.n)

    @property
    def grouped(self) -> bool:
        return self.group_rows > 1


def _entry_order_plan(n: int) -> GatherPlan:
    z = np.zeros((0, 3), dtype=np.int32)
    return GatherPlan(z, np.zeros((0, 3), dtype=np.int32),
                      np.zeros((0, 2), dtype=np.int32), 1, n)


def _row_positions(rows, row_order):
    """(the distinct rows of ``rows`` in the order, each entry's position
    in that list)."""
    present = np.unique(rows)
    if row_order is None:
        ordered = present
    else:
        row_order = np.asarray(row_order, dtype=np.int64)
        if len(np.unique(row_order)) != len(row_order):
            raise ValueError("gather_plan: row_order repeats a row")
        size = int(max(present.max(initial=-1), row_order.max(initial=-1)))
        rank = np.full(size + 1, len(row_order), dtype=np.int64)
        rank[row_order] = np.arange(len(row_order))
        ordered = present[np.lexsort((present, rank[present]))]
    pos = np.empty(int(ordered.max(initial=-1)) + 1, dtype=np.int64)
    pos[ordered] = np.arange(len(ordered))
    return ordered, pos[rows]


def _plan(rows, keys, occ, ordered, e_pos, gr):
    """(groups, items) of the entries at group size ``gr``."""
    n_cand = -(-len(ordered) // gr)
    cand, slot = e_pos // gr, e_pos % gr
    ent = np.arange(len(rows))
    o = np.lexsort((occ, keys, cand))
    c_s, k_s, o_s = cand[o], keys[o], occ[o]
    new = np.r_[True, (c_s[1:] != c_s[:-1]) | (k_s[1:] != k_s[:-1])
                | (o_s[1:] != o_s[:-1])]
    keep = (np.bincount(c_s[new], minlength=n_cand)
            <= GATHER_SHARE * np.bincount(cand, minlength=n_cand))
    # kept candidates stay groups; the rows of the others, groups of one
    rows_of_cand = np.full((n_cand, gr), -1, dtype=np.int64)
    rows_of_cand.reshape(-1)[:len(ordered)] = ordered
    kept = np.flatnonzero(keep)
    new_of_cand = np.full(n_cand, -1, dtype=np.int64)
    new_of_cand[kept] = np.arange(len(kept))
    single_pos = np.flatnonzero(~keep[np.arange(len(ordered)) // gr])
    single_of_pos = np.full(len(ordered), -1, dtype=np.int64)
    single_of_pos[single_pos] = len(kept) + np.arange(len(single_pos))
    in_kept = keep[cand]
    e_group = np.where(in_kept, new_of_cand[cand], single_of_pos[e_pos])
    e_slot = np.where(in_kept, slot, 0)
    items, item_group = group_items(e_group, e_slot, keys, occ, ent, gr)
    n_groups = len(kept) + len(single_pos)
    g_rows = np.full((n_groups, gr), -1, dtype=np.int64)
    g_rows[:len(kept)] = rows_of_cand[kept]
    g_rows[len(kept):, 0] = ordered[single_pos]
    bounds = np.searchsorted(item_group, np.arange(n_groups + 1))
    groups = np.concatenate([bounds[:-1, None], bounds[1:, None], g_rows],
                            axis=1)
    return groups, items


def _tasks(groups):
    """(T, 3) ``[group, first item, end item]``: each group's items cut
    into runs of at most ``GATHER_TASK_ITEMS``."""
    first, end = groups[:, 0], groups[:, 1]
    count = np.maximum(1, -(-(end - first) // GATHER_TASK_ITEMS))
    g = np.repeat(np.arange(len(groups)), count)
    k = np.arange(len(g)) - np.repeat(np.cumsum(count) - count, count)
    t0 = first[g] + k * GATHER_TASK_ITEMS
    return np.stack([g, t0, np.minimum(end[g], t0 + GATHER_TASK_ITEMS)],
                    axis=1)


def plan_cost(plan: "GatherPlan") -> float:
    """The time model's ns for a plan: tasks x group rows, batches of 32
    items, and the rows each batch computes (those some item of it holds);
    the entry-order walk, entries."""
    if not plan.grouped:
        return GATHER_NS_ENTRY * plan.n
    tasks, items = np.asarray(plan.tasks), np.asarray(plan.items)
    gr = plan.group_rows
    if len(items) == 0:
        return 0.0
    mask = ((items[:, 1:] >= 0).astype(np.int64)
            << np.arange(gr, dtype=np.int64)).sum(axis=1)
    n = tasks[:, 2] - tasks[:, 1]
    per = -(-n // 32)
    starts = (np.repeat(tasks[:, 1], per)
              + 32 * (np.arange(per.sum()) - np.repeat(np.cumsum(per) - per,
                                                      per)))
    union = np.bitwise_or.reduceat(mask, starts)
    rows = sum(int(((union >> r) & 1).sum()) for r in range(gr))
    return (GATHER_NS_TASK_ROW * len(tasks) * gr + GATHER_NS_BATCH * len(
        starts) + GATHER_NS_BATCH_ROW[gr] * rows)


def _sample(ordered, e_pos):
    """The entries of a sample of the order's rows, about
    ``GATHER_SAMPLE_ENTRIES`` of them: blocks of ``GATHER_SAMPLE_BLOCK``
    consecutive rows (a multiple of every group size) spread evenly over
    the order, so that a pattern whose first rows differ from the rest (a
    power law's hubs) is sampled as a whole."""
    counts = np.bincount(e_pos, minlength=len(ordered))
    n_blocks = -(-len(ordered) // GATHER_SAMPLE_BLOCK)
    per_block = np.add.reduceat(counts, np.arange(0, len(ordered),
                                                  GATHER_SAMPLE_BLOCK))
    want = max(1, int(np.ceil(GATHER_SAMPLE_ENTRIES
                              / max(1.0, per_block.mean()))))
    take = np.unique(np.linspace(0, n_blocks - 1, min(want, n_blocks))
                     .round().astype(np.int64))
    keep = np.zeros(n_blocks, dtype=bool)
    keep[take] = True
    return keep[e_pos // GATHER_SAMPLE_BLOCK]


def sample_costs(rows, keys, row_order=None) -> dict:
    """{GR: the time model's ns per entry} at GR = 1 (the entry-order
    walk) and every ``GATHER_GROUPS`` size, on a sample of the order's
    rows (``_sample``)."""
    rows = np.asarray(rows, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    if len(rows) == 0:
        return {1: 0.0}
    ordered, e_pos = _row_positions(rows, row_order)
    sel = _sample(ordered, e_pos)
    r, c = rows[sel], keys[sel]
    # the sampled rows, renumbered in the order (blocks stay contiguous)
    present = np.unique(e_pos[sel])
    p = np.searchsorted(present, e_pos[sel])
    occ = occurrences(r, c)
    n_s = len(r)
    costs = {1: GATHER_NS_ENTRY}
    for gr in GATHER_GROUPS:
        groups, items = _plan(r, c, occ, ordered[present], p, gr)
        plan = GatherPlan(_tasks(groups), groups, items, gr, n_s)
        costs[gr] = plan_cost(plan) / n_s
    return costs


def gather_plan(rows, keys, row_order=None,
                group_rows=None) -> GatherPlan:
    """The gather-dot's plan of the entries ``(rows[e], keys[e])`` (any
    order; ``keys`` the B^T row, or ``gid * G + member``, of each entry).
    Rows are grouped in ``row_order`` (a sequence of row ids; rows it
    leaves out come after it, ascending; default ascending).
    ``group_rows`` None picks GR = 1 (the entry-order walk) or one of
    ``GATHER_GROUPS`` by ``sample_costs``."""
    rows = np.asarray(rows, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    if rows.shape != keys.shape or rows.ndim != 1:
        raise ValueError(f"gather_plan: rows {rows.shape} and keys "
                         f"{keys.shape} must be one (n,) pair")
    n = len(rows)
    if group_rows is None:
        costs = sample_costs(rows, keys, row_order)
        group_rows = min(costs, key=costs.get)
    if group_rows == 1 or n == 0:
        return _entry_order_plan(n)
    if group_rows not in GATHER_GROUPS:
        raise ValueError(f"gather_plan: group_rows={group_rows}, want 1 or "
                         f"one of {GATHER_GROUPS}")
    if n >= 2 ** 31:
        raise ValueError("gather_plan: entry ids must fit int32")
    ordered, e_pos = _row_positions(rows, row_order)
    groups, items = _plan(rows, keys, occurrences(rows, keys), ordered,
                          e_pos, group_rows)
    return GatherPlan(_tasks(groups).astype(np.int32),
                      groups.astype(np.int32), items, group_rows, n)


def similar_rows_order(row_ptr, cols, block: int = SIGNATURE_BLOCK
                       ) -> np.ndarray:
    """The rows sorted by two min-hashes of the column blocks
    (``col // block``) they touch: rows with the same set of blocks (a
    planted row cluster, however its rows were shuffled) come together.
    Empty rows come last."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m = len(row_ptr) - 1
    lengths = np.diff(row_ptr)
    blk = cols // block
    sig = []
    for mult, add in ((0x9E3779B1, 0x7F4A7C15), (0x85EBCA77, 0x165667B1)):
        h = (blk * mult + add) % 0xFFFFFFFB
        s = np.full(m, np.iinfo(np.int64).max, dtype=np.int64)
        nz = lengths > 0
        s[nz] = np.minimum.reduceat(h, row_ptr[:-1][nz]) if len(h) else 0
        sig.append(s)
    return np.lexsort((np.arange(m), sig[1], sig[0]))


def csr_gather_plan(row_ptr, cols) -> GatherPlan:
    """The CSR baseline's plan of a pattern: the pattern's row order or
    ``similar_rows_order``, whichever ``sample_costs`` rates cheaper, and
    its group size."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    best = None
    for order in (None, similar_rows_order(row_ptr, cols)):
        costs = sample_costs(rows, cols, order)
        gr = min(costs, key=costs.get)
        if best is None or costs[gr] < best[0]:
            best = (costs[gr], gr, order)
    _, gr, order = best
    return gather_plan(rows, cols, order, gr)


def plan_entries(plan: GatherPlan) -> list:
    """``[(row, entry ids, keys)]`` per group row, in the kernel's item
    order: what the plan computes, for tests."""
    groups, items = np.asarray(plan.groups), np.asarray(plan.items)
    out = []
    gr = plan.group_rows
    for g in groups:
        it = items[g[0]:g[1]]
        for r in range(gr):
            row = g[2 + r]
            if row < 0:
                continue
            has = it[:, 1 + r] >= 0
            out.append((int(row), it[has, 1 + r].astype(np.int64),
                        it[has, 0].astype(np.int64)))
    return out
