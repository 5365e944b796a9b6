"""Structural invariant checkers for the reordering/packing pipeline.

Reference: the VALIDATE-gated checkers in src/BSMR.cpp —
check_rowReordering (:444-486), check_colReordering (:488-637),
check_rphm (:639-824).  Raise AssertionError on violation.
"""

from __future__ import annotations

import math

import numpy as np

from sddmm_tpu_torch import config
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import PackedMatrix


def check_row_reordering(csr: CSR, bsmr: BSMR) -> None:
    """reordered_rows is a permutation of exactly the non-empty rows."""
    rr = bsmr.reordered_rows
    nonempty = np.nonzero(csr.row_nnz() > 0)[0]
    assert len(rr) == len(nonempty), \
        f"row count mismatch: {len(rr)} vs {len(nonempty)} non-empty"
    assert len(np.unique(rr)) == len(rr), "duplicate rows in reordering"
    assert np.array_equal(np.sort(rr), nonempty), \
        "reordered rows are not exactly the non-empty rows"
    # cluster ids grouped: rows appear in non-decreasing cluster order.
    cl = bsmr.cluster_ids[rr]
    assert np.all(np.diff(cl) >= 0), "rows not grouped by cluster"


def check_col_reordering(csr: CSR, bsmr: BSMR) -> None:
    if getattr(bsmr, "group_size", 1) > 1 or bsmr.col_rank is not None:
        return _check_grouped_col_reordering(csr, bsmr)
    panel_sz = config.ROW_PANEL_SIZE
    bcol = config.BLOCK_COL_SIZE
    n = csr.n
    threshold = int(math.ceil(bsmr.delta * config.BLOCK_SIZE))
    for p in range(bsmr.num_row_panels):
        rows = bsmr.reordered_rows[p * panel_sz:(p + 1) * panel_sz]
        cols = np.concatenate(
            [csr.col_idx[csr.row_ptr[r]:csr.row_ptr[r + 1]] for r in rows]
        ) if len(rows) else np.zeros(0, dtype=np.int64)
        uniq, counts = np.unique(cols, return_counts=True)
        count_of = dict(zip(uniq.tolist(), counts.tolist()))

        dc = bsmr.dense_cols[bsmr.dense_col_offsets[p]:
                             bsmr.dense_col_offsets[p + 1]]
        sc = bsmr.sparse_cols[bsmr.sparse_col_offsets[p]:
                              bsmr.sparse_col_offsets[p + 1]]
        assert len(dc) % bcol == 0, "dense cols not multiple of 16"
        dc_real = dc[dc != n]
        # no duplicates, dense/sparse disjoint
        assert len(np.unique(dc_real)) == len(dc_real), "dup dense col"
        assert len(np.unique(sc)) == len(sc), "dup sparse col"
        assert not set(dc_real.tolist()) & set(sc.tolist()), \
            "dense and sparse column sets overlap"
        # union covers exactly the panel's nonzero columns
        assert set(dc_real.tolist()) | set(sc.tolist()) == set(uniq.tolist()), \
            "dense+sparse != panel nonzero columns"
        # dense order is descending nnz count
        dcnt = np.array([count_of.get(int(c), 0) for c in dc])
        assert np.all(np.diff(dcnt) <= 0), "dense cols not descending by nnz"
        # every dense 16-group meets the density threshold
        if len(dc):
            gsum = dcnt.reshape(-1, bcol).sum(axis=1)
            assert np.all(gsum >= threshold), \
                f"dense group below threshold {threshold}: {gsum}"
        # sparse data count matches offsets
        scnt = sum(count_of.get(int(c), 0) for c in sc)
        assert scnt == (bsmr.sparse_data_offsets[p + 1]
                        - bsmr.sparse_data_offsets[p]), \
            "sparse data offset mismatch"


def _check_grouped_col_reordering(csr: CSR, bsmr: BSMR) -> None:
    """Grouped-split invariants: G-aligned rank-adjacent dense runs, the
    per-group density threshold, dense/sparse disjointness, and coverage
    (dense ∪ sparse ⊇ panel columns — dense groups may carry ride-along
    member columns the panel never touches; they cost nothing extra)."""
    panel_sz = config.ROW_PANEL_SIZE
    G = bsmr.group_size
    n = csr.n
    rank = (bsmr.col_rank if bsmr.col_rank is not None
            else np.arange(n, dtype=np.int64))
    hub = int(getattr(bsmr, "hub_cols", 0))
    threshold = max(int(math.ceil(bsmr.delta * panel_sz * G)), 1)
    for p in range(bsmr.num_row_panels):
        rows = bsmr.reordered_rows[p * panel_sz:(p + 1) * panel_sz]
        cols = np.concatenate(
            [csr.col_idx[csr.row_ptr[r]:csr.row_ptr[r + 1]] for r in rows]
        ) if len(rows) else np.zeros(0, dtype=np.int64)
        if hub:  # hub columns are slab-covered, not split
            cols = cols[rank[cols] >= hub]
        uniq, counts = np.unique(cols, return_counts=True)
        grp_count: dict[int, int] = {}
        for c, cnt in zip(uniq.tolist(), counts.tolist()):
            g = int(rank[c]) // G
            grp_count[g] = grp_count.get(g, 0) + cnt

        dc = bsmr.dense_cols[bsmr.dense_col_offsets[p]:
                             bsmr.dense_col_offsets[p + 1]]
        sc = bsmr.sparse_cols[bsmr.sparse_col_offsets[p]:
                              bsmr.sparse_col_offsets[p + 1]]
        assert len(dc) % G == 0, "dense cols not G-aligned"
        dc_real = dc[dc != n]
        assert len(np.unique(dc_real)) == len(dc_real), "dup dense col"
        assert not set(dc_real.tolist()) & set(sc.tolist()), \
            "dense and sparse column sets overlap"
        assert set(dc_real.tolist()) | set(sc.tolist()) >= \
            set(uniq.tolist()), "dense+sparse misses panel columns"
        runs = dc.reshape(-1, G)
        seen_groups = set()
        for run in runs:
            rr = run[run != n]
            assert len(rr) > 0, "all-sentinel dense group"
            gids = rank[rr] // G
            assert len(np.unique(gids)) == 1, "dense run spans groups"
            g = int(gids[0])
            assert g not in seen_groups, "dup dense group"
            seen_groups.add(g)
            assert grp_count.get(g, 0) >= threshold, \
                f"dense group {g} below threshold {threshold}"


def check_pack(csr: CSR, bsmr: BSMR, packed: PackedMatrix) -> None:
    """Every CSR index appears exactly once across supertiles + group
    tiles + residual, at coordinates consistent with the packed layout."""
    sflat = packed.super_csr.reshape(-1)
    qflat = packed.quad_csr.reshape(-1)
    pflat = packed.pair_csr.reshape(-1)
    gflat = packed.group_csr.reshape(-1)
    hub_csr = (packed.hub_csr if packed.hub_csr is not None
               else np.zeros(0, dtype=np.int64))
    rowslab_csr = (packed.rowslab_csr if packed.rowslab_csr is not None
                   else np.zeros(0, dtype=np.int64))
    all_idx = np.concatenate(
        [sflat[sflat >= 0], qflat[qflat >= 0], pflat[pflat >= 0],
         gflat[gflat >= 0], hub_csr, rowslab_csr, packed.res_csr])
    assert len(all_idx) == csr.nnz, \
        f"packed nnz {len(all_idx)} != {csr.nnz}"
    assert len(np.unique(all_idx)) == len(all_idx), "csr index packed twice"

    # Containers span CONSECUTIVE panels — the invariant the vectorized
    # tile build and the a_layout="panels" kernel path rely on.
    if packed.cont_panel_off is not None:
        off = packed.cont_panel_off
        ids = packed.cont_panel_ids
        for c in range(len(off) - 1):
            mem = ids[off[c]:off[c + 1]]
            assert np.array_equal(mem, np.arange(mem[0], mem[0] + len(mem))), \
                f"container {c} panels not consecutive: {mem}"

    # Coordinate consistency of the dense tile families.
    rows_of = csr.row_indices()
    for csr_arr, rows_arr, cols_arr, fam in (
            (packed.super_csr, packed.super_rows, packed.super_cols, "S"),
            (packed.quad_csr, packed.quad_rows, packed.quad_cols, "Q"),
            (packed.pair_csr, packed.pair_rows, packed.pair_cols, "P"),
            (packed.group_csr, packed.group_rows, packed.group_cols, "G")):
        t_ids, r_loc, c_loc = np.nonzero(csr_arr >= 0)
        csr_ids = csr_arr[t_ids, r_loc, c_loc]
        assert np.array_equal(rows_of[csr_ids], rows_arr[t_ids, r_loc]), \
            f"{fam}-tile row coordinate mismatch"
        assert np.array_equal(csr.col_idx[csr_ids],
                              cols_arr[t_ids, c_loc]), \
            f"{fam}-tile col coordinate mismatch"

    # Residual consistency.
    assert np.array_equal(rows_of[packed.res_csr], packed.res_rows), \
        "residual row mismatch"
    assert np.array_equal(csr.col_idx[packed.res_csr], packed.res_cols), \
        "residual col mismatch"

    # Hub-slab consistency: every hub entry's column has rank < H and
    # its slab slot is row * H + rank.
    if packed.hub_cols:
        H = packed.hub_cols
        rank = bsmr.col_rank
        assert rank is not None, "hub slab without col_rank"
        assert np.array_equal(rows_of[packed.hub_csr], packed.hub_rows), \
            "hub row mismatch"
        assert np.array_equal(rank[csr.col_idx[packed.hub_csr]],
                              packed.hub_rank), "hub rank mismatch"
        assert np.all(packed.hub_rank < H), "hub rank >= hub_cols"
        # every entry whose column ranks < H is a hub entry — except
        # entries of pre-selected hot-slab rows, which the full-width
        # hot-row slab owns wholesale (panel-less rows cannot use the
        # per-panel hub machinery of the distributed runner)
        hub_all = rank[csr.col_idx] < H
        expected = {int(np.count_nonzero(hub_all))}
        if packed.rowslab_rows is not None:
            # pre-tiling mode: hot-slab rows' hub-column entries belong
            # to the slab; post-selection mode keeps them in the hub
            hot_m = np.zeros(csr.m, dtype=bool)
            hot_m[packed.rowslab_rows[packed.rowslab_rows < csr.m]] = True
            expected.add(int(np.count_nonzero(hub_all & ~hot_m[rows_of])))
        assert len(packed.hub_csr) in expected, "hub entry set incomplete"

    # Hot-row slab consistency: every slab entry's row is in the hot
    # set, its lane is its column rank minus the hub width, and the
    # hot rows really are residual rows (their entries left the
    # residual).
    if packed.rowslab_rows is not None and len(rowslab_csr):
        S = packed.rowslab_width
        rank = (bsmr.col_rank if bsmr.col_rank is not None
                else np.arange(csr.n, dtype=np.int64))
        assert np.array_equal(rows_of[packed.rowslab_csr],
                              packed.rowslab_erows), "rowslab row mismatch"
        assert np.array_equal(
            rank[csr.col_idx[packed.rowslab_csr]],
            packed.rowslab_rank), "rowslab rank mismatch"
        assert np.all((packed.rowslab_rank >= 0)
                      & (packed.rowslab_rank < S)), "rowslab lane range"
        hot_set = set(packed.rowslab_rows[packed.rowslab_rows
                                          < csr.m].tolist())
        assert set(packed.rowslab_erows.tolist()) <= hot_set, \
            "rowslab entry in a non-hot row"
        assert not (set(packed.res_rows.tolist()) & hot_set), \
            "hot row still has residual entries"

    # Packed metadata consistency: real slots carry (row, col); padding
    # slots carry sentinels; csr_dest inverts inv_idx.
    assert np.array_equal(packed.packed_rows[packed.inv_idx], rows_of)
    assert np.array_equal(packed.packed_cols[packed.inv_idx], csr.col_idx)
    assert np.array_equal(packed.csr_dest[packed.inv_idx],
                          np.arange(csr.nnz))
    mask = np.ones(packed.packed_size, dtype=bool)
    mask[packed.inv_idx] = False
    assert np.all(packed.packed_rows[mask] == csr.m)
    assert np.all(packed.packed_cols[mask] == csr.n)

    # inv_idx round-trip: scattering arange through the packed layout and
    # gathering back must be the identity.
    probe = np.arange(csr.nnz)
    flat_vals = np.zeros(packed.packed_size)
    flat_vals[packed.inv_idx] = probe
    assert np.array_equal(flat_vals[packed.inv_idx], probe)
