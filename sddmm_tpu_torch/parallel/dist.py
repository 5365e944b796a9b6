"""The hybrid SDDMM sharded over a ('rows', 'feat') mesh of ranks.

Counterpart of ``sddmm_tpu/parallel/dist.py`` (``_ShardPlan``,
``DistributedHybridSDDMM``, ``DistributedDenseSDDMM``), over
``torch.distributed``: one instance per rank (``launch.spawn`` starts the
ranks, ``mesh.make_mesh`` gives each its coordinates and groups).  It
shards the same bucketed run-major packing the single-device runner
executes (reorder/pack.py):

- **'rows'**: containers (packed tile runs) are partitioned into
  contiguous panel-range units, contiguous units per rank, balanced by
  packed-cell weight (``_ShardPlan``, a numpy copy of JAX's, field for
  field).  Each rank holds only its panels' rows of A (a panel-local copy)
  and its own residual entries.
- **'feat'**: A and the grouped B^T layout are split into K chunks; a rank
  holds its feat coordinate's chunks (the parameters' K slice), computes
  partial dot products, and one ``all_reduce`` of the packed output over
  'feat' sums them: the only collective of the step.
- The output stays sharded, (flat_local,) a rank in packed order; CSR
  entry order is an explicit opt-in (``order="csr"``: a gather over 'rows'
  and a scatter by ``csr_dest``).

A rank's step is the single-device runner on the rank's share
(``_rank_packing``, the plan's arrays in ``PackedMatrix``'s names): one
tile-kernel launch over a work table of the rank's families, hub slab and
hot-row slab, one gather-dot launch for its residual, then the
all-reduce.  Its A is the rank's panel rows, then its hot rows, then the
zero row (``_a_order``); the plan's sentinel slot ``rows_max`` is mapped to
that zero row.

Gradients: the runner's autograd op (B1) on each rank, the 'feat'
all-reduce's backward is the identity (every feat rank holds the same
reduced output and loss), and the parameters' gradients are summed over
'rows' by one all-reduce each (``_SumOverRows``), where JAX's shard_map
transpose does that implicitly.  Every collective a runner issues is
appended to its ``collectives`` log (kind, group, numel, bytes): torch has
no compiled HLO to audit.
"""

from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
from sddmm_tpu_torch.reorder.pack import GROUP_LANES, PackedMatrix

_FAMS = (  # (name, rows per tile)
    ("super", 128), ("quad", 64), ("pair", 32), ("group", 16))


class _ShardPlan:
    """Host-side partition of a PackedMatrix over R row-devices."""

    def __init__(self, packed: PackedMatrix, n_rows_devices: int):
        R = int(n_rows_devices)
        m = packed.m
        num_panels = packed.num_panels
        nC = len(packed.cont_panel_off) - 1

        # Partition units over the panel axis: one unit per container
        # (its full consecutive panel span — containers may cross old
        # 8-panel window boundaries under the DP carve) and one unit per
        # maximal run of container-less panels.  Unit boundaries
        # therefore never split a container.
        cont_of_panel = np.full(max(num_panels, 1), -1, dtype=np.int64)
        if nC:
            cont_of_panel[packed.cont_panel_ids.astype(np.int64)] = \
                np.repeat(np.arange(nC, dtype=np.int64),
                          np.diff(packed.cont_panel_off).astype(np.int64))
        starts = np.ones(max(num_panels, 1), dtype=bool)
        if num_panels > 1:
            starts[1:num_panels] = ~(
                (cont_of_panel[1:num_panels]
                 == cont_of_panel[:num_panels - 1])
                | ((cont_of_panel[1:num_panels] < 0)
                   & (cont_of_panel[:num_panels - 1] < 0)))
        unit_of_panel = np.cumsum(starts) - 1
        num_units = int(unit_of_panel[num_panels - 1]) + 1 \
            if num_panels else 1
        unit_of_cont = np.zeros(max(nC, 1), dtype=np.int64)
        if nC:
            unit_of_cont[:nC] = unit_of_panel[
                packed.cont_panel_ids[packed.cont_panel_off[:-1]]
                .astype(np.int64)]

        # panel of each original row (sentinel row m -> -1)
        panel_of_row = np.full(m + 1, -1, dtype=np.int64)
        ar = packed.a_row_gather.astype(np.int64)
        real = ar < m
        panel_of_row[ar[real]] = np.nonzero(real)[0] // 16

        # per-run records: (fam_idx, b, tile_start, cont_id)
        runs = {f: [] for f, _ in _FAMS}
        for fi, (fname, rows_h) in enumerate(_FAMS):
            buckets = getattr(packed, f"{fname}_buckets")
            run_cont = getattr(packed, f"{fname}_run_cont")
            ri = 0
            for (b, start, n) in buckets:
                for j in range(n):
                    runs[fname].append((b, start + j * b,
                                        int(run_cont[ri])))
                    ri += 1

        # unit weights: packed cells of each run + residual entries
        w = np.zeros(num_units, dtype=np.float64)
        for fname, rows_h in _FAMS:
            for (b, t0, cid) in runs[fname]:
                w[unit_of_cont[cid]] += rows_h * b * GROUP_LANES
        res_panel = panel_of_row[packed.res_rows.astype(np.int64)]
        res_unit = np.where(res_panel >= 0,
                            unit_of_panel[np.maximum(res_panel, 0)], 0)
        np.add.at(w, res_unit, 64.0)  # nominal residual weight

        # contiguous unit partition into R parts: sequential greedy cut —
        # each device takes units until its load reaches the average of
        # what remains, choosing the nearer boundary (floor cuts alone
        # pile the rounding remainder onto the last device when units
        # are coarse, e.g. DP supertile containers)
        cum = np.cumsum(w)
        total = cum[-1] if len(cum) else 0.0
        bounds = [0]
        for d in range(1, R):
            prev = bounds[-1]
            left = total - (cum[prev - 1] if prev else 0.0)
            target = (cum[prev - 1] if prev else 0.0) \
                + left / (R - d + 1)
            b = int(np.searchsorted(cum, target))
            if b > prev and abs(cum[b - 1] - target) <= \
                    abs((cum[b] if b < len(cum) else total) - target):
                b -= 1
            bounds.append(min(b + 1, num_units))
        bounds.append(num_units)
        # enforce monotone non-decreasing
        for i in range(1, len(bounds)):
            bounds[i] = max(bounds[i], bounds[i - 1])
        self.window_bounds = bounds
        self.unit_weight = w  # (units,) packed cells + nominal residual
        dev_of_unit = np.zeros(num_units, dtype=np.int64)
        for d in range(R):
            dev_of_unit[bounds[d]:bounds[d + 1]] = d

        # panels / local A rows per device
        self.R = R
        panel_dev = dev_of_unit[unit_of_panel[:num_panels]] \
            if num_panels else np.zeros(0, dtype=np.int64)
        counts = np.bincount(panel_dev, minlength=R) if num_panels \
            else np.zeros(R, dtype=np.int64)
        self.rows_max = int(counts.max()) * 16 if num_panels else 16
        a_rows_local = np.full((R, self.rows_max), m, dtype=np.int32)
        # local slot of each original row (sentinel -> rows_max)
        local_of_row = np.full(m + 1, self.rows_max, dtype=np.int32)
        p0 = np.zeros(R, dtype=np.int64)
        for p in range(num_panels):
            d = panel_dev[p]
            s = p0[d]
            rows = ar[p * 16:(p + 1) * 16]
            a_rows_local[d, s:s + len(rows)] = rows
            rr = rows[rows < m]
            local_of_row[rr] = s + np.nonzero(rows < m)[0]
            p0[d] += 16
        self.a_rows_local = a_rows_local  # (R, rows_max) original ids
        self.panel_dev = panel_dev

        # per-family local tile arrays, uniform bucket structure
        NG = packed.num_col_groups
        G = packed.group_size
        LG = GROUP_LANES // G

        # Pass 1: bucket structure + per-device run lists per family, so
        # the flat destination map can be allocated ONCE (int32) instead
        # of concatenating per-segment int64 parts — the concat was the
        # dominant plan-build cost at suite scale (hundreds of MB of
        # first-touch allocations).
        self.local_buckets = {}
        fam_plan = {}
        flat_cells = 0
        for fname, rows_h in _FAMS:
            fruns = runs[fname]
            bsizes = []
            for (b, t0, cid) in fruns:
                if not bsizes or bsizes[-1] != b:
                    bsizes.append(b)
            # bucket sizes are sorted ascending and unique by construction
            dev_runs = {b: [[] for _ in range(R)] for b in bsizes}
            for (b, t0, cid) in fruns:
                dev_runs[b][dev_of_unit[unit_of_cont[cid]]].append(
                    (t0, cid))
            lb = []
            start_local = 0
            for b in bsizes:
                n_max = max(len(x) for x in dev_runs[b])
                if n_max == 0:
                    continue
                lb.append((b, start_local, n_max))
                flat_cells += n_max * rows_h * b * GROUP_LANES
                start_local += n_max * b
            self.local_buckets[fname] = tuple(lb)
            fam_plan[fname] = (dev_runs, start_local)

        H = packed.hub_cols
        # Hot-row slab partition: the (sentinel-padded) hot-row list is
        # split contiguously into R even parts — slab compute per row is
        # uniform (S cold columns each), so row count IS the balance
        # weight.  Each device's hot rows are APPENDED to its local A
        # copy after the sentinel block (prepare_operands), so the local
        # kernel reads them with one static slice, zero descriptors.
        self.rowslab_pad = 0
        self.rowslab_width = packed.rowslab_width
        self.rowslab_rows_local = None
        hot_dev = hot_loc = None
        if packed.rowslab_rows is not None:
            hot = packed.rowslab_rows[packed.rowslab_rows < m] \
                .astype(np.int64)
            rs_max = max(-(-len(hot) // R), 1)
            self.rowslab_pad = -(-rs_max // 16) * 16
            tbl = np.full((R, self.rowslab_pad), m, dtype=np.int64)
            hot_dev = np.full(m + 1, -1, dtype=np.int64)
            hot_loc = np.zeros(m + 1, dtype=np.int64)
            for d, part in enumerate(np.array_split(hot, R)):
                tbl[d, :len(part)] = part
                hot_dev[part] = d
                hot_loc[part] = np.arange(len(part), dtype=np.int64)
            self.rowslab_rows_local = tbl
        res_dev = np.where(res_panel >= 0, dev_of_unit[res_unit], 0)
        counts_r = np.bincount(res_dev, minlength=R)
        nR_max = max(int(counts_r.max()) if len(res_dev) else 0, 1)
        self.flat_local = (flat_cells + (self.rows_max * H if H else 0)
                           + self.rowslab_pad * self.rowslab_width
                           + nR_max)
        csr_dest = np.full((R, self.flat_local), packed.nnz,
                           dtype=np.int32)

        # Pass 2: fill tile arrays and the destination map in place.
        self.tile_rows = {}
        self.tile_gids = {}
        seg_off = 0
        for fname, rows_h in _FAMS:
            rows_arr = getattr(packed, f"{fname}_rows").astype(np.int64)
            gids_arr = getattr(packed, f"{fname}_gids").astype(np.int64)
            csr_arr = getattr(packed, f"{fname}_csr")
            dev_runs, tiles_local = fam_plan[fname]
            t_rows = np.full((R, tiles_local, rows_h), self.rows_max,
                             dtype=np.int32)
            t_gids = np.full((R, tiles_local, LG), NG, dtype=np.int32)
            for (b, start_local, n_max) in self.local_buckets[fname]:
                run_cells = rows_h * b * GROUP_LANES
                seg_dest = csr_dest[:, seg_off:seg_off
                                    + n_max * run_cells]
                # flatten (device, run) pairs and assign all runs at once
                d_arr = np.repeat(
                    np.arange(R, dtype=np.int64),
                    [len(dev_runs[b][d]) for d in range(R)])
                t0_arr = np.concatenate(
                    [np.asarray([t0 for (t0, _) in dev_runs[b][d]],
                                dtype=np.int64)
                     for d in range(R)]) if len(d_arr) else \
                    np.zeros(0, dtype=np.int64)
                j_arr = np.concatenate(
                    [np.arange(len(dev_runs[b][d]), dtype=np.int64)
                     for d in range(R)]) if len(d_arr) else \
                    np.zeros(0, dtype=np.int64)
                if len(d_arr):
                    nrb = len(d_arr)
                    tile_src = (t0_arr[:, None]
                                + np.arange(b, dtype=np.int64)).reshape(-1)
                    d_rep = np.repeat(d_arr, b)
                    slot = (start_local + j_arr[:, None] * b
                            + np.arange(b, dtype=np.int64)).reshape(-1)
                    # all b tiles of a run share the same rows; the
                    # run's first row sits at its first local panel's
                    # 16-row boundary (panel-blocked local A layout)
                    rloc = local_of_row[rows_arr[t0_arr]]  # (nrb, rows_h)
                    t_rows[d_rep, slot] = np.repeat(rloc, b, axis=0)
                    t_gids[d_rep, slot] = gids_arr[tile_src]
                    # run-major cells: (rows_h, b, 128) per run
                    cells = csr_arr[tile_src].reshape(
                        nrb, b, rows_h, GROUP_LANES).transpose(0, 2, 1, 3)
                    cells = np.where(cells >= 0, cells,
                                     packed.nnz).astype(np.int32)
                    seg_dest[d_arr[:, None],
                             j_arr[:, None] * run_cells
                             + np.arange(run_cells, dtype=np.int64)] = \
                        cells.reshape(nrb, run_cells)
                seg_off += n_max * run_cells
            self.tile_rows[fname] = t_rows
            self.tile_gids[fname] = t_gids

        # Per-run first LOCAL panel per family (a_layout="panels"):
        # containers occupy consecutive local panels (unit = whole
        # container on one device, and panel_dev is monotone so local
        # slots follow global panel order); padded runs carry the
        # sentinel panel rows_max/16.
        starts_d = np.searchsorted(panel_dev, np.arange(R)) \
            if num_panels else np.zeros(R, dtype=np.int64)
        local_panel = (np.arange(num_panels, dtype=np.int64)
                       - starts_d[panel_dev]) if num_panels else \
            np.zeros(0, dtype=np.int64)
        cfirst = (packed.cont_panel_ids[packed.cont_panel_off[:-1]]
                  .astype(np.int64) if nC else np.zeros(0, np.int64))
        sent_panel = self.rows_max // 16
        self.run_pst = {}
        for fname, rows_h in _FAMS:
            runs_local = sum(n_max for (_, _, n_max)
                             in self.local_buckets[fname])
            pst = np.full((R, runs_local), sent_panel, dtype=np.int32)
            roff = 0
            dev_runs, _ = fam_plan[fname]
            for (b, start_local, n_max) in self.local_buckets[fname]:
                for d in range(R):
                    cids = np.asarray(
                        [cid for (_, cid) in dev_runs[b][d]],
                        dtype=np.int64)
                    if len(cids):
                        pst[d, roff:roff + len(cids)] = \
                            local_panel[cfirst[cids]]
                roff += n_max
            self.run_pst[fname] = pst

        # Dense hub slab: per-device (rows_max, H) block computed from the
        # device's panel-local A rows (kernel order: families ++ slab ++
        # residual).
        if H:
            slab_dest = csr_dest[:, seg_off:seg_off + self.rows_max * H]
            hr = packed.hub_rows.astype(np.int64)
            if len(hr) and not (panel_of_row[hr] >= 0).all():
                raise ValueError(
                    "hub entry in a panel-less row — only pre-tiling "
                    "hot-slab rows may be panel-less, and the pack "
                    "routes their hub columns to the full-width slab")
            hd = dev_of_unit[unit_of_panel[
                np.maximum(panel_of_row[hr], 0)]]
            hs = local_of_row[hr]
            slab_dest[hd, hs * H + packed.hub_rank.astype(np.int64)] = \
                packed.hub_csr.astype(np.int64)
            seg_off += self.rows_max * H

        # Hot-row slab entries: slot = local_hot_index * S + rank, rank
        # being the entry's lane in the full-width slab (rowslab_rank).
        if self.rowslab_pad and packed.rowslab_csr is not None \
                and len(packed.rowslab_csr):
            S = self.rowslab_width
            rs_dest = csr_dest[:, seg_off:seg_off
                               + self.rowslab_pad * S]
            er = packed.rowslab_erows.astype(np.int64)
            rs_dest[hot_dev[er],
                    hot_loc[er] * S
                    + packed.rowslab_rank.astype(np.int64)] = \
                packed.rowslab_csr.astype(np.int64)
        seg_off += self.rowslab_pad * self.rowslab_width

        # residual per device (local row ids) — vectorized: stable-sort by
        # device, then each entry's slot is its rank within its device.
        self.res_rows = np.full((R, nR_max), self.rows_max, dtype=np.int32)
        self.res_gids = np.full((R, nR_max), NG, dtype=np.int32)
        self.res_member = np.zeros((R, nR_max), dtype=np.int64)
        res_dest = csr_dest[:, seg_off:seg_off + nR_max]
        rr = packed.res_rows.astype(np.int64)
        rg = packed.res_gids.astype(np.int64)
        rm = packed.res_member.astype(np.int64)
        rc = packed.res_csr.astype(np.int64)
        if len(rr):
            order_r = np.argsort(res_dev, kind="stable")
            d_s = res_dev[order_r]
            starts = np.zeros(R, dtype=np.int64)
            np.cumsum(counts_r[:-1], out=starts[1:])
            j_s = np.arange(len(rr), dtype=np.int64) - starts[d_s]
            self.res_rows[d_s, j_s] = local_of_row[rr[order_r]]
            self.res_gids[d_s, j_s] = rg[order_r]
            self.res_member[d_s, j_s] = rm[order_r]
            res_dest[d_s, j_s] = rc[order_r]

        # per-device flat layout: [family segments ++ slab ++ residual]
        self.csr_dest = csr_dest


def _rank_packing(plan: "_ShardPlan", packed: PackedMatrix, rank: int):
    """One rank's share of a ``_ShardPlan`` under the names ``HybridSDDMM``
    reads from a ``PackedMatrix``.  Its A rows: the rank's ``rows_max``
    panel rows, then its ``rowslab_pad`` hot rows, then the zero row ``m``
    (the plan's sentinel slot ``rows_max`` maps there); the hub slab covers
    the panel rows only (``hub_nrows``); under ``a_layout="panels"`` run i's
    panels start at the plan's ``run_pst`` (one container a run here)."""
    rm, rs = plan.rows_max, plan.rowslab_pad
    m_loc = rm + rs

    def sentinel(x):
        x = np.asarray(x, dtype=np.int64)
        return np.where(x == rm, m_loc, x)

    fields, pst, runs = {}, [], 0
    for fam, _ in _FAMS:
        n_runs = plan.run_pst[fam].shape[1]
        fields[f"{fam}_rows"] = sentinel(plan.tile_rows[fam][rank])
        fields[f"{fam}_gids"] = np.asarray(plan.tile_gids[fam][rank],
                                           dtype=np.int64)
        fields[f"{fam}_buckets"] = plan.local_buckets[fam]
        fields[f"{fam}_run_cont"] = np.arange(runs, runs + n_runs)
        pst.append(plan.run_pst[fam][rank].astype(np.int64))
        runs += n_runs
    return types.SimpleNamespace(
        m=m_loc, n=packed.n, group_size=packed.group_size,
        num_col_groups=packed.num_col_groups, col_order=packed.col_order,
        hub_cols=packed.hub_cols, hub_nrows=rm,
        rowslab_rows=np.arange(rm, m_loc) if rs else None,
        rowslab_width=plan.rowslab_width, rowslab_nrows=rs,
        res_rows=sentinel(plan.res_rows[rank]),
        res_gids=np.asarray(plan.res_gids[rank], dtype=np.int64),
        res_member=np.asarray(plan.res_member[rank], dtype=np.int64),
        packed_size=plan.flat_local, a_row_gather=np.arange(rm),
        cont_panel_ids=np.concatenate(pst), cont_panel_off=np.arange(runs + 1),
        inv_idx=None, packed_rows=None, packed_cols=None, **fields)


def _log(runner, kind: str, group: str, t: torch.Tensor) -> None:
    runner.collectives.append(dict(kind=kind, group=group, numel=t.numel(),
                                   bytes=t.numel() * t.element_size()))


def _all_reduce(runner, t: torch.Tensor, group: str) -> torch.Tensor:
    _log(runner, "all_reduce", group, t)
    dist.all_reduce(t, group=runner.mesh.groups[group])
    return t


def _all_gather(runner, t: torch.Tensor, group: str) -> torch.Tensor:
    """(axis size, *t.shape): gloo gathers CUDA tensors through the host."""
    _log(runner, "all_gather", group, t)
    pg = runner.mesh.groups[group]
    src = t.cpu() if (runner.mesh.backend == "gloo"
                      and t.device.type == "cuda") else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, src, group=pg)
    return torch.stack(parts).to(t.device)


class _SumOverRows(torch.autograd.Function):
    """Identity; its backward sums the gradient over 'rows' (one
    all-reduce): the transpose of handing every rows rank the same
    parameter."""

    @staticmethod
    def forward(ctx, runner, x):
        ctx.runner = runner
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(ctx.runner, g.contiguous().clone(), "rows")


class _SumOverFeat(torch.autograd.Function):
    """The sum of the feat ranks' partial outputs (one all-reduce); its
    backward is the identity, since every feat rank holds the sum."""

    @staticmethod
    def forward(ctx, runner, x):
        return _all_reduce(runner, x.contiguous().clone(), "feat")

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherRowsToCsr(torch.autograd.Function):
    """The rows ranks' packed outputs (flat_local,) gathered over 'rows'
    and scattered into CSR order by ``dest`` (R, flat_local) (``nnz`` marks
    a slot that holds no entry); its backward takes this rank's slots of
    the cotangent, which every rank holds whole."""

    @staticmethod
    def forward(ctx, runner, x, dest, nnz, rank):
        ctx.save_for_backward(dest[rank])
        parts = _all_gather(runner, x, "rows")
        out = x.new_zeros(x.shape[:-1] + (nnz + 1,))
        out.index_copy_(out.dim() - 1, dest.reshape(-1),
                        parts.movedim(0, -2).reshape(x.shape[:-1] + (-1,)))
        return out[..., :nnz]

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(g.shape[:-1] + (1,))], dim=-1)
        return None, g[..., dest], None, None, None


def _rank_device(mesh, device) -> torch.device:
    """The rank's device: ``device`` checked (the card unless "cpu"), and
    then the mesh's, which must be of its type."""
    dev = check_device(device)
    if mesh.device.type != dev.type:
        raise ValueError(f"device {dev} but the mesh's rank runs on "
                         f"{mesh.device}")
    return mesh.device


class DistributedHybridSDDMM:
    """The hybrid SDDMM sharded over a ('rows', 'feat') mesh: this rank's
    share, with the JAX runner's parameters and defaults.

    Operands: this rank's K slice of the padded parameters, A (M+1, K/F)
    and B^T (N+1, K/F) (``device_prepare``; ``prepare_operands`` slices
    numpy (M, K) and B (K, N) itself).  Output layouts: ``"packed"``
    (default), this rank's (flat_local,) values, identical on the feat
    ranks of a row block; ``"csr"``, the values in CSR entry order of the
    input matrix, gathered over 'rows' (every rank holds them)."""

    def __init__(self, packed: PackedMatrix, mesh,
                 compute_dtype: str = "float32", k_chunks: int = 0,
                 default_order: str = "packed", a_layout: str = "rows",
                 device="cuda"):
        check_device(device)
        if a_layout not in ("rows", "panels"):
            raise ValueError(f"unknown a_layout {a_layout!r}")
        if default_order not in ("packed", "csr"):
            raise ValueError(f"unknown order {default_order!r}")
        self.packed = packed
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.default_order = default_order
        self.a_layout = a_layout
        self.device = _rank_device(mesh, device)
        R = mesh.shape["rows"]
        self.F = mesh.shape.get("feat", 1)
        self.k_chunks = int(k_chunks) if k_chunks else self.F
        if self.k_chunks % self.F:
            raise ValueError(
                f"k_chunks={self.k_chunks} must be a multiple of the "
                f"'feat' axis size {self.F}")
        self.row_rank = mesh.coords["rows"]
        self.feat_rank = mesh.coords.get("feat", 0)
        self.plan = plan = _ShardPlan(packed, R)
        #: this rank's runner: the single-device runner on its share
        self.local = HybridSDDMM(
            _rank_packing(plan, packed, self.row_rank),
            compute_dtype=compute_dtype, k_chunks=self.k_chunks // self.F,
            a_layout=a_layout, device=self.device)
        m = packed.m
        parts = [np.where(plan.a_rows_local[self.row_rank] < m,
                          plan.a_rows_local[self.row_rank], m)]
        if plan.rowslab_pad:
            parts.append(plan.rowslab_rows_local[self.row_rank])
        parts.append([m])
        #: global A row of each local A row (m: the padded A's zero row)
        self._a_order = torch.as_tensor(
            np.concatenate(parts).astype(np.int64), device=self.device)
        self._csr_dest = torch.as_tensor(plan.csr_dest.astype(np.int64),
                                         device=self.device)
        #: every collective this runner issued: dicts of kind, group,
        #: numel and bytes, in order
        self.collectives = []

    def feat_slice(self, x):
        """This rank's K slice ``x[..., f*K/F:(f+1)*K/F]``."""
        k = x.shape[-1]
        if k % self.k_chunks:
            raise ValueError(f"K={k} not divisible by C={self.k_chunks}")
        kf = k // self.F
        return x[..., self.feat_rank * kf:(self.feat_rank + 1) * kf]

    def prepare_operands(self, a, b=None, bt=None):
        """numpy A (M, K) and B (K, N) (or B^T (N, K) as ``bt``), whole on
        every rank -> this rank's operands (``device_prepare`` of its K
        slice, zero-padded)."""
        a = np.asarray(a, dtype=np.float32)
        bt = (np.asarray(b, dtype=np.float32).T if bt is None
              else np.asarray(bt, dtype=np.float32))

        def pad(x):
            x = torch.as_tensor(np.ascontiguousarray(self.feat_slice(x)),
                                device=self.device)
            return torch.cat([x, x.new_zeros((1, x.shape[1]))])

        return self.device_prepare(pad(a), pad(bt))

    def device_prepare(self, a_pad: torch.Tensor, bt_pad: torch.Tensor):
        """This rank's K slice of the padded A (M+1, K/F) and B^T (N+1,
        K/F), on its device -> its runner's operands: the panel-local A
        (its rows by ``_a_order``) and the grouped, chunked B^T of its
        chunks.  Differentiable: the parameters' gradients are summed over
        'rows' (one all-reduce each in the backward)."""
        if torch.is_grad_enabled() and a_pad.requires_grad:
            a_pad = _SumOverRows.apply(self, a_pad)
        if torch.is_grad_enabled() and bt_pad.requires_grad:
            bt_pad = _SumOverRows.apply(self, bt_pad)
        return self.local.device_prepare(
            a_pad.index_select(0, self._a_order), bt_pad)

    def make_packed_targets(self, csr_values):
        """(targets, mask) in this rank's packed layout (flat_local,): the
        training-loss pattern that keeps everything sharded."""
        dest = self.plan.csr_dest[self.row_rank]
        valid = dest < self.packed.nnz
        vals = np.asarray(csr_values, dtype=np.float32)
        tgt = np.where(valid, vals[np.minimum(dest, len(vals) - 1)], 0.0)
        return (torch.as_tensor(tgt.astype(np.float32), device=self.device),
                torch.as_tensor(valid, device=self.device))

    def run_local(self, a_ops, bt_phys: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
        """This rank's partial packed output (flat_local,), before the
        'feat' sum: one tile launch and one gather-dot launch, or with
        ``plain`` their plain versions (``HybridSDDMM.run_padded``)."""
        return self.local.run_padded(a_ops, bt_phys, order="packed",
                                     plain=plain)

    def run_padded(self, a_ops, bt_phys: torch.Tensor,
                   order: Optional[str] = None) -> torch.Tensor:
        """The sharded step: this rank's kernels, then one all-reduce of
        its (flat_local,) output over 'feat'.  ``order="csr"`` then gathers
        over 'rows' into CSR order."""
        order = order or self.default_order
        if order not in ("packed", "csr"):
            raise ValueError(f"unknown order {order!r}")
        flat = _SumOverFeat.apply(self, self.run_local(a_ops, bt_phys))
        return self.to_csr_order(flat) if order == "csr" else flat

    def to_csr_order(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's reduced (flat_local,) -> the (nnz,) CSR-order values
        (explicit opt-in: gathers the flat vectors over 'rows')."""
        return _GatherRowsToCsr.apply(self, flat, self._csr_dest,
                                      self.packed.nnz, self.row_rank)

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        """Host convenience: numpy operands in, CSR-order values out."""
        return self.run_padded(*self.prepare_operands(a, b=b, bt=bt),
                               order=order)

    def tile_balance(self) -> np.ndarray:
        """Real (non-padding) packed slots per rows rank: the balance the
        partition optimises."""
        return np.sum(self.plan.csr_dest < self.packed.nnz, axis=1)


class DistributedDenseSDDMM:
    """The dense class (``ops.dense.DenseSDDMM``, the tile kernel's dense
    entries) sharded over the same mesh: rank (r, f) takes row block r of
    A (rows padded to a multiple of R) and K slice f, runs the dense class
    on them, and one all-reduce over 'feat' sums the (M/R, N) partial
    products.  CSR order gathers the blocks over 'rows'."""

    def __init__(self, m: int, n: int, mesh, compute_dtype: str = "float32",
                 csr=None, device="cuda"):
        from sddmm_tpu_torch.ops.dense import DenseSDDMM

        check_device(device)
        self.m, self.n = int(m), int(n)
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self._csr = csr
        self.device = _rank_device(mesh, device)
        self.R = mesh.shape["rows"]
        self.F = mesh.shape.get("feat", 1)
        self.m_pad = -(-self.m // self.R) * self.R
        self.rows_local = self.m_pad // self.R
        self.row_rank = mesh.coords["rows"]
        self.feat_rank = mesh.coords.get("feat", 0)
        #: this rank's runner over its (M/R, N) block
        self.local = DenseSDDMM(self.rows_local, self.n, compute_dtype,
                                device=self.device)
        self.collectives = []
        self._dest = None

    @staticmethod
    def from_csr(csr, mesh, compute_dtype: str = "float32",
                 device="cuda") -> "DistributedDenseSDDMM":
        return DistributedDenseSDDMM(csr.m, csr.n, mesh,
                                     compute_dtype=compute_dtype, csr=csr,
                                     device=device)

    def prepare_operands(self, a, b=None, bt=None):
        """numpy A (M, K) and B (K, N) (or B^T as ``bt``) -> this rank's
        row block and K slice of A and K slice of B^T on its device; K
        must divide by the 'feat' axis size."""
        a = np.asarray(a, dtype=np.float32)
        bt = (np.asarray(b, dtype=np.float32).T if bt is None
              else np.asarray(bt, dtype=np.float32))
        k = a.shape[1]
        if k % self.F:
            raise ValueError(f"K={k} not divisible by 'feat' axis "
                             f"size {self.F}")
        kf = k // self.F
        ks = slice(self.feat_rank * kf, (self.feat_rank + 1) * kf)
        if self.m_pad > self.m:
            a = np.concatenate(
                [a, np.zeros((self.m_pad - self.m, k), a.dtype)])
        r0 = self.row_rank * self.rows_local
        return self.local.prepare_operands(
            a[r0:r0 + self.rows_local, ks], bt=bt[:, ks])

    def run_padded(self, a_dev, bt_dev,
                   order: str = "packed") -> torch.Tensor:
        """This rank's (M/R, N) block of the product (one tile launch and
        one all-reduce over 'feat'), or the (nnz,) CSR-order values."""
        if order not in ("packed", "csr"):
            raise ValueError(f"unknown order {order!r}")
        full = _SumOverFeat.apply(self, self.local.run_padded(
            a_dev, bt_dev, order="packed"))
        return self.to_csr_order(full) if order == "csr" else full

    def to_csr_order(self, full: torch.Tensor) -> torch.Tensor:
        if self._csr is None:
            raise ValueError("order='csr' needs the CSR pattern; build "
                             "with DistributedDenseSDDMM.from_csr")
        if self._dest is None:
            # rank r's slot i*N + j holds entry (r*M/R + i, j)
            csr = self._csr
            slot = (csr.row_indices().astype(np.int64) * self.n
                    + csr.col_idx.astype(np.int64))
            per = self.rows_local * self.n
            dest = np.full(self.R * per, csr.nnz, dtype=np.int64)
            dest[slot] = np.arange(csr.nnz)
            self._dest = torch.as_tensor(dest.reshape(self.R, per),
                                         device=self.device)
        return _GatherRowsToCsr.apply(self, full.reshape(-1), self._dest,
                                      self._csr.nnz, self.row_rank)

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        return self.run_padded(*self.prepare_operands(a, b=b, bt=bt),
                               order=order)
