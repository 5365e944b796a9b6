"""Explicit-configuration packing: ``from_params`` and the layout cost model.

Counterpart of ``sddmm_tpu/reorder/autotune.py``, cut to what the main path
runs: ``TunedConfig``, ``estimate_ms`` with its constants, ``_ELEM_BYTES``
and ``from_params`` (the deterministic path ``bench.py`` takes with the
committed per-matrix configs).  ``autotune``, ``autotune_multi`` and the
measured shoot-out are not ported yet.

The constants are the JAX package's layout-model constants, copied
unchanged so that ``pack`` (which reads ``_DOT_G16_MS``) builds the identical
``PackedMatrix``.  They were measured on a TPU, choose the layout only, and
say nothing about the speed of this port's card; re-tuning them for the
H100 is ROADMAP Queue 1: 'Autotune on the H100'.  The calibration and
gather-grid loaders of the JAX module are not copied: the constants here
stay fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import (GROUP_CELLS, GROUP_LANES,
                                          SUPER_CELLS, PackedMatrix, pack)

# -- layout-model constants (the JAX package's, unchanged) --
STREAM_GBPS = 856.0
TAKE_PAYLOAD_CAP_GBPS = 500.0
_ROW_RATE_8MB = {64: 380.0, 128: 374.0, 256: 575.0, 512: 327.0,
                 1024: 60.0, 2048: 50.0, 4096: 31.0}
_SRC_MB = np.array([0.0, 2.0, 4.0, 8.0, 12.0, 16.0, 32.0, 1e9])
_SRC_F = np.array([4.0, 4.0, 1.1, 1.0, 0.9, 0.45, 0.40, 0.40])
_REPEAT_COST = 0.35
# batched tile-dot rates (16-row groups/s) by (precision, tile height)
_DOT_G16_MS = {
    ("float32", 16): 11.0e6, ("float32", 32): 33.0e6,
    ("float32", 64): 49.0e6, ("float32", 128): 27.0e6,
    ("tf32", 16): 11.5e6, ("tf32", 32): 66.0e6, ("tf32", 64): 99.0e6,
    ("tf32", 128): 54.0e6,
    ("mixed", 16): 11.5e6, ("mixed", 32): 66.0e6, ("mixed", 64): 99.0e6,
    ("mixed", 128): 54.0e6,
    ("bfloat16", 16): 185.0e6, ("bfloat16", 32): 500.0e6,
    ("bfloat16", 64): 500.0e6, ("bfloat16", 128): 360.0e6,
    ("float16", 16): 61.0e6, ("float16", 32): 166.0e6,
    ("float16", 64): 166.0e6, ("float16", 128): 120.0e6,
}

# (A bytes, B bytes) per element by compute/storage mode.
_ELEM_BYTES = {"float32": (4, 4), "tf32": (4, 4), "mixed": (4, 2),
               "float16": (2, 2), "bfloat16": (2, 2)}


def _row_rate(row_bytes: float, src_mb: float) -> float:
    """Gather descriptors/second of the layout model."""
    keys = sorted(_ROW_RATE_8MB)
    rb = min(keys, key=lambda k: abs(np.log(max(row_bytes, 1) / k)))
    base = _ROW_RATE_8MB[rb] * 1e6
    f = float(np.interp(src_mb, _SRC_MB, _SRC_F))
    return base * f


def _take_ms(rows: float, row_bytes: float, src_bytes: float,
             unique_rows: Optional[float] = None) -> float:
    if rows <= 0:
        return 0.0
    if unique_rows is None:
        unique_rows = rows
    eff_rows = unique_rows + _REPEAT_COST * max(rows - unique_rows, 0)
    payload = rows * row_bytes
    t_rows = eff_rows / _row_rate(row_bytes, src_bytes / 1e6)
    t_payload = payload / (TAKE_PAYLOAD_CAP_GBPS * 1e9)
    t_write = payload / (STREAM_GBPS * 1e9)
    return max(t_rows, t_payload, t_write) * 1e3


@dataclasses.dataclass
class TunedConfig:
    alpha: float
    delta: float
    merge_superpanels: bool
    group_size: int
    k_chunks: int
    est_ms: float
    packed: Optional[PackedMatrix]   # None for the dense class
    bsmr: Optional[BSMR]
    measured_ms: Optional[float] = None
    hub_cols: int = 0
    # hot-row dense slab rows (pre-tiling selection, reorder/pack.py)
    hot_rows: int = 0
    use_pallas: bool = False
    # "panels": A pre-relayouted to reordered panel-major order
    a_layout: str = "rows"
    dense: bool = False


def estimate_ms(packed: PackedMatrix, k: int,
                compute_dtype: str = "tf32", k_chunks: int = 1) -> float:
    """The layout model's predicted time (ms) for one hybrid SDDMM call,
    in the JAX package's TPU units (a ranking score here, not an H100
    time)."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    G, NG, C = packed.group_size, packed.num_col_groups, int(k_chunks)
    kc = k // C
    LG = GROUP_LANES // G
    n_tiles = (packed.num_super + packed.num_quads
               + packed.num_pairs + packed.num_groups)

    b_src = (NG + 1) * G * kc * b_el
    b_rows = n_tiles * LG
    b_uniq = min(b_rows, len(np.unique(np.concatenate([
        packed.super_gids.reshape(-1), packed.quad_gids.reshape(-1),
        packed.pair_gids.reshape(-1), packed.group_gids.reshape(-1)])))
        if b_rows else 0)
    t_b = C * _take_ms(b_rows, G * kc * b_el, b_src, b_uniq)
    a_rows = (sum(n * 128 for _, _, n in packed.super_buckets)
              + sum(n * 64 for _, _, n in packed.quad_buckets)
              + sum(n * 32 for _, _, n in packed.pair_buckets)
              + sum(n * 16 for _, _, n in packed.group_buckets))
    a_uniq = min(a_rows, packed.num_panels * 16)
    a_src = (packed.m + 1) * k * a_el
    t_a = _take_ms(a_rows, k * a_el, a_src, a_uniq)
    nR = packed.nnz_res
    t_r = _take_ms(nR, k * a_el, a_src) \
        + C * _take_ms(nR, G * kc * b_el, b_src)

    from sddmm_tpu_torch.reorder.pack import PAIR_CELLS, QUAD_CELLS
    H = packed.hub_cols
    cells = (packed.num_super * SUPER_CELLS
             + packed.num_quads * QUAD_CELLS
             + packed.num_pairs * PAIR_CELLS
             + packed.num_groups * GROUP_CELLS)
    gathered = (n_tiles * GROUP_LANES * k * b_el + a_rows * k * a_el) \
        + nR * (k * a_el + G * k * b_el)
    slab_bytes = (H * k * b_el + packed.m * k * a_el * min(C, 1)
                  + packed.m * H * 4) if H else 0
    if packed.rowslab_nrows:
        slab_bytes += (packed.rowslab_width * k * b_el
                       + packed.rowslab_nrows * k * a_el
                       + packed.rowslab_nrows * packed.rowslab_width * 4)
    stream_bytes = gathered + cells * 4 * (2 * C - 1) + nR * 4 + slab_bytes
    t_stream = stream_bytes / (STREAM_GBPS * 1e6)

    t_mxu = mxu_ms(packed, k, compute_dtype)

    t_gather = t_b + t_a + t_r
    return t_gather + t_stream + max(t_mxu - t_gather, 0.0)


def mxu_ms(packed: PackedMatrix, k: int,
           compute_dtype: str = "tf32") -> float:
    """The layout model's matrix-unit term of ``estimate_ms``."""
    H = packed.hub_cols
    rate128 = _DOT_G16_MS.get((compute_dtype, 128), 54.0e6)
    t_mxu = (packed.num_groups / _DOT_G16_MS.get((compute_dtype, 16),
                                                 11.5e6)
             + packed.num_pairs * 2 / _DOT_G16_MS.get((compute_dtype, 32),
                                                      66.0e6)
             + packed.num_quads * 4 / _DOT_G16_MS.get((compute_dtype, 64),
                                                      99.0e6)
             + packed.num_super * 8 / rate128) \
        * 1e3 * (k / 128.0)
    if H:
        t_mxu += (packed.m / 16.0) * (H / 128.0) / rate128 \
            * 1e3 * (k / 128.0)
    if packed.rowslab_nrows:
        t_mxu += (packed.rowslab_nrows / 16.0) \
            * (packed.rowslab_width / 128.0) / rate128 \
            * 1e3 * (k / 128.0)
    return t_mxu


def from_params(csr: CSR, k: int, alpha: float, delta: float,
                group_size: int = 1, k_chunks: int = 1,
                merge_superpanels: bool = True,
                compute_dtype: str = "tf32",
                method: str = "auto",
                hub_cols: int = 0,
                window_dp: bool = True,
                sort_runs: str = "cid",
                sort_res: str = "csr",
                b_cost_scale: float = 1.0,
                hot_rows: int = 0,
                hot_rows_pre: bool = False) -> TunedConfig:
    """Build a TunedConfig for an explicit (alpha, delta, G, C, merge)
    choice — the deterministic path bench.py uses with the committed
    per-matrix configs (results/tuned_configs.json)."""
    rank = None
    base_order = None
    if group_size > 1:
        from sddmm_tpu_torch.reorder.cols import cluster_columns
        base_order = cluster_columns(csr, alpha, method=method)
    if hub_cols > 0:
        from sddmm_tpu_torch.reorder.cols import hub_first_rank
        rank = hub_first_rank(csr, hub_cols, base_order=base_order)
    elif base_order is not None:
        rank = np.empty(csr.n, dtype=np.int64)
        rank[base_order] = np.arange(csr.n)
    hot_ids = None
    cluster_csr = csr
    if hot_rows > 0 and hot_rows_pre:
        # Pre-tiling hot-row selection: the R rows with the largest
        # NON-hub degree go to the dense hot-row slab, and their
        # entries are removed from the clustering/carve input.
        from sddmm_tpu_torch.data.sparse import COO
        rows_all = csr.row_indices().astype(np.int64)
        nonhub = (rank[csr.col_idx] >= hub_cols
                  if (hub_cols > 0 and rank is not None)
                  else np.ones(csr.nnz, dtype=bool))
        deg = np.bincount(rows_all[nonhub], minlength=csr.m)
        hot_ids = np.argsort(-deg, kind="stable")[:hot_rows]
        hot_ids = np.sort(hot_ids[deg[hot_ids] > 0])
        hot_mask = np.zeros(csr.m, dtype=bool)
        hot_mask[hot_ids] = True
        keep = ~hot_mask[rows_all]
        cluster_csr = COO(csr.shape, rows_all[keep],
                          csr.col_idx[keep].astype(np.int64),
                          csr.values[keep]).to_csr()
    bsmr = BSMR(alpha, delta, cluster_csr, method=method,
                group_size=group_size, col_rank=rank, hub_cols=hub_cols)
    packed = pack(csr, bsmr, k_hint=k, merge_superpanels=merge_superpanels,
                  compute_dtype=compute_dtype, window_dp=window_dp,
                  sort_runs=sort_runs, sort_res=sort_res,
                  b_cost_scale=b_cost_scale,
                  hot_rows=0 if hot_ids is not None else hot_rows,
                  hot_row_ids=hot_ids)
    return TunedConfig(alpha, delta, merge_superpanels, group_size,
                       k_chunks, estimate_ms(packed, k, compute_dtype,
                                             k_chunks), packed, bsmr,
                       hub_cols=hub_cols)
