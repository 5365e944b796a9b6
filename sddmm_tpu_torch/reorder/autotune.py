"""Configuration search for the hybrid SDDMM: the layout cost model,
``from_params`` and the shoot-out.

Counterpart of ``sddmm_tpu/reorder/autotune.py``: ``TunedConfig``,
``estimate_ms``, ``mxu_ms``, ``estimate_dense_ms``, ``_candidate_layouts``,
``hub_candidates``, ``autotune_multi``, ``autotune``, the shoot-out
(``shootout_finalists`` picks the finalists, ``_shootout`` times them) and
``from_params`` (the deterministic path the bench takes with a committed
per-matrix config).

The constants are the JAX package's layout-model constants, copied
unchanged so that ``pack`` (which reads ``_DOT_G16_MS``) builds the identical
``PackedMatrix`` and the estimate-only search ranks the candidates, and
picks the finalists, exactly as the JAX package does.  They were measured
on a TPU and say nothing about the speed of this port's card: on the card
only the measured mode ranks, timing every finalist with the port's
runners (``measure_kernel_ms``).  Measuring the model's constants on the
H100 is a later ROADMAP item.  Not copied: the calibration and gather-grid
loaders and ``descriptor_floor_ms``, which model the TPU's gather engine.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Sequence

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
    # not in the JAX package: the shoot-out's host seconds to build this
    # finalist's runner and operands, and on its winner every finalist
    # timed, fastest first
    setup_s: Optional[float] = dataclasses.field(default=None,
                                                 compare=False)
    shootout: Optional[list] = dataclasses.field(default=None, repr=False,
                                                 compare=False)


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


def estimate_dense_ms(m: int, n: int, k: int,
                      compute_dtype: str = "tf32") -> float:
    """The layout model's score (ms, TPU units) for the dense-tiling class:
    one (M, K) x (K, N) product with the full (M, N) fp32 output.
    Streaming is the A + B read plus the (M, N) write; the matrix-unit term
    uses the 128-tall rate.  One large product overlaps its operand
    streaming, so the score is the max of the two, not the sum."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    stream = m * k * a_el + n * k * b_el + m * n * 4
    t_stream = stream / (STREAM_GBPS * 1e6)
    rate128 = _DOT_G16_MS.get((compute_dtype, 128), 54.0e6)
    t_mxu = (m / 16.0) * (n / 128.0) / rate128 * 1e3 * (k / 128.0)
    return max(t_stream, t_mxu)


def _candidate_layouts(n: int, k: int, compute_dtype: str):
    """(G, C) candidates: the group widths whose B^T rows come nearest 256
    and 512 bytes, and, where the grouped B^T exceeds 12 MB, the chunk
    counts that bring a chunk nearest 8 MB (the layout model's sweet
    spots)."""
    el = _ELEM_BYTES[compute_dtype][1]  # B-side storage drives the layout
    gs = {1}
    for target in (256, 512):
        g = max(1, target // (k * el))
        if g > 1:
            gs.add(1 << int(np.floor(np.log2(g))))
    cs = {1}
    src_mb = n * k * el / 1e6
    if src_mb > 12.0:
        for c in (1 << int(np.floor(np.log2(src_mb / 8.0))),
                  1 << int(np.ceil(np.log2(src_mb / 8.0)))):
            while c > 1 and k % c:
                c //= 2
            if 1 < c <= 8:
                cs.add(c)
    return sorted(gs), sorted(cs)


def hub_candidates(csr: CSR, k: int, compute_dtype: str = "tf32",
                   cell_cap: int = 32_000_000) -> list:
    """Hub-slab widths worth trying for this matrix, by the layout model:
    the largest H (multiple of 128) such that even the H-th-degree column
    saves more gather time than its slab column costs (one m-row lane strip
    of the product plus the slab write), capped so the slab stays a bounded
    share of the packed output; also H/2 and 2H where they differ.  []
    when no column clears the bar (block-structured matrices)."""
    a_el, b_el = _ELEM_BYTES[compute_dtype]
    deg = np.sort(np.bincount(csr.col_idx, minlength=csr.n))[::-1]
    m_eff = int(np.count_nonzero(csr.row_nnz())) or 1
    num_panels = max(-(-m_eff // 16), 1)
    rate128 = _DOT_G16_MS.get((compute_dtype, 128), 54.0e6)
    # ns per slab column: write m cells + the (m x K) x (K x 1) strip
    slab_ns = (m_eff * 4 / (STREAM_GBPS)
               + (m_eff / 16.0) * (k / 128.0) / 128.0 / rate128 * 1e9)
    # ns saved per hub column: one gather per panel it appears in
    desc_ns = 1e9 / _row_rate(max(k * b_el, 1), 8.0)
    save_ns = np.minimum(deg, num_panels) * desc_ns
    h_star = int(np.count_nonzero(save_ns > slab_ns))
    if h_star <= 0:
        return []
    h_star = min(-(-h_star // 128) * 128, cell_cap // max(csr.m, 1),
                 csr.n // 128 * 128)
    if h_star <= 0:
        return []
    out = [h_star]
    if h_star >= 512:
        out.append(h_star // 2 // 128 * 128)
    twice = min(2 * h_star, cell_cap // max(csr.m, 1), csr.n) // 128 * 128
    if twice > h_star:
        out.append(twice)
    return out


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
                hot_rows_pre: bool = False,
                device="cuda") -> TunedConfig:
    """Build a TunedConfig for an explicit (alpha, delta, G, C, merge)
    choice — the deterministic path bench.py uses with the committed
    per-matrix configs (results/tuned_configs.json).  ``device``: where
    ``method="device"`` clusters."""
    rank = None
    base_order = None
    if group_size > 1:
        from sddmm_tpu_torch.reorder.cols import cluster_columns
        base_order = cluster_columns(csr, alpha, method=method,
                                    device=device)
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
                group_size=group_size, col_rank=rank, hub_cols=hub_cols,
                device=device)
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


def autotune_multi(csr: CSR, ks: Sequence[int],
                   alphas: Sequence[float] = (0.1, 0.3, 0.5),
                   deltas: Sequence[float] = (0.0, 0.05, 0.3),
                   merges: Sequence[bool] = (False, True),
                   compute_dtype: str = "tf32",
                   method: str = "auto",
                   measure: bool = False,
                   measure_top: int = 3,
                   measure_iterations: int = 30,
                   allow_dense: bool = True,
                   verbose: bool = False,
                   device="cuda") -> dict:
    """Pick (alpha, delta, merge, G, C, hub, hot rows, dense) for every K
    in ``ks`` at once: by the layout model's score alone, or with
    ``measure=True`` by timing the shoot-out's finalists
    (``shootout_finalists``) with the port's runners on ``device`` (the
    card unless the caller asks for the CPU; the reference's empirical
    sweep, src/sddmm.cu:62-118, guided by the model).

    Packing is K-independent, so candidate packs are built once per
    (alpha, G, delta, merge, hub) and shared across Ks; row reordering is
    computed once per alpha and reused across deltas (the reference's test
    mode trick).  Returns {k: TunedConfig}; in the measured mode each
    winner's ``shootout`` lists every finalist timed, fastest first."""
    layouts = {k: _candidate_layouts(csr.n, k, compute_dtype) for k in ks}
    all_gs = sorted({g for k in ks for g in layouts[k][0]})
    col_order_cache: dict[float, np.ndarray] = {}  # keyed by alpha
    packs: list[tuple] = []  # (alpha, g, delta, merge, hub, packed, bsmr)
    hubs_all = sorted({h for k in ks
                       for h in hub_candidates(csr, k, compute_dtype)})

    from sddmm_tpu_torch.reorder.cols import cluster_columns, hub_first_rank
    for alpha in alphas:
        base = BSMR(alpha, 0.0, csr, method=method, compute=False,
                    device=device)
        base.run_row_reordering(csr)
        for g in all_gs:
            if g > 1 and alpha not in col_order_cache:
                col_order_cache[alpha] = cluster_columns(
                    csr, alpha, method=method, device=device)
            base_order = col_order_cache.get(alpha) if g > 1 else None
            for hc in [0] + [h for h in hubs_all if h % g == 0]:
                if hc > 0:
                    rank = hub_first_rank(csr, hc, base_order=base_order)
                elif base_order is not None:
                    rank = np.empty(csr.n, dtype=np.int64)
                    rank[base_order] = np.arange(csr.n)
                else:
                    rank = None
                bsmr = BSMR(alpha, 0.0, csr, method=method, compute=False,
                            group_size=g, col_rank=rank, hub_cols=hc)
                bsmr.reordered_rows = base.reordered_rows
                bsmr.cluster_ids = base.cluster_ids
                bsmr.num_clusters = base.num_clusters
                bsmr.row_reordering_ms = base.row_reordering_ms
                # hub slab and superpanel merging interact weakly: the hub
                # packs take merge=True only
                merges_hc = merges if hc == 0 else (True,)
                for delta in deltas:
                    bsmr.run_col_reordering(csr, delta=delta)
                    for merge in merges_hc:
                        # light pack: the winner is packed again with full
                        # metadata below
                        packed = pack(csr, bsmr, merge_superpanels=merge,
                                      compute_dtype=compute_dtype,
                                      full_metadata=False)
                        packs.append((alpha, g, delta, merge, hc, packed,
                                      copy.copy(bsmr)))

    # Hot-row slab candidate: on matrices with skewed row degrees the carve
    # otherwise covers the hot rows' scattered tail with nearly empty
    # tiles; one pre-tiling slab pack enters (K-independent, built once).
    rowslab_pack = None
    deg = np.diff(csr.row_ptr)
    R_slab = 1024
    if csr.m > 2 * R_slab and csr.nnz:
        share = float(np.sort(deg)[::-1][:R_slab].sum()) / csr.nnz
        if share >= 0.3:
            hc0 = max([h for h in hubs_all] or [0])
            try:
                t0 = from_params(
                    csr, ks[0], alpha=alphas[0], delta=0.05,
                    hub_cols=hc0, compute_dtype=compute_dtype,
                    method=method, hot_rows=R_slab, hot_rows_pre=True,
                    device=device)
                rowslab_pack = (alphas[0], hc0, t0.packed, t0.bsmr)
            except Exception as e:  # noqa: BLE001 — a candidate only
                import warnings as _w
                _w.warn(f"rowslab candidate skipped: {e}")

    out = {}
    for k in ks:
        gs_k, cs_k = layouts[k]
        candidates: list[TunedConfig] = []
        if rowslab_pack is not None:
            a0, hc0, pk0, bs0 = rowslab_pack
            candidates.append(TunedConfig(
                a0, 0.05, True, 1, 1,
                estimate_ms(pk0, k, compute_dtype, 1), pk0, bs0,
                hub_cols=hc0, hot_rows=R_slab))
        for (alpha, g, delta, merge, hc, packed, bsmr) in packs:
            if g not in gs_k:
                continue
            for c in cs_k:
                est = estimate_ms(packed, k, compute_dtype, c)
                if verbose:
                    print(f"  k={k} a={alpha} d={delta} G={g} C={c} "
                          f"merge={merge} H={hc}: nS={packed.num_super} "
                          f"nG={packed.num_groups} "
                          f"res={packed.nnz_res} est={est:.3f}")
                candidates.append(TunedConfig(
                    alpha, delta, merge, g, c, est, packed, bsmr,
                    hub_cols=hc))
        candidates.sort(key=lambda t: t.est_ms)
        # The dense class enters only at DLMC densities, and when the
        # model puts it within 2x of the best packed candidate.
        density = csr.nnz / float(max(csr.m * csr.n, 1))
        d_est = estimate_dense_ms(csr.m, csr.n, k, compute_dtype)
        if allow_dense and density >= 0.05 and candidates \
                and d_est < 2.0 * candidates[0].est_ms:
            candidates.append(TunedConfig(0.0, 0.0, False, 1, 1, d_est,
                                          None, None, dense=True))
            candidates.sort(key=lambda t: t.est_ms)
        if not measure:
            out[k] = candidates[0]
        else:
            out[k] = _shootout(csr, k, candidates, compute_dtype,
                               measure_top, measure_iterations, verbose,
                               device)
        win = out[k]
        if win.packed is not None and win.packed.packed_rows is None:
            # pack the winner again with full (CSR-order) metadata
            win.packed = pack(csr, win.bsmr,
                              merge_superpanels=win.merge_superpanels,
                              compute_dtype=compute_dtype)
    return out


def autotune(csr: CSR, k: int = 128,
             alphas: Sequence[float] = (0.1, 0.3, 0.5),
             deltas: Sequence[float] = (0.0, 0.05, 0.3),
             merges: Sequence[bool] = (False, True),
             compute_dtype: str = "tf32",
             method: str = "auto",
             measure: bool = False,
             measure_top: int = 3,
             measure_iterations: int = 30,
             allow_dense: bool = True,
             verbose: bool = False,
             device="cuda") -> TunedConfig:
    """Single-K convenience wrapper over autotune_multi."""
    return autotune_multi(
        csr, (k,), alphas=alphas, deltas=deltas, merges=merges,
        compute_dtype=compute_dtype, method=method, measure=measure,
        measure_top=measure_top, measure_iterations=measure_iterations,
        allow_dense=allow_dense, verbose=verbose, device=device)[k]


def shootout_finalists(candidates, compute_dtype: str,
                       measure_top: int) -> list:
    """The shoot-out's finalists among ``candidates`` (sorted by score):
    the model's top ``measure_top`` plus the best candidate of every
    distinct (merge, G, C, hub, hot rows, dense) class, delta and alpha, up
    to ``measure_top + 6``; then, in "tf32", a ``use_pallas`` twin of the
    best packed finalist (at G = 1, no hub) and ``a_layout="panels"`` twins
    of it and its pallas twin where the packing has container topology.
    The JAX package's selection exactly.  Here a ``use_pallas`` twin runs
    the same tile kernel as its base (``HybridSDDMM``): it is timed all the
    same, so the list is JAX's."""
    finalists: list[TunedConfig] = []
    seen_cls: set = set()
    seen_delta: set = set()
    seen_alpha: set = set()
    for cand in candidates:
        cls = (cand.merge_superpanels, cand.group_size, cand.k_chunks,
               cand.hub_cols, cand.hot_rows, cand.dense)
        take_it = (len(finalists) < measure_top or cls not in seen_cls
                   or cand.delta not in seen_delta
                   or cand.alpha not in seen_alpha)
        if take_it and cand not in finalists:
            finalists.append(cand)
            seen_cls.add(cls)
            seen_delta.add(cand.delta)
            seen_alpha.add(cand.alpha)
        if len(finalists) >= measure_top + 6:
            break
    # twins attach to the best packed finalist (the dense class has none)
    twin_base = [f for f in finalists if not f.dense][:1]
    if compute_dtype == "tf32" and twin_base and \
            twin_base[0].group_size == 1 and not twin_base[0].hub_cols:
        twin = copy.copy(twin_base[0])
        twin.use_pallas = True
        finalists.append(twin)
        twin_base.append(twin)
    for cand in twin_base:
        if cand.a_layout == "rows" and \
                cand.packed.cont_panel_off is not None:
            twin = copy.copy(cand)
            twin.a_layout = "panels"
            finalists.append(twin)
    return finalists


def _shootout(csr, k, candidates, compute_dtype, measure_top,
              measure_iterations, verbose, device="cuda"):
    """Time every finalist (``shootout_finalists``) with the port's runner
    on ``device``: the runner and operands built (``setup_s``, host
    seconds), then ``measure_kernel_ms`` (event time on the card).  The
    fastest wins; its ``shootout`` lists all, fastest first."""
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    out = []
    for cand in shootout_finalists(candidates, compute_dtype, measure_top):
        t0 = time.perf_counter()
        if cand.dense:
            runner = DenseSDDMM.from_csr(csr, compute_dtype=compute_dtype,
                                         device=device)
        else:
            runner = HybridSDDMM(cand.packed, compute_dtype=compute_dtype,
                                 k_chunks=cand.k_chunks,
                                 use_pallas=cand.use_pallas,
                                 a_layout=cand.a_layout, device=device)
        a_pad, bt_phys = runner.prepare_operands(a, b=b)
        cand = copy.copy(cand)
        cand.setup_s = time.perf_counter() - t0
        cand.measured_ms = runner.measure_kernel_ms(
            a_pad, bt_phys, iterations=measure_iterations, repeats=6)
        del runner, a_pad, bt_phys
        out.append(cand)
        if verbose:
            print(f"  measured a={cand.alpha} d={cand.delta} "
                  f"G={cand.group_size} C={cand.k_chunks} "
                  f"H={cand.hub_cols} hot={cand.hot_rows} "
                  f"pallas={cand.use_pallas}"
                  f"{' (the same tile kernel here)' if cand.use_pallas else ''}"
                  f" aL={cand.a_layout} dense={cand.dense} "
                  f"merge={cand.merge_superpanels}: "
                  f"{cand.measured_ms:.4f} ms (score {cand.est_ms:.3f}; "
                  f"set-up {cand.setup_s:.2f} s)")
    out.sort(key=lambda t: t.measured_ms)
    out[0].shootout = list(out)
    return out[0]
