#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sddmm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a), nvcc and the repo checkout around
this file; imports nothing of JAX.  Phases, each printing its own lines and
its time:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: nvcc builds ``sddmm_tpu_torch/csrc/*.cu``, one process per
   source, all at once (timed);
3. every compute-mode instance of the tile kernel against its plain PyTorch
   version on U[0,2) tiles with ragged R and L, at the slab shapes, into a
   strided output view at an unaligned offset, and with a C=2 accumulate;
   "tf32" and "float32" also against an fp64 product under the contract;
   then "float32" against fp64 within about one fp32 rounding, and below
   "tf32" on the same U[0,2) tiles and on ``split_probe`` tiles, where
   "tf32" must miss 3 * 2^-18 of each product; every instance also at
   K = 8 and 24 (zero-padded to the kernel's 16-step) and a C=2 chunk at
   K = 24;
4. the gather-dot kernel against its plain version at G in (1, 2, 4), C
   in (1, 2), each storage pair of the compute modes and H in (1, 3)
   heads in one launch: random entries walked in their order, and
   clustered entries (rows sharing keys) sorted and unsorted, walked with
   a plan and without; the CSR SpMM kernel against its plain version on
   random patterns with empty rows and one very long row, at K in (8, 64,
   128); the segment softmax kernel against its plain version on random
   patterns (every 7th row empty, one row of 200,000 entries) at H in
   (1, 12), from packed scores through an ``inv_idx`` and from CSR-order
   scores;
5. the main path at full bench scale: every K=128 cell of ``bench.py``'s
   suite (clustered16, clustered128, powerlaw with its hub and hot-row
   slabs, banded, and dlmc through ``DenseSDDMM``) plus clustered16 at K=32
   (G=4), banded at K=64 (G=2) and powerlaw at K=256, generated as
   ``bench.py`` does, packed with the committed
   ``results/tuned_configs.json`` configs, run through the port's runners
   on the card into CSR order and checked against the fp64 golden model;
   the launch counters are zeroed just before this run and read just
   after, per cell: each call must launch the tile kernel exactly once
   (every segment, chunk and slab of the packing, or the dense product)
   and the gather-dot exactly once where the packing has a residual (it
   walks the residual's plan, ``HybridSDDMM.res_plan``);
6. per cell, each kernel again at the main path's own shapes against its
   plain version (the tile kernel's one launch against the per-segment
   route of gathers and ``tile_dot_plain``); then timing with CUDA events
   (median of 20 after warm-up at K=128, of 5 at the other K): the call
   with the kernels, with the plain versions, and into CSR order, and each
   kernel beside its plain version, beside one PyTorch call that computes
   the same function (``torch.bmm`` in full fp32 on the per-segment
   route's pre-gathered tiles, gathers not counted;
   ``torch.sparse.sampled_addmm`` for the gather-dot), and beside its
   bound: the bytes it must move (each input read once, each output
   written once) over the card's 3.35 TB/s, or its operations over the
   peak of their type (989 TFLOP/s for the tile kernel's bf16 products,
   67 TFLOP/s for fp32 outside the tensor cores), whichever is larger;
7. the CSR baseline (the gather-dot kernel with C = G = 1) on each K=128
   cell: the pattern's plan built on the host (its seconds printed), one
   planned launch per cell checked against the golden, timed beside its
   plain version, ``sampled_addmm`` and its bound, and the hybrid's
   speed-up over it on this card; ``batched_csr_sddmm`` on a batch of 2
   is one launch;
8. the five compute modes on banded K=128: "float32", "tf32" and "mixed"
   must pass the contract; "float16" and "bfloat16" fail it by design, so
   they are held to their plain versions and their max rel is printed;
9. the models, the serving path of the two attention families at full
   width in "float32", through the user's entry points: graph attention
   on clustered16 (16384 nodes, F = D = 128, packed by the layer's own
   default) and block-sparse attention in the shape of Longformer-base
   (``allenai/longformer-base-4096``: 4096 positions, window 256 each
   side, 1 global token, hidden 768, 12 heads of 64), plus the port's
   ``entry``.  The launch counters are zeroed just before the forwards and
   read just after: each forward launches the tile kernel's "float32"
   instance, the segment softmax and the SpMM kernel exactly once (the
   Longformer's 12 heads together), and the gather-dot once where a
   packing has a residual.  Each output is checked against an fp64
   reference under the contract and against the same forward with every
   kernel's plain version; both forwards, the SpMM at the models' shapes
   (beside ``torch.sparse.mm`` on a CSR tensor and its bound) and the
   segment softmax at the models' shapes (beside ``torch.sparse.softmax``
   on a COO tensor of the same scaled scores and its bound) are timed.

It then prints one JSON line with the kernels' record (per kernel: its
launches on its path, max abs error against its plain version, and the
summed times of the timed calls: kernel, plain version, PyTorch library
call, and bound with what sets it) and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
those lines.  Without a CUDA card, or outside the repo, it fails at once.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
# the main path's cells: (matrix, K); K=128 cells are timed at full depth
CELLS = [("clustered16", 128), ("clustered128", 128), ("powerlaw", 128),
         ("banded", 128), ("dlmc", 128), ("clustered16", 32), ("banded", 64),
         ("powerlaw", 256)]
MODES_CELL = ("banded", 128)
TIMING_ITERS = {128: 20}   # other K: SHORT_ITERS
SHORT_ITERS = 5
TILE_REL_TOL = 1e-4     # kernel vs plain: tensor-core sums, another order
GATHER_REL_TOL = 1e-6   # kernel vs plain: both exact fp32, another sum order
# "float32" against fp64, as max abs err / min |exact| per shape: about one
# fp32 rounding, where "tf32" errs by up to 3 * 2^-18 (1.1e-5) per product
F32_EXACT_REL = 1e-6
# "tf32" on split_probe operands drops 3 * 2^-18 of every product: an error
# below this means the probe no longer separates the two instances
PROBE_TF32_MIN = 1e-5
# SpMM kernel vs plain: the same fp32 products summed in another order (the
# kernel row by row, index_add_ with atomics), as max abs err / the sum of
# the terms' magnitudes.  A sum of n terms errs by up to (n-1) * 2^-24 of
# that, and by about sqrt(n) * 2^-24 in practice: 3.8e-6 for the
# 4096-entry rows of a global token
SPMM_REL_TOL = 1e-5
SPMM_K = (8, 64, 128)
# softmax kernel vs plain, as max |kernel - plain| / plain: the same fp32
# exps, the denominator summed in another order over up to 200,000 terms
SOFTMAX_REL_TOL = 1e-5
SOFTMAX_HEADS = (1, 12)
# the models phase: graph attention's cell and width, and Longformer-base
GRAPH_CELL = "clustered16"
GRAPH_WIDTH = 128
LONGFORMER = dict(seq_len=4096, window=256, num_global=1, hidden=768,
                  heads=12, head_dim=64)
# a model's kernel path vs its plain path, as max abs diff / max |plain|:
# the scores differ by the tile sums' order, the aggregation by the SpMM's
# (an output near 0 has no relative error to speak of)
MODEL_PLAIN_TOL = 1e-5
MODEL_ITERS = 10        # timed forwards with the kernels, after 2 warm-ups
MODEL_PLAIN_ITERS = 3   # and with the plain versions, after 1
# the card's published peaks (H100 SXM, NVIDIA's data sheet), for bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
FP32_FLOPS = 67e12      # fp32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f"[phase] {self.name} ...")

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s")


def suite():
    """bench.py's full suite, with its generator calls."""
    from sddmm_tpu_torch.data import generate
    return {
        "clustered16": lambda: generate.block_clustered(
            1024, 1024, block_prob=0.008, block_density=0.65,
            noise_density=0.00001, seed=42),
        "clustered128": lambda: generate.block_clustered(
            128, 128, group_rows=128, group_cols=128, block_prob=0.025,
            block_density=0.3, noise_density=0.00001, seed=43),
        "powerlaw": lambda: generate.powerlaw_graph(
            32768, avg_degree=40, seed=44),
        "banded": lambda: generate.banded(
            24576, 24576, bandwidth=45, fill=0.55, seed=45),
        "dlmc": lambda: generate.random_sparse(
            4096, 4096, density=0.2, seed=46),
    }


def tuned(csr, k, cfg):
    """from_params on a committed config, mapped as bench.py maps it."""
    from sddmm_tpu_torch.reorder.autotune import from_params
    t = from_params(
        csr, k, alpha=cfg["alpha"], delta=cfg["delta"],
        group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
        merge_superpanels=cfg.get("merge", True),
        hub_cols=cfg.get("hub", 0),
        compute_dtype=cfg.get("dtype", "tf32"),
        window_dp=cfg.get("window_dp", True),
        sort_runs=cfg.get("sort_runs", "cid"),
        sort_res=cfg.get("sort_res", "csr"),
        b_cost_scale=cfg.get("b_cost_scale", 1.0),
        hot_rows=cfg.get("rowslab_pre", 0) or cfg.get("rowslab", 0),
        hot_rows_pre=bool(cfg.get("rowslab_pre", 0)))
    t.use_pallas = bool(cfg.get("pallas", False))
    t.a_layout = cfg.get("a_layout", "rows")
    return t


def max_rel(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def hybrid_runner(packed, t, mode):
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    return HybridSDDMM(packed, compute_dtype=mode, k_chunks=t.k_chunks,
                       use_pallas=t.use_pallas, a_layout=t.a_layout,
                       device=DEVICE)


def check_tile_dot(torch, td, rng):
    """Every mode instance against its plain version; returns
    {mode: (max rel, max abs)} and the number of shapes."""
    worst = {mode: [0.0, 0.0] for mode in td.MODES}
    n_shapes = 0

    def one(mode, a, b, out=None, accumulate=False, contract=False):
        want = td.tile_dot_plain(a, b, mode)
        if accumulate:
            want = want + out
        got = td.tile_dot(a, b, mode, out=out, accumulate=accumulate)
        torch.cuda.synchronize()
        rel = max_rel(got, want)
        worst[mode][0] = max(worst[mode][0], rel)
        worst[mode][1] = max(worst[mode][1], float((got - want).abs().max()))
        if not rel <= TILE_REL_TOL:
            fail(f"tile_dot[{mode}] {tuple(a.shape)} x {tuple(b.shape)}: "
                 f"max rel {rel:.3e} vs plain > {TILE_REL_TOL}")
        if contract and not accumulate:
            exact = torch.bmm(a.double(), b.double().transpose(1, 2))
            err = (got.double() - exact).abs()
            bad = (err >= 1e-5) & (err / exact.abs() >= 1e-3)
            if bool(bad.any()):
                fail(f"tile_dot[{mode}] {tuple(a.shape)} x "
                     f"{tuple(b.shape)}: {int(bad.sum())} cells outside abs "
                     "1e-5 / rel 1e-3 vs fp64")
        return got

    for mode, (adt, bdt, *_) in td.MODES.items():
        contract = mode in ("tf32", "float32")

        def u02(shape, dt):
            return torch.tensor(rng.uniform(0, 2, shape), dtype=torch.float32,
                                device=DEVICE).to(dt)

        nT = 37  # not a power of two: no padding of the batch is needed
        for R in (16, 37, 64, 128):
            for L in (128, 150, 384):
                for Kd in (32, 128, 256):
                    one(mode, u02((nT, R, Kd), adt), u02((nT, L, Kd), bdt),
                        contract=contract)
                    n_shapes += 1
        # slab shapes (nT = 1): a hub-like (M, H) block, and a hot-row-like
        # block written into a flat buffer at an odd offset
        one(mode, u02((1, 3000, 128), adt), u02((1, 2048, 128), bdt),
            contract=contract)
        buf = torch.zeros(1 + 517 * 10007, device=DEVICE)
        out = buf[1:].view(1, 517, 10007)[:, :, :10000]
        a, b = u02((1, 517, 128), adt), u02((1, 10000, 128), bdt)
        one(mode, a[:, :, :64], b[:, :, :64], out=out, contract=contract)
        # the second K chunk: column views, added into the same output
        one(mode, a[:, :, 64:], b[:, :, 64:], out=out, accumulate=True)
        n_shapes += 3
        # K off the kernel's 16-step: tile_dot zero-pads copies of A and B
        for Kd in (8, 24):
            one(mode, u02((nT, 37, Kd), adt), u02((nT, 150, Kd), bdt),
                contract=contract)
            n_shapes += 1
        # a C=2 chunk of kc = 12 at K = 24, added into a strided output
        a, b = u02((nT, 37, 24), adt), u02((nT, 150, 24), bdt)
        out = torch.zeros((nT, 37, 151), device=DEVICE)[:, :, :150]
        one(mode, a[:, :, :12], b[:, :, :12], out=out, contract=contract)
        one(mode, a[:, :, 12:], b[:, :, 12:], out=out, accumulate=True)
        n_shapes += 2
    return worst, n_shapes


def check_float32_precision(torch, td, rng):
    """"float32" and "tf32" against fp64 on the same operands: U[0,2)
    tiles, where "float32" must be within F32_EXACT_REL and below "tf32",
    and split_probe tiles, where "tf32" misses 3 * 2^-18 and "float32" must
    still be within F32_EXACT_REL.  So an instance with fewer products or
    planes than the six of "float32" fails.  Returns {(data, mode): worst
    max abs err / min |exact|}."""
    worst = {}
    for data in ("U[0,2)", "probe"):
        for nT, R, L, Kd in ((37, 37, 150, 96), (16, 128, 384, 128),
                             (4, 128, 384, 256)):
            if data == "probe":
                a = td.split_probe(rng, (nT, R, Kd))
                b = td.split_probe(rng, (nT, L, Kd))
            else:
                a = torch.tensor(rng.uniform(0, 2, (nT, R, Kd)),
                                 dtype=torch.float32)
                b = torch.tensor(rng.uniform(0, 2, (nT, L, Kd)),
                                 dtype=torch.float32)
            a, b = a.to(DEVICE), b.to(DEVICE)
            exact = torch.bmm(a.double(), b.double().transpose(1, 2))
            err = {}
            for mode in ("float32", "tf32"):
                got = td.tile_dot(a, b, mode).double()
                err[mode] = float((got - exact).abs().max()
                                  / exact.abs().min())
                worst[(data, mode)] = max(worst.get((data, mode), 0.0),
                                          err[mode])
            shape = f"{data} {(nT, R, Kd)} x {(nT, L, Kd)}"
            say(f"[float32] {shape}: max abs err / min |exact| vs fp64: "
                f"float32 {err['float32']:.3e}, tf32 {err['tf32']:.3e}")
            if not err["float32"] <= F32_EXACT_REL:
                fail(f"tile_dot[float32] {shape}: {err['float32']:.3e} vs "
                     f"fp64 > {F32_EXACT_REL}")
            if data == "U[0,2)" and not err["float32"] < err["tf32"]:
                fail(f"tile_dot[float32] {shape}: {err['float32']:.3e} vs "
                     f"fp64, not below tf32's {err['tf32']:.3e}")
            if data == "probe" and not err["tf32"] >= PROBE_TF32_MIN:
                fail(f"tile_dot[tf32] {shape}: {err['tf32']:.3e} vs fp64 < "
                     f"{PROBE_TF32_MIN}: the probe does not separate")
    return worst


def shared_entries(rng, m, n_keys, order):
    """(rows, keys) of clustered rows: groups of 8 rows draw 70 % of a
    common set of 48 keys (every 7th row empty, rows shuffled), the entries
    in CSR order ("sorted") or shuffled ("unsorted")."""
    import numpy as np
    perm = rng.permutation(m)
    grp = np.repeat(np.arange(-(-m // 8)), 8)[:m]
    common = np.stack([rng.choice(n_keys, 48, replace=False)
                       for _ in range(grp.max() + 1)])
    rows = np.repeat(perm, 48)
    keys = common[grp].reshape(-1)
    keep = (rng.random(len(rows)) < 0.7) & (rows % 7 != 0)
    rows, keys = rows[keep], keys[keep]
    o = (np.lexsort((keys, rows)) if order == "sorted"
         else rng.permutation(len(rows)))
    return rows[o], keys[o]


def check_gather_dot(torch, hy, rng):
    """The gather-dot against its plain version, every instance: random
    entries in their order, and clustered entries sorted and unsorted with
    a plan and without, for 1 and 3 heads in one launch.  Returns (max
    rel, max abs, cases)."""
    import numpy as np
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops.gather_plan import gather_plan
    worst_rel = worst_abs = 0.0
    cases = 0
    m, ng, nR, K = 4096, 3072, 65536, 128
    for G in (1, 2, 4):
        for C in (1, 2):
            kc = K // C
            lists = {"random": (rng.integers(0, m + 1, nR),
                                rng.integers(0, (ng + 1) * G, nR))}
            for order in ("sorted", "unsorted"):
                lists[order] = shared_entries(rng, m, ng * G, order)
            entry_lists = {}
            for lst, (rows_np, keys_np) in lists.items():
                t = {name: torch.tensor(x, dtype=torch.int32, device=DEVICE)
                     for name, x in (("rows", rows_np), ("gids", keys_np // G),
                                     ("member", keys_np % G))}
                plans = [None] + ([] if lst == "random" else [gather_plan(
                    rows_np, keys_np, group_rows=8).to(DEVICE)])
                entry_lists[lst] = (t, plans)
            for adt, bdt in hy.GATHER_STORAGE:
                for H in (1, 3):
                    a = torch.tensor(rng.uniform(0, 2, (H, m + 1, K)),
                                     dtype=torch.float32,
                                     device=DEVICE).to(adt)
                    bt = torch.tensor(
                        rng.uniform(0, 2, (H, C, ng + 1, G * kc)),
                        dtype=torch.float32, device=DEVICE).to(bdt)
                    for lst, (t, plans) in entry_lists.items():
                        member = t["member"] if G > 1 else None
                        for plan in plans:
                            name = _kernels.gather_dot_entry(adt, bdt)
                            n0 = _kernels.launches[name]
                            got = hy.residual_gather_dot(
                                a, bt, t["rows"], t["gids"], member,
                                plan=plan)
                            if _kernels.launches[name] != n0 + 1:
                                fail(f"gather_dot H={H}: not one launch")
                            torch.cuda.synchronize()
                            for h in range(H):
                                ref = hy.residual_gather_dot_plain(
                                    a[h], bt[h], t["rows"], t["gids"],
                                    member)
                                rel = max_rel(got[h], ref)
                                worst_rel = max(worst_rel, rel)
                                worst_abs = max(worst_abs, float(
                                    (got[h] - ref).abs().max()))
                                if not rel <= GATHER_REL_TOL:
                                    fail(f"gather_dot G={G} C={C} {adt}/"
                                         f"{bdt} H={H} {lst} entries, "
                                         f"{'plan' if plan else 'no plan'}"
                                         f": max rel {rel:.3e} vs plain > "
                                         f"{GATHER_REL_TOL}")
                            cases += 1
    return worst_rel, worst_abs, cases


def softmax_case(torch, rng, heads):
    """Rows of 0..700 entries (every 7th empty, row 3 with 200,000):
    (row_ptr, inv_idx into packed scores with spare slots, packed scores
    (heads, F))."""
    import numpy as np
    m = 20000
    deg = rng.integers(0, 700, m)
    deg[::7] = 0
    deg[3] = 200000
    row_ptr = np.r_[0, np.cumsum(deg)]
    nnz = int(row_ptr[-1])
    inv = rng.permutation(nnz + 5000)[:nnz]
    flat = torch.tensor(rng.standard_normal((heads, nnz + 5000)) * 4,
                        dtype=torch.float32, device=DEVICE)
    return (torch.tensor(row_ptr, device=DEVICE),
            torch.tensor(inv, dtype=torch.int32, device=DEVICE), flat)


def check_softmax(torch, sm, rng):
    """The segment softmax kernel against its plain version, from packed
    scores through inv_idx and from CSR-order scores, at SOFTMAX_HEADS.
    Returns (max |kernel - plain| / plain, max abs)."""
    worst_rel = worst_abs = 0.0
    for heads in SOFTMAX_HEADS:
        row_ptr, inv, flat = softmax_case(torch, rng, heads)
        for packed in (True, False):
            x, idx = ((flat, inv) if packed
                      else (flat[:, inv.long()].contiguous(), None))
            got = sm.segment_softmax_torch(x, row_ptr, 0.125, idx)
            want = sm.segment_softmax_plain(x, row_ptr, 0.125, idx)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want).max())
            worst_rel = max(worst_rel, rel)
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            if not rel <= SOFTMAX_REL_TOL:
                fail(f"segment_softmax H={heads} "
                     f"{'packed' if packed else 'CSR order'}: max rel "
                     f"{rel:.3e} vs plain > {SOFTMAX_REL_TOL}")
        del row_ptr, inv, flat
    return worst_rel, worst_abs


def check_spmm(torch, sp, rng):
    """The SpMM kernel against its plain version on random CSR patterns:
    every 7th row empty, row 3 with 200,000 entries, sorted rows at K=64
    and 128, unsorted (sorted by the wrapper) at K=8.  Returns the worst
    (max abs err / sum |terms|, max abs err)."""
    import numpy as np
    worst_rel = worst_abs = 0.0
    m, n = 20000, 30000
    for K in SPMM_K:
        deg = rng.integers(0, 40, m)
        deg[::7] = 0
        deg[3] = 200000
        rows = np.repeat(np.arange(m), deg)
        if K == 8:
            rows = rng.permutation(rows)
        nnz = len(rows)
        r = torch.tensor(rows, device=DEVICE)
        c = torch.tensor(rng.integers(0, n, nnz), dtype=torch.int32,
                         device=DEVICE)
        v = torch.tensor(rng.standard_normal(nnz), dtype=torch.float32,
                         device=DEVICE)
        d = torch.tensor(rng.standard_normal((n, K)), dtype=torch.float32,
                         device=DEVICE)
        got = sp.csr_spmm_torch(v, r, c, d, m)
        want = sp.csr_spmm_plain(v, r, c, d, m)
        scale = sp.csr_spmm_plain(v.abs(), r, c, d.abs(), m)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = float((err / scale.clamp_min(1e-30)).max())
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, float(err.max()))
        if bool(got[torch.tensor(deg == 0, device=DEVICE)].any()):
            fail(f"csr_spmm K={K}: an empty row is not exact zeros")
        if not rel <= SPMM_REL_TOL:
            fail(f"csr_spmm K={K} ({nnz} entries): max abs err / sum |terms|"
                 f" {rel:.3e} vs plain > {SPMM_REL_TOL}")
    return worst_rel, worst_abs


def graph_reference(torch, x, params, adj, chunk=1 << 18):
    """Graph attention in fp64, edge by edge: the scores gathered in
    chunks, a row softmax, an index_add_ aggregation."""
    import numpy as np
    x = x.double()
    q, k, v = (x @ w.double() for w in params)
    rows = torch.as_tensor(adj.row_indices(), device=x.device)
    cols = torch.as_tensor(adj.col_idx, dtype=torch.int64, device=x.device)
    scores = torch.empty(adj.nnz, dtype=torch.float64, device=x.device)
    for s in range(0, adj.nnz, chunk):
        e = slice(s, s + chunk)
        scores[e] = (q[rows[e]] * k[cols[e]]).sum(dim=1)
    scores /= np.sqrt(q.shape[1])
    row_max = torch.full((adj.m,), -torch.inf, dtype=torch.float64,
                         device=x.device).scatter_reduce(0, rows, scores,
                                                         "amax")
    ex = torch.exp(scores - row_max[rows])
    denom = torch.zeros(adj.m, dtype=torch.float64,
                        device=x.device).index_add_(0, rows, ex)
    attn = ex / denom[rows]
    out = torch.zeros((adj.m, v.shape[1]), dtype=torch.float64,
                      device=x.device)
    for s in range(0, adj.nnz, chunk):
        e = slice(s, s + chunk)
        out.index_add_(0, rows[e], v[cols[e]] * attn[e, None])
    return out


def check_model(torch, label, model, x, golden_fn):
    """One model's forward with the kernels against its fp64 reference
    (under the contract) and against the same forward with every kernel's
    plain version.  Returns the check result and the max rel vs plain."""
    from sddmm_tpu_torch.utils.check import check_values
    with torch.inference_mode():
        got = model(x)
        plain = model(x, plain=True)
        torch.cuda.synchronize()
        golden = golden_fn()
    if tuple(got.shape) != tuple(golden.shape) or not bool(
            torch.isfinite(got).all()):
        fail(f"{label}: output {tuple(got.shape)} (want "
             f"{tuple(golden.shape)}) or non-finite values")
    res = check_values(golden.cpu().numpy(), got.cpu().numpy())
    vs_plain = check_values(plain.cpu().numpy(), got.cpu().numpy())
    rel_plain = float((got - plain).abs().max() / plain.abs().max())
    say(f"[models] {label} vs fp64 reference: {res}; vs plain versions: "
        f"{vs_plain}, max abs diff / max |plain| {rel_plain:.3e}")
    if not res.passed or res.num_errors:
        fail(f"{label}: {res.num_errors} values outside the contract")
    if vs_plain.num_errors or not rel_plain <= MODEL_PLAIN_TOL:
        fail(f"{label}: max abs diff / max |plain| {rel_plain:.3e} vs its "
             f"plain versions > {MODEL_PLAIN_TOL}")
    return res, rel_plain


def time_model(torch, label, model, x, card):
    """The forward's median time with the kernels and with the plain
    versions (CUDA events): (ms, plain ms)."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    with torch.inference_mode():
        tk = cuda_time_ms(lambda: model(x), MODEL_ITERS, warmup=2)
        tp = cuda_time_ms(lambda: model(x, plain=True), MODEL_PLAIN_ITERS,
                          warmup=1)
    say(f"[time] {label} forward: kernels median {tk['median_ms']:.4f} ms "
        f"(min {tk['min_ms']:.4f}, max {tk['max_ms']:.4f}, n {tk['n']}), "
        f"plain versions median {tp['median_ms']:.4f} ms (n {tp['n']}) on "
        f"{card}")
    return tk["median_ms"], tp["median_ms"]


def bound_times(nbytes, flops, peak):
    """A call's bound as {"bytes_ms", "ops_ms"}: its bytes over the card's
    memory rate and its operations over ``peak``."""
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / peak * 1e3}


def time_spmm(torch, sp, label, agg, d, card):
    """The SpMM kernel against its plain version at one model's shapes
    (its aggregation's CSR and plan, random positive weights, V of width
    ``d``), beside ``torch.sparse.mm`` on a CSR tensor: the record's
    numbers."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    g = torch.Generator(device=DEVICE).manual_seed(0)
    nnz = agg.cols.shape[0]
    w = torch.rand(nnz, generator=g, device=DEVICE)
    v = torch.rand((agg.num_rows, d), generator=g, device=DEVICE)

    def kernel():
        return sp.csr_spmm_torch(w, agg.rows, agg.cols, v, agg.num_rows,
                                 row_ptr=agg.row_ptr, plan=agg.plan)

    def plain():
        return sp.csr_spmm_plain(w, agg.rows, agg.cols, v, agg.num_rows)

    s_csr = torch.sparse_csr_tensor(agg.row_ptr, agg.cols.long(), w,
                                    size=(agg.num_rows, agg.num_rows))
    got, want = kernel(), plain()
    lib = torch.sparse.mm(s_csr, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = max_rel(got[want > 0], want[want > 0])  # = err / sum |terms|
    if not rel <= SPMM_REL_TOL:
        fail(f"{label} csr_spmm at the model's shapes: max rel {rel:.3e} "
             "vs plain")
    if not max_rel(lib[want > 0], want[want > 0]) <= SPMM_REL_TOL:
        fail(f"{label}: torch.sparse.mm does not compute the same function")
    del got, want, lib
    tk = cuda_time_ms(kernel, 20)
    tp = cuda_time_ms(plain, 5)
    tl = cuda_time_ms(lambda: torch.sparse.mm(s_csr, v), 20)
    used = int(torch.unique(agg.cols).numel())
    nbytes = (8 * (agg.num_rows + 1) + 8 * nnz + 4 * used * d
              + 4 * agg.num_rows * d)
    bnd = bound_times(nbytes, 2.0 * nnz * d, FP32_FLOPS)
    gathered = 4.0 * nnz * d
    say(f"[time] {label} {_kernels.SPMM_ENTRY} ({nnz} entries, K={d}, max "
        f"rel vs plain {rel:.3e}): kernel {tk['median_ms']:.4f} ms, plain "
        f"{tp['median_ms']:.4f} ms, torch.sparse.mm {tl['median_ms']:.4f} "
        f"ms, bound {max(bnd.values()):.4f} ms ({nbytes / 1e6:.1f} MB read "
        f"once + written once); gathered V rows {gathered / 1e9:.2f} GB = "
        f"{gathered / tk['median_ms'] / 1e9:.2f} TB/s of L2/L1 reads on "
        f"{card}")
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl["median_ms"], **bnd}


def time_softmax(torch, sm, label, model, d, card):
    """The segment softmax kernel against its plain version at one model's
    shapes (its heads, pattern and packing; N(0, 16) packed scores, scale
    1/sqrt(d)), beside ``torch.sparse.softmax`` on a COO tensor of the same
    scaled scores (the heads' block-diagonal pattern): the record's
    numbers."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    agg, runner = model._agg, model.runner
    heads = agg.heads
    g = torch.Generator(device=DEVICE).manual_seed(0)
    flat = torch.randn((heads, runner.packed.packed_size), generator=g,
                       device=DEVICE) * 4
    inv, scale = runner.inv_idx32, 1.0 / d ** 0.5

    def kernel():
        return sm.segment_softmax_torch(flat, agg.head_row_ptr, scale, inv,
                                        agg.long_rows)

    def plain():
        return sm.segment_softmax_plain(flat, agg.head_row_ptr, scale, inv)

    got, want = kernel(), plain()
    vals = (flat[:, inv.long()] * scale).reshape(-1)
    coo = torch.sparse_coo_tensor(
        torch.stack([agg.rows, agg.cols.long()]), vals,
        size=(agg.num_rows, agg.num_rows)).coalesce()
    lib = torch.sparse.softmax(coo, dim=1)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want).max())
    if not rel <= SOFTMAX_REL_TOL:
        fail(f"{label} segment softmax at the model's shapes: max rel "
             f"{rel:.3e} vs plain")
    if not float(((lib.values() - want.reshape(-1)).abs()
                  / want.reshape(-1)).max()) <= SOFTMAX_REL_TOL:
        fail(f"{label}: torch.sparse.softmax does not compute the same "
             "function")
    err = float((got - want).abs().max())
    del got, want, lib
    tk = cuda_time_ms(kernel, 20)
    tp = cuda_time_ms(plain, 5)
    tl = cuda_time_ms(lambda: torch.sparse.softmax(coo, dim=1), 20)
    nnz = inv.numel()
    nbytes = 8 * heads * nnz + 4 * nnz + 8 * agg.head_row_ptr.numel()
    bnd = bound_times(nbytes, 5.0 * heads * nnz, FP32_FLOPS)
    say(f"[time] {label} {_kernels.SOFTMAX_ENTRY} ({heads} heads x {nnz} "
        f"entries, max rel vs plain {rel:.3e}): kernel "
        f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms, "
        f"torch.sparse.softmax {tl['median_ms']:.4f} ms, bound "
        f"{max(bnd.values()):.4f} ms ({nbytes / 1e6:.1f} MB read once + "
        f"written once) = {100 * max(bnd.values()) / tk['median_ms']:.1f} % "
        f"of it on {card}")
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl["median_ms"], **bnd}


def run_models(torch, sp, sm, card, adj):
    """Phase 9 on the clustered16 adjacency ``adj``: returns the launch
    counts of the models' forwards, and the records of the SpMM and of the
    segment softmax at the models' shapes, summed over the two models."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.entry import entry
    from sddmm_tpu_torch.models import (BlockSparseAttention,
                                        GraphAttentionLayer,
                                        dense_reference_attention,
                                        make_attention_mask)
    lf = LONGFORMER
    models = {}
    t0 = time.perf_counter()
    graph = GraphAttentionLayer(adj, GRAPH_WIDTH, GRAPH_WIDTH, device=DEVICE)
    models["graph attention"] = (graph, time.perf_counter() - t0)
    t0 = time.perf_counter()
    mask = make_attention_mask(lf["seq_len"], window=lf["window"],
                               num_global=lf["num_global"])
    block = BlockSparseAttention(mask, lf["hidden"], lf["heads"],
                                 lf["head_dim"], device=DEVICE)
    models["block-sparse attention"] = (block, time.perf_counter() - t0)
    fn, (x_entry,) = entry(DEVICE)
    models["entry"] = (fn.layer, None)
    for label, (model, secs) in models.items():
        p = model.runner.packed
        say(f"[pack] {label}: {p.m}x{p.n} nnz {p.nnz} packed "
            f"{p.packed_size} slots, super/quad/pair/group {p.num_super}/"
            f"{p.num_quads}/{p.num_pairs}/{p.num_groups}, hub {p.hub_cols}, "
            f"hot rows {p.rowslab_nrows}, residual {p.nnz_res}"
            + (f": {secs:.1f} s to pack" if secs is not None else ""))
    graph.init(torch.Generator().manual_seed(0))
    block.init(torch.Generator().manual_seed(1))
    x_graph = torch.as_tensor(generate.make_dense(adj.m, GRAPH_WIDTH,
                                                  seed=1), device=DEVICE)
    x_block = torch.as_tensor(generate.make_dense(lf["seq_len"],
                                                  lf["hidden"], seed=3),
                              device=DEVICE)
    runs = {"graph attention": lambda: graph(x_graph),
            "block-sparse attention": lambda: block(x_block),
            "entry": lambda: fn(x_entry)}

    # this slice's main path: the counts zeroed just before, read just after
    _kernels.launches.clear()
    per_model = {}
    with torch.inference_mode():
        for label, run in runs.items():
            before = dict(_kernels.launches)
            run()
            per_model[label] = {n: c - before.get(n, 0)
                                for n, c in _kernels.launches.items()
                                if c > before.get(n, 0)}
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    say(f"[models] launches during the models' forwards: {counts}")
    for label, got in per_model.items():
        say(f"[models] {label} launches: {got}")
        model = models[label][0]
        # one launch of each kernel for all heads
        want = {"sddmm_tile_dot_float32": 1, _kernels.SPMM_ENTRY: 1,
                _kernels.SOFTMAX_ENTRY: 1}
        if model.runner.packed.nnz_res:
            want["sddmm_gather_dot_float32_float32"] = 1
        if got != want:
            fail(f"{label}: launches {got}, want {want}")

    check_model(torch, "graph attention (clustered16, F=D=128)", graph,
                x_graph, lambda: graph_reference(torch, x_graph,
                                                 graph.params(), adj))
    check_model(torch, "block-sparse attention (Longformer-base shape)",
                block, x_block, lambda: dense_reference_attention(
                    block.params(), x_block, mask))
    check_model(torch, "entry (128 nodes, F=D=32)", fn.layer, x_entry,
                lambda: graph_reference(torch, x_entry, fn.layer.params(),
                                        fn.layer.adj))
    time_model(torch, "graph attention", graph, x_graph, card)
    time_model(torch, "block-sparse attention", block, x_block, card)
    rec = {_kernels.SPMM_ENTRY: new_record(0.0),
           _kernels.SOFTMAX_ENTRY: new_record(0.0)}
    for label, model, d in (("graph attention", graph, GRAPH_WIDTH),
                            ("block-sparse attention", block,
                             lf["head_dim"])):
        add_times(rec, {_kernels.SPMM_ENTRY: time_spmm(
            torch, sp, label, model._agg, d, card)})
        add_times(rec, {_kernels.SOFTMAX_ENTRY: time_softmax(
            torch, sm, label, model, d, card)})
    return counts, rec


def gather_name(runner):
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops.tile_dot import STORAGE
    return _kernels.gather_dot_entry(*STORAGE[runner.compute_dtype])


def gather_pair_names():
    from sddmm_tpu_torch.ops.hybrid import GATHER_STORAGE
    return [f"{str(a).removeprefix('torch.')}/{str(b).removeprefix('torch.')}"
            for a, b in GATHER_STORAGE]


def tile_work(runner, ops):
    """Bytes (operands and index arrays read once, output slots written
    once) and bf16 tensor-core operations of one call's tile launch."""
    from sddmm_tpu_torch.ops.tile_dot import MODES
    table = runner.table
    ent = table.entries.cpu()
    cells = int((ent[:, 1] * ent[:, 4]).sum())
    a, b = (runner.residual_call(*ops)[:2] if hasattr(runner, "packed")
            else ops)
    nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
              + 8 * ent.numel() + 4 * table.row_ids.numel()
              + 4 * table.gids.numel() + 4 * cells)
    flops = 2.0 * cells * a.shape[-1] * len(MODES[runner.compute_dtype][4])
    return nbytes, flops


def kernel_pass(torch, td, runner, ops, timing_iters, label, card):
    """Each kernel of one call at the main path's shapes against its plain
    version, then timed beside it and beside one PyTorch library call:
    {kernel: {"err", "ms", "plain_ms", "library_ms", "bytes_ms",
    "ops_ms"}}."""
    from sddmm_tpu_torch.ops import hybrid as hy
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    mode = runner.compute_dtype
    tname = f"sddmm_tile_dot_{mode}"
    dense = not hasattr(runner, "packed")
    size = ((runner.m, runner.n) if dense else (runner.packed.packed_size,))
    flat_k = torch.empty(size, device=DEVICE)
    flat_p = torch.empty(size, device=DEVICE)
    runner.run_tiles(*ops, flat_k)
    runner.run_tiles(*ops, flat_p, plain=True)
    torch.cuda.synchronize()
    n_tile = flat_k.numel() - (0 if dense else runner.packed.nnz_res)
    got, ref = flat_k.reshape(-1)[:n_tile], flat_p.reshape(-1)[:n_tile]
    rel = max_rel(got, ref)
    if not rel <= TILE_REL_TOL:
        fail(f"{label} {tname} (one launch) at the path's shapes: max rel "
             f"{rel:.3e} vs the per-segment plain route")
    tk = cuda_time_ms(lambda: runner.run_tiles(*ops, flat_k), timing_iters)
    tp = cuda_time_ms(lambda: runner.run_tiles(*ops, flat_p, plain=True),
                      timing_iters)
    # the yardstick: torch.bmm in full fp32 on the per-segment route's
    # tiles, gathered beforehand (the gathers are not timed)
    tiles = [(a.float().contiguous(), b.float().contiguous())
             for a, b, _, _ in runner.tile_calls(*ops, flat_p)]
    with td.full_fp32_matmul():
        tl = cuda_time_ms(lambda: [torch.bmm(a, b.transpose(1, 2))
                                   for a, b in tiles], timing_iters)
    del tiles
    nbytes, flops = tile_work(runner, ops)
    bnd = bound_times(nbytes, flops, BF16_FLOPS)
    out = {tname: {"err": float((got - ref).abs().max()),
                   "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
                   "library_ms": tl["median_ms"], **bnd}}
    say(f"[time] {label} {tname} (1 launch, {runner.table.n_entries} "
        f"entries; max rel vs the per-segment plain route {rel:.3e}): "
        f"kernel {tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms, "
        f"torch.bmm fp32 on gathered tiles {tl['median_ms']:.4f} ms; bound "
        f"{max(bnd.values()):.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP bf16) = "
        f"{100 * max(bnd.values()) / tk['median_ms']:.1f} % of it on {card}")
    del flat_k, flat_p
    if dense or not runner.packed.nnz_res:
        return out
    gname = gather_name(runner)
    residual = runner.residual_call(*ops)
    plan = runner.res_plan
    res_out = hy.residual_gather_dot(*residual, plan=plan)
    ref = hy.residual_gather_dot_plain(*residual)
    torch.cuda.synchronize()
    rel = max_rel(res_out, ref)
    if not rel <= GATHER_REL_TOL:
        fail(f"{label} {gname}: max rel {rel:.3e} vs plain")
    tk = cuda_time_ms(lambda: hy.residual_gather_dot(*residual, out=res_out,
                                                     plan=plan),
                      timing_iters)
    tp = cuda_time_ms(lambda: hy.residual_gather_dot_plain(*residual),
                      timing_iters)
    a_pad, bt_phys, rows, gids, member = residual
    G = runner.packed.group_size
    lanes = gids.long() * G + (member.long() if member is not None else 0)
    lib_ms = None
    if a_pad.dtype == bt_phys.dtype == torch.float32 and bt_phys.shape[0] == 1:
        lib_ms = sampled_addmm_ms(torch, a_pad, bt_phys[0].reshape(
            -1, a_pad.shape[1]), rows, lanes, timing_iters)
    n, K = rows.numel(), a_pad.shape[1]
    nbytes = (int(torch.unique(rows).numel()) * K * a_pad.element_size()
              + int(torch.unique(lanes).numel()) * K
              * bt_phys.element_size() + 12 * n + 4 * n)
    bnd = bound_times(nbytes, 2.0 * n * K, FP32_FLOPS)
    out[gname] = {"err": float((res_out - ref).abs().max()),
                  "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
                  "library_ms": lib_ms, **bnd}
    say(f"[time] {label} {gname} ({n} entries, plan of "
        f"{plan.group_rows} rows a group, max rel vs plain "
        f"{rel:.3e}): kernel {tk['median_ms']:.4f} ms, plain "
        f"{tp['median_ms']:.4f} ms, sampled_addmm "
        + (f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a")
        + f", bound {max(bnd.values()):.4f} ms on {card}")
    return out


def sampled_addmm_ms(torch, a, bt, rows, cols, iters):
    """Median ms of ``torch.sparse.sampled_addmm`` in fp32 at the entries
    (rows[i], cols[i]) of a x bt^T (the CSR built, and checked against
    the fp64 dots of a few entries, beforehand)."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    order = torch.argsort(rows.long() * bt.shape[0] + cols.long())
    r, c = rows.long()[order], cols.long()[order]
    crow = torch.searchsorted(r, torch.arange(a.shape[0] + 1,
                                              device=r.device))
    s = torch.sparse_csr_tensor(crow, c, torch.zeros(r.numel(),
                                                     device=r.device),
                                size=(a.shape[0], bt.shape[0]))
    mat2 = bt.T
    got = torch.sparse.sampled_addmm(s, a, mat2, beta=0.0)
    k = min(1000, r.numel())
    want = (a[r[:k]].double() * bt[c[:k]].double()).sum(dim=1)
    if not float(((got.values()[:k].double() - want).abs()
                  / want.abs().clamp_min(1e-30)).max()) <= 1e-3:
        fail("torch.sparse.sampled_addmm does not compute the same function")
    return cuda_time_ms(lambda: torch.sparse.sampled_addmm(
        s, a, mat2, beta=0.0), iters)["median_ms"]


def add_times(rec, times, with_ms=True):
    """Fold kernel_pass's numbers into the record: every max abs error,
    and the times and bounds only ``with_ms``; a library time that is
    missing for one call leaves the sum null."""
    for kname, t in times.items():
        r = rec[kname]
        r["max_abs_err"] = max(r["max_abs_err"], t["err"])
        if with_ms:
            for key in ("ms", "plain_ms", "bytes_ms", "ops_ms"):
                r[key] += t[key]
            r["bound_ms"] += max(t["bytes_ms"], t["ops_ms"])
            r["library_ms"] = (None if r["library_ms"] is None
                               or t["library_ms"] is None
                               else r["library_ms"] + t["library_ms"])


def record_entry(name, source, replaces, launches, path, r):
    """One kernel's entry of the JSON line: the measured numbers, the bound
    with what sets it, and the share of the bound reached."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bytes_ms"] >= r["ops_ms"]
                         else "operations"),
            "share_of_bound": r["bound_ms"] / r["ms"] if r["ms"] else None,
            "library_ms": r["library_ms"]}


def new_record(err):
    return {"max_abs_err": err, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0,
            "ops_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}


def main() -> None:
    if not (ROOT / "sddmm_tpu_torch" / "__init__.py").is_file() or not (
            ROOT / "results" / "tuned_configs.json").is_file():
        fail(f"{ROOT} is not a checkout of the repo (sddmm_tpu_torch/ and "
             "results/tuned_configs.json are missing)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    t_start = time.perf_counter()
    # -- 1. device --
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind}; count {torch.cuda.device_count()}")
    say("[device] nvidia-smi --query-gpu=name,power.limit "
        "--format=csv,noheader:")
    say(card)

    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops import hybrid as hy
    from sddmm_tpu_torch.ops import softmax as sm
    from sddmm_tpu_torch.ops import spmm as sp
    from sddmm_tpu_torch.ops import tile_dot as td
    from sddmm_tpu_torch.ops.batch import batched_csr_sddmm
    from sddmm_tpu_torch.ops.csr_sddmm import csr_plan, csr_sddmm_torch
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.reference import sddmm_reference
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    from sddmm_tpu_torch.data import generate

    # -- 2. build --
    with Phase("build"):
        t0 = time.perf_counter()
        _kernels.load()
        say(f"[build] nvcc sm_90a {_kernels.lib_path().name}: "
            f"{time.perf_counter() - t0:.1f} s")
        for line in _kernels.build_log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {line.strip()}")

    # -- 3./4. kernels against their plain versions --
    rng = np.random.default_rng(0)
    with Phase("tile kernel instances vs plain"):
        worst, n_shapes = check_tile_dot(torch, td, rng)
        for mode, (rel, ab) in worst.items():
            say(f"[tile_dot] {mode}: {n_shapes // len(worst)} shapes (R in "
                "16..128 and 37, L in 128/150/384, K 32/128/256, nT=37; "
                "slab shapes; strided unaligned out; C=2 accumulate; K 8 "
                "and 24, and C=2 at K=24): max "
                f"rel vs plain {rel:.3e} (tol {TILE_REL_TOL}), max abs "
                f"{ab:.3e}"
                + ("; fp64 contract ok" if mode in ("tf32", "float32")
                   else ""))
    with Phase("float32 instance vs fp64, beside tf32"):
        f32 = check_float32_precision(torch, td, rng)
        say("[float32] worst max abs err / min |exact| vs fp64 (float32 "
            f"tol {F32_EXACT_REL}): " + ", ".join(
                f"{data} {mode} {err:.3e}"
                for (data, mode), err in f32.items()))
    with Phase("gather-dot vs plain"):
        rel2, abs2, n_cases = check_gather_dot(torch, hy, rng)
        say(f"[gather_dot] {n_cases} cases: G in (1, 2, 4), C in (1, 2), "
            f"storage {', '.join(gather_pair_names())}, H in (1, 3) in one "
            "launch; 65536 random entries in their order, clustered "
            "entries sorted and unsorted with a plan (8 rows a group) and "
            f"without: max rel vs plain {rel2:.3e} (tol {GATHER_REL_TOL}), "
            f"max abs {abs2:.3e}")
    with Phase("SpMM kernel vs plain"):
        rel3, abs3 = check_spmm(torch, sp, rng)
        say(f"[spmm] 20000 rows (every 7th empty, row 3 with 200000 "
            f"entries), K in {SPMM_K}, K=8 unsorted: max abs err / sum "
            f"|terms| vs plain {rel3:.3e} (tol {SPMM_REL_TOL}), max abs "
            f"{abs3:.3e}; empty rows exact zeros")
    with Phase("segment softmax vs plain"):
        rel4, abs4 = check_softmax(torch, sm, rng)
        say(f"[softmax] 20000 rows (every 7th empty, row 3 with 200000 "
            f"entries), H in {SOFTMAX_HEADS}, packed scores through inv_idx "
            "and CSR-order scores: max |kernel - plain| / plain "
            f"{rel4:.3e} (tol {SOFTMAX_REL_TOL}), max abs {abs4:.3e}")

    # every kernel instance's record; "launches" is from the named path
    rec = {f"sddmm_tile_dot_{m}": new_record(worst[m][1]) for m in td.MODES}
    for pair in hy.GATHER_STORAGE:
        rec[_kernels.gather_dot_entry(*pair)] = new_record(abs2)

    # -- 5. the main path at full scale --
    configs = json.loads((ROOT / "results" / "tuned_configs.json")
                         .read_text())
    gens = suite()
    csrs = {}
    cells = {}
    packs = {}
    with Phase("pack the main path's cells"):
        for name, k in CELLS:
            t0 = time.perf_counter()
            if name not in csrs:
                csrs[name] = gens[name]()
            csr = csrs[name]
            cfg = configs[f"k{k}"][name]
            label = f"{name}@K{k}"
            if cfg.get("dense"):
                runner = DenseSDDMM.from_csr(
                    csr, compute_dtype=cfg.get("dtype", "tf32"),
                    device=DEVICE)
                desc = f"DenseSDDMM {csr.m}x{csr.n}"
            else:
                t = tuned(csr, k, cfg)
                runner = hybrid_runner(t.packed, t, cfg.get("dtype", "tf32"))
                packs[(name, k)] = (t.packed, t)
                p = t.packed
                desc = (f"packed {p.packed_size} G={p.group_size} "
                        f"C={t.k_chunks} super/quad/pair/group "
                        f"{p.num_super}/{p.num_quads}/{p.num_pairs}/"
                        f"{p.num_groups} hub {p.hub_cols} hot rows "
                        f"{p.rowslab_nrows} residual {p.nnz_res} a_layout "
                        f"{t.a_layout}")
            a = generate.make_dense(csr.m, k, seed=1)
            b = generate.make_dense(k, csr.n, seed=2)
            ops = runner.prepare_operands(a, b=b)
            say(f"[pack] {label}: {csr.m}x{csr.n} nnz {csr.nnz} {desc}: "
                f"{time.perf_counter() - t0:.1f} s")
            cells[(name, k)] = (csr, runner, ops, a, b)

    with Phase("main path"):
        _kernels.launches.clear()
        outs, per_cell = {}, {}
        for key, (_, runner, ops, _, _) in cells.items():
            before = dict(_kernels.launches)
            outs[key] = runner.run_padded(*ops, order="csr")
            per_cell[key] = {n: c - before.get(n, 0)
                             for n, c in _kernels.launches.items()
                             if c > before.get(n, 0)}
        torch.cuda.synchronize()
        main_launches = dict(_kernels.launches)
    say(f"[main] launches during the main path: {main_launches}")
    for (name, k), counts in per_cell.items():
        say(f"[main] {name}@K{k} launches: {counts}")
        runner = cells[(name, k)][1]
        # one tile launch a call; one gather-dot launch for a residual
        want = {"sddmm_tile_dot_tf32": 1}
        if hasattr(runner, "packed") and runner.packed.nnz_res:
            want["sddmm_gather_dot_float32_float32"] = 1
        if counts != want:
            fail(f"{name}@K{k}: launches {counts}, want {want}")
    for kname in ("sddmm_tile_dot_tf32", "sddmm_gather_dot_float32_float32"):
        if not main_launches.get(kname):
            fail(f"{kname} was not launched by the main path")

    goldens = {}
    with Phase("check the main path against the fp64 golden"):
        for (name, k), (csr, runner, ops, a, b) in cells.items():
            got = outs[(name, k)].cpu().numpy()
            if got.shape != (csr.nnz,) or not np.isfinite(got).all():
                fail(f"{name}@K{k}: output shape {got.shape} or non-finite "
                     "values")
            goldens[(name, k)] = sddmm_reference(a, b, csr)
            res = check_values(goldens[(name, k)], got)
            say(f"[check] {name}@K{k} CSR order vs fp64 golden: {res}")
            if not res.passed or res.num_errors:
                fail(f"{name}@K{k}: {res.num_errors} values outside the "
                     "contract")
    del outs

    # -- 6. per-kernel checks and timing --
    call_ms = {}
    with Phase("time the main path"):
        for (name, k), (csr, runner, ops, _, _) in cells.items():
            label = f"{name}@K{k}"
            iters = TIMING_ITERS.get(k, SHORT_ITERS)
            flops = 2.0 * csr.nnz * k
            tm = {}
            for lab, fn in (
                    ("packed, kernels", lambda: runner.run_padded(*ops)),
                    ("packed, plain versions",
                     lambda: runner.run_padded(*ops, plain=True)),
                    ("CSR order, kernels",
                     lambda: runner.run_padded(*ops, order="csr"))):
                tm[lab] = cuda_time_ms(fn, iters)
                ms = tm[lab]["median_ms"]
                say(f"[time] {label} {lab}: median {ms:.4f} ms (min "
                    f"{tm[lab]['min_ms']:.4f}, max {tm[lab]['max_ms']:.4f}, "
                    f"n {tm[lab]['n']}) = {flops / ms / 1e6:.1f} GFLOPS on "
                    f"{card}")
            call_ms[(name, k)] = tm
            # the record's times sum the K=128 cells, one call each
            add_times(rec, kernel_pass(torch, td, runner, ops, iters, label,
                                       card), with_ms=k == 128)

    # -- 7. the CSR baseline on each K=128 cell --
    with Phase("CSR baseline"):
        base_in, base_plan = {}, {}
        for (name, k), (csr, _, _, a, b) in cells.items():
            if k != 128:
                continue
            base_in[name] = (
                torch.as_tensor(a, device=DEVICE),
                torch.as_tensor(np.ascontiguousarray(b.T), device=DEVICE),
                torch.as_tensor(csr.row_indices(), dtype=torch.int32,
                                device=DEVICE),
                torch.as_tensor(csr.col_idx, dtype=torch.int32,
                                device=DEVICE))
            t0 = time.perf_counter()
            plan = csr_plan(csr)
            secs = time.perf_counter() - t0
            base_plan[name] = plan.to(DEVICE)
            say(f"[plan] {name}@K128 CSR baseline: {secs:.2f} s on the host"
                f": {plan.group_rows} rows a group"
                + (f", {len(plan.groups)} groups, {len(plan.items)} items "
                   f"for {csr.nnz} entries, {len(plan.tasks)} tasks"
                   if plan.grouped else " (the entry-order walk)"))
        _kernels.launches.clear()
        base_out = {name: csr_sddmm_torch(*args, plan=base_plan[name])
                    for name, args in base_in.items()}
        torch.cuda.synchronize()
        csr_launches = _kernels.launches["sddmm_gather_dot_float32_float32"]
        if csr_launches != len(base_in):
            fail(f"the CSR baseline launched the gather-dot kernel "
                 f"{csr_launches} times for {len(base_in)} cells")
        base_rec = new_record(0.0)
        for name, args in base_in.items():
            res = check_values(goldens[(name, 128)],
                               base_out[name].cpu().numpy())
            say(f"[check] {name}@K128 CSR baseline vs fp64 golden: {res}")
            if not res.passed or res.num_errors:
                fail(f"{name}: CSR baseline has {res.num_errors} values "
                     "outside the contract")
            ref = hy.residual_gather_dot_plain(*args)
            tk = cuda_time_ms(lambda: csr_sddmm_torch(
                *args, plan=base_plan[name]), 20)
            tp = cuda_time_ms(lambda: hy.residual_gather_dot_plain(*args), 20)
            a_t, bt_t, rows, cols = args
            lib = sampled_addmm_ms(torch, a_t, bt_t, rows, cols, 20)
            n, K = rows.numel(), a_t.shape[1]
            nbytes = 4 * K * (int(torch.unique(rows).numel())
                              + int(torch.unique(cols).numel())) + 12 * n
            bnd = bound_times(nbytes, 2.0 * n * K, FP32_FLOPS)
            add_times({"base": base_rec}, {"base": {
                "err": float((base_out[name] - ref).abs().max()),
                "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
                "library_ms": lib, **bnd}})
            tm = call_ms[(name, 128)]
            packed = tm["packed, kernels"]["median_ms"]
            in_csr = tm["CSR order, kernels"]["median_ms"]
            say(f"[time] {name}@K128 CSR baseline: kernel "
                f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms, "
                f"sampled_addmm {lib:.4f} ms, bound "
                f"{max(bnd.values()):.4f} ms; hybrid speed-up over it: packed "
                f"{tk['median_ms'] / packed:.3f}x, CSR order "
                f"{tk['median_ms'] / in_csr:.3f}x on {card}")
        del base_in, base_out
        # the batched CSR SDDMM: one launch for a batch of 2
        csr, _, _, a, b = cells[("clustered16", 128)]
        a2 = np.stack([a, a[::-1]])
        b2 = np.stack([b, b[:, ::-1]])
        _kernels.launches.clear()
        got = batched_csr_sddmm(a2, b2, csr, device=DEVICE)
        batch_launches = dict(_kernels.launches)
        if batch_launches != {"sddmm_gather_dot_float32_float32": 1}:
            fail(f"batched_csr_sddmm (batch 2): launches {batch_launches}, "
                 "want one gather-dot launch")
        for i in range(2):
            res = check_values(sddmm_reference(a2[i], b2[i], csr), got[i])
            if not res.passed or res.num_errors:
                fail(f"batched_csr_sddmm element {i}: {res.num_errors} "
                     "values outside the contract")
        say(f"[check] batched_csr_sddmm clustered16@K128, batch 2: "
            f"launches {batch_launches}; each element vs fp64 golden: {res}")

    # -- 8. the five compute modes on banded K=128 --
    mode_launches = {}
    with Phase("compute modes"):
        csr, _, _, a, b = cells[MODES_CELL]
        packed, t = packs[MODES_CELL]
        golden = goldens[MODES_CELL]
        for mode in td.MODES:
            runner = hybrid_runner(packed, t, mode)
            ops = runner.prepare_operands(a, b=b)
            _kernels.launches.clear()
            got = runner.run_padded(*ops, order="csr")
            torch.cuda.synchronize()
            counts = dict(_kernels.launches)
            want = {f"sddmm_tile_dot_{mode}": 1, gather_name(runner): 1}
            if counts != want:
                fail(f"mode {mode}: launches {counts}, want {want}")
            for kname in want:
                mode_launches.setdefault(kname, counts[kname])
            res = check_values(golden, got.cpu().numpy())
            plain = runner.run_padded(*ops, order="csr", plain=True)
            rel_plain = max_rel(got, plain)
            say(f"[modes] banded@K128 {mode} (launches {counts}): vs fp64 "
                f"golden {res}; max rel vs plain versions {rel_plain:.3e}")
            if mode in ("float32", "tf32", "mixed"):
                if not res.passed or res.num_errors:
                    fail(f"mode {mode}: {res.num_errors} values outside the "
                         "contract")
            if not rel_plain <= TILE_REL_TOL:
                fail(f"mode {mode}: max rel {rel_plain:.3e} vs its plain "
                     f"versions > {TILE_REL_TOL}")
            if mode != "tf32":   # timed on the main path already
                add_times(rec, kernel_pass(torch, td, runner, ops, 20,
                                           f"banded@K128[{mode}]", card))

    # -- 9. the models: the serving path of the two attention families --
    with Phase("models"):
        model_launches, model_rec = run_models(
            torch, sp, sm, card, csrs[GRAPH_CELL])
    rec.update(model_rec)
    rec[_kernels.SPMM_ENTRY]["max_abs_err"] = max(
        rec[_kernels.SPMM_ENTRY]["max_abs_err"], abs3)
    rec[_kernels.SOFTMAX_ENTRY]["max_abs_err"] = max(
        rec[_kernels.SOFTMAX_ENTRY]["max_abs_err"], abs4)

    if "jax" in sys.modules:
        fail("jax was imported")
    # each kernel's launches on its path: the SpMM and the "float32" tile
    # instance on the models' forwards, "tf32" and the fp32 gather-dot on
    # the 8 cells, the other instances in the compute modes phase
    paths = {"sddmm_tile_dot_tf32": ("main path (8 cells)", main_launches),
             "sddmm_gather_dot_float32_float32": ("main path (8 cells)",
                                                  main_launches),
             "sddmm_tile_dot_float32": ("models (graph attention, "
                                        "Longformer-shaped block-sparse "
                                        "attention, entry)", model_launches),
             _kernels.SPMM_ENTRY: ("models (graph attention, "
                                   "Longformer-shaped block-sparse "
                                   "attention, entry)", model_launches),
             _kernels.SOFTMAX_ENTRY: ("models (graph attention, "
                                      "Longformer-shaped block-sparse "
                                      "attention, entry)", model_launches)}
    record = []
    for kname, r in rec.items():
        if kname.startswith("sddmm_tile_dot_"):
            source, replaces = ("tile_dot.cu",
                                "sddmm_tpu/ops/pallas_tiles.py:72")
        elif kname == _kernels.SPMM_ENTRY:
            source, replaces = "spmm.cu", "sddmm_tpu/ops/spmm.py:23"
        elif kname == _kernels.SOFTMAX_ENTRY:
            source, replaces = ("segment_softmax.cu",
                                "sddmm_tpu/models/graph_attention.py:30")
        else:
            source, replaces = "gather_dot.cu", "sddmm_tpu/ops/hybrid.py:306"
        path, counts = paths.get(kname, ("compute modes on banded@K128",
                                         mode_launches))
        record.append(record_entry(
            kname, f"sddmm_tpu_torch/csrc/{source}", replaces,
            counts.get(kname, 0), path, r))
    record.append(record_entry(
        "sddmm_gather_dot_float32_float32 (CSR baseline, C=G=1)",
        "sddmm_tpu_torch/csrc/gather_dot.cu",
        "sddmm_tpu/ops/csr_sddmm.py:25", csr_launches,
        "CSR baseline (K=128 cells)", base_rec))
    for r in record:
        if not r["launches"]:
            fail(f"{r['name']} was not launched on its path")
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
