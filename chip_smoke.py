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
   "tf32" must miss 3 * 2^-18 of each product;
4. the residual gather-dot kernel against its plain version at G in
   (1, 2, 4), C in (1, 2) and each storage pair of the compute modes;
5. the main path at full bench scale: every K=128 cell of ``bench.py``'s
   suite (clustered16, clustered128, powerlaw with its hub and hot-row
   slabs, banded, and dlmc through ``DenseSDDMM``) plus clustered16 at K=32
   (G=4), banded at K=64 (G=2) and powerlaw at K=256, generated as
   ``bench.py`` does, packed with the committed
   ``results/tuned_configs.json`` configs, run through the port's runners
   on the card into CSR order and checked against the fp64 golden model;
   the launch counters are zeroed just before this run and read just
   after, per cell, and every kernel of the path must have launched;
6. per cell, each kernel again at the main path's own shapes against its
   plain version; then timing with CUDA events (median of 20 after warm-up
   at K=128, of 5 at the other K): the call with the kernels, with the
   plain versions, and into CSR order, and each kernel's launches of one
   call beside its plain version;
7. the CSR baseline (the gather-dot kernel with C = G = 1) on each K=128
   cell: checked against the golden, timed, and the hybrid's speed-up over
   it on this card;
8. the five compute modes on banded K=128: "float32", "tf32" and "mixed"
   must pass the contract; "float16" and "bfloat16" fail it by design, so
   they are held to their plain versions and their max rel is printed.

It then prints one JSON line with the kernels' record and, last, one JSON
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
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


def check_gather_dot(torch, hy, rng):
    worst_rel = worst_abs = 0.0
    m, ng, nR, K = 4096, 3072, 65536, 128
    for G in (1, 2, 4):
        for C in (1, 2):
            kc = K // C
            for adt, bdt in hy.GATHER_STORAGE:
                a = torch.tensor(rng.uniform(0, 2, (m + 1, K)),
                                 dtype=torch.float32, device=DEVICE).to(adt)
                bt = torch.tensor(rng.uniform(0, 2, (C, ng + 1, G * kc)),
                                  dtype=torch.float32, device=DEVICE).to(bdt)
                rows = torch.tensor(rng.integers(0, m + 1, nR),
                                    dtype=torch.int32, device=DEVICE)
                gids = torch.tensor(rng.integers(0, ng + 1, nR),
                                    dtype=torch.int32, device=DEVICE)
                member = (torch.tensor(rng.integers(0, G, nR),
                                       dtype=torch.int32, device=DEVICE)
                          if G > 1 else None)
                got = hy.residual_gather_dot(a, bt, rows, gids, member)
                ref = hy.residual_gather_dot_plain(a, bt, rows, gids, member)
                torch.cuda.synchronize()
                rel = max_rel(got, ref)
                worst_rel = max(worst_rel, rel)
                worst_abs = max(worst_abs, float((got - ref).abs().max()))
                if not rel <= GATHER_REL_TOL:
                    fail(f"gather_dot G={G} C={C} {adt}/{bdt}: max rel "
                         f"{rel:.3e} vs plain > {GATHER_REL_TOL}")
    return worst_rel, worst_abs


def gather_name(runner):
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops.tile_dot import STORAGE
    return _kernels.gather_dot_entry(*STORAGE[runner.compute_dtype])


def gather_pair_names():
    from sddmm_tpu_torch.ops.hybrid import GATHER_STORAGE
    return [f"{str(a).removeprefix('torch.')}/{str(b).removeprefix('torch.')}"
            for a, b in GATHER_STORAGE]


def kernel_pass(torch, td, runner, ops, timing_iters, label, card):
    """Each kernel of one call at the main path's shapes against its plain
    version, then timed beside it: {kernel: (max abs err, ms, plain ms)}."""
    from sddmm_tpu_torch.ops import hybrid as hy
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    mode = runner.compute_dtype
    tname = f"sddmm_tile_dot_{mode}"
    dense = not hasattr(runner, "packed")
    size = ((runner.m, runner.n) if dense else (runner.packed.packed_size,))
    flat_k = torch.empty(size, device=DEVICE)
    flat_p = torch.empty(size, device=DEVICE)
    calls_k = list(runner.tile_calls(*ops, flat_k))
    calls_p = list(runner.tile_calls(*ops, flat_p))

    def tiles(calls, plain):
        for a, b, out, acc in calls:
            td.tile_dot(a, b, mode, out=out, accumulate=acc, plain=plain)

    tiles(calls_k, False)
    tiles(calls_p, True)
    torch.cuda.synchronize()
    n_tile = flat_k.numel() - (0 if dense else runner.packed.nnz_res)
    got, ref = flat_k.reshape(-1)[:n_tile], flat_p.reshape(-1)[:n_tile]
    rel = max_rel(got, ref)
    if not rel <= TILE_REL_TOL:
        fail(f"{label} {tname} at the path's shapes: max rel {rel:.3e} vs "
             "plain")
    tk = cuda_time_ms(lambda: tiles(calls_k, False), timing_iters)
    tp = cuda_time_ms(lambda: tiles(calls_p, True), timing_iters)
    out = {tname: (float((got - ref).abs().max()), tk["median_ms"],
                   tp["median_ms"])}
    tile_bytes = sum(a.numel() * a.element_size()
                     + b.numel() * b.element_size() + 4 * o.numel()
                     for a, b, o, _ in calls_k)
    say(f"[time] {label} {tname} ({len(calls_k)} launches of one call, "
        f"max rel vs plain {rel:.3e}): kernel {tk['median_ms']:.4f} ms, "
        f"plain {tp['median_ms']:.4f} ms on {card}; {tile_bytes / 1e6:.1f} "
        f"MB moved at least = {tile_bytes / tk['median_ms'] / 1e6:.1f} GB/s")
    del calls_k, calls_p
    if dense or not runner.packed.nnz_res:
        return out
    gname = gather_name(runner)
    residual = runner.residual_call(*ops)
    res_out = hy.residual_gather_dot(*residual)
    ref = hy.residual_gather_dot_plain(*residual)
    torch.cuda.synchronize()
    rel = max_rel(res_out, ref)
    if not rel <= GATHER_REL_TOL:
        fail(f"{label} {gname}: max rel {rel:.3e} vs plain")
    tk = cuda_time_ms(lambda: hy.residual_gather_dot(*residual, out=res_out),
                      timing_iters)
    tp = cuda_time_ms(lambda: hy.residual_gather_dot_plain(*residual),
                      timing_iters)
    out[gname] = (float((res_out - ref).abs().max()), tk["median_ms"],
                  tp["median_ms"])
    say(f"[time] {label} {gname} ({res_out.numel()} entries, max rel vs "
        f"plain {rel:.3e}): kernel {tk['median_ms']:.4f} ms, plain "
        f"{tp['median_ms']:.4f} ms on {card}")
    return out


def add_times(rec, times, with_ms=True):
    """Fold kernel_pass's numbers into the record: every max abs error,
    and the times only ``with_ms``."""
    for kname, (err, ms, plain_ms) in times.items():
        r = rec[kname]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if with_ms:
            r["ms"] += ms
            r["plain_ms"] += plain_ms


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
    from sddmm_tpu_torch.ops import tile_dot as td
    from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm_torch
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
                "slab shapes; strided unaligned out; C=2 accumulate): max "
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
        rel2, abs2 = check_gather_dot(torch, hy, rng)
        say(f"[gather_dot] 65536 entries, G in (1, 2, 4), C in (1, 2), "
            f"storage {', '.join(gather_pair_names())}: max rel vs plain "
            f"{rel2:.3e} (tol {GATHER_REL_TOL}), max abs {abs2:.3e}")

    # every kernel instance's record; "launches" is from the named path
    rec = {f"sddmm_tile_dot_{m}": {"max_abs_err": worst[m][1], "ms": 0.0,
                                   "plain_ms": 0.0}
           for m in td.MODES}
    for pair in hy.GATHER_STORAGE:
        rec[_kernels.gather_dot_entry(*pair)] = {
            "max_abs_err": abs2, "ms": 0.0, "plain_ms": 0.0}

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
        if not counts.get("sddmm_tile_dot_tf32"):
            fail(f"{name}@K{k}: the tile kernel was not launched")
        if (hasattr(runner, "packed") and runner.packed.nnz_res
                and not counts.get("sddmm_gather_dot_float32_float32")):
            fail(f"{name}@K{k}: the gather-dot kernel was not launched")
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
        _kernels.launches.clear()
        base_in = {}
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
        base_out = {name: csr_sddmm_torch(*args)
                    for name, args in base_in.items()}
        torch.cuda.synchronize()
        csr_launches = _kernels.launches["sddmm_gather_dot_float32_float32"]
        if csr_launches != len(base_in):
            fail(f"the CSR baseline launched the gather-dot kernel "
                 f"{csr_launches} times for {len(base_in)} cells")
        base_rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        for name, args in base_in.items():
            res = check_values(goldens[(name, 128)],
                               base_out[name].cpu().numpy())
            say(f"[check] {name}@K128 CSR baseline vs fp64 golden: {res}")
            if not res.passed or res.num_errors:
                fail(f"{name}: CSR baseline has {res.num_errors} values "
                     "outside the contract")
            ref = hy.residual_gather_dot_plain(*args)
            base_rec["max_abs_err"] = max(base_rec["max_abs_err"], float(
                (base_out[name] - ref).abs().max()))
            tk = cuda_time_ms(lambda: csr_sddmm_torch(*args), 20)
            tp = cuda_time_ms(lambda: hy.residual_gather_dot_plain(*args), 20)
            base_rec["ms"] += tk["median_ms"]
            base_rec["plain_ms"] += tp["median_ms"]
            tm = call_ms[(name, 128)]
            packed = tm["packed, kernels"]["median_ms"]
            in_csr = tm["CSR order, kernels"]["median_ms"]
            say(f"[time] {name}@K128 CSR baseline: kernel "
                f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms; "
                f"hybrid speed-up over it: packed "
                f"{tk['median_ms'] / packed:.3f}x, CSR order "
                f"{tk['median_ms'] / in_csr:.3f}x on {card}")
        del base_in, base_out

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
            for kname in (f"sddmm_tile_dot_{mode}", gather_name(runner)):
                if not counts.get(kname):
                    fail(f"mode {mode}: {kname} was not launched")
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

    if "jax" in sys.modules:
        fail("jax was imported")
    record = []
    for kname, r in rec.items():
        tile = kname.startswith("sddmm_tile_dot_")
        main = kname in ("sddmm_tile_dot_tf32",
                         "sddmm_gather_dot_float32_float32")
        record.append({
            "name": kname, "route": "cuda",
            "source": ("sddmm_tpu_torch/csrc/tile_dot.cu" if tile
                       else "sddmm_tpu_torch/csrc/gather_dot.cu"),
            "replaces": ("sddmm_tpu/ops/pallas_tiles.py:72" if tile
                         else "sddmm_tpu/ops/hybrid.py:306"),
            "launches": (main_launches.get(kname, 0) if main
                         else mode_launches.get(kname, 0)),
            "path": ("main path (8 cells)" if main
                     else "compute modes on banded@K128"),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    record.append({
        "name": "sddmm_gather_dot_float32_float32 (CSR baseline, C=G=1)",
        "route": "cuda", "source": "sddmm_tpu_torch/csrc/gather_dot.cu",
        "replaces": "sddmm_tpu/ops/csr_sddmm.py:25",
        "launches": csr_launches, "path": "CSR baseline (K=128 cells)",
        **base_rec})
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
