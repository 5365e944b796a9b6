#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sddmm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a), nvcc and the repo checkout around
this file; imports nothing of JAX.  Phases, each printing its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: nvcc builds ``sddmm_tpu_torch/csrc/*.cu`` (timed);
3. the tile-dot kernel against its plain PyTorch version and an fp64
   product, on U[0,2) tiles;
4. the residual gather-dot kernel against its plain version;
5. the main path at full bench scale: ``clustered16``, ``clustered128``
   and ``banded`` at K=128, generated as ``bench.py`` does, packed with the
   committed ``results/tuned_configs.json`` configs, run through
   ``HybridSDDMM(device="cuda")`` into CSR order and checked against the
   fp64 golden model; the kernels' launch counters must rise;
6. each kernel again at the main path's own shapes, checked against its
   plain version; then timing with CUDA events (median of 20 after
   warm-up): the packed path with the kernels, with the plain versions,
   and the CSR-order path, and each kernel's launches of one call beside
   its plain version.

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
K = 128
TIMING_ITERS = 20
TILE_REL_TOL = 1e-4     # kernel vs plain: tensor-core sums, another order
GATHER_REL_TOL = 1e-6   # kernel vs plain: both exact fp32, another sum order


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def suite():
    """The K=128 cells of the slice, with bench.py's generator calls."""
    from sddmm_tpu_torch.data import generate
    return {
        "clustered16": lambda: generate.block_clustered(
            1024, 1024, block_prob=0.008, block_density=0.65,
            noise_density=0.00001, seed=42),
        "clustered128": lambda: generate.block_clustered(
            128, 128, group_rows=128, group_cols=128, block_prob=0.025,
            block_density=0.3, noise_density=0.00001, seed=43),
        "banded": lambda: generate.banded(
            24576, 24576, bandwidth=45, fill=0.55, seed=45),
    }


def tuned(csr, cfg):
    """from_params on a committed config, mapped as bench.py maps it."""
    from sddmm_tpu_torch.reorder.autotune import from_params
    t = from_params(
        csr, K, alpha=cfg["alpha"], delta=cfg["delta"],
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


def check_tile_dot(torch, td, rng):
    worst_rel = worst_abs = 0.0
    nT = 37  # not a power of two: no padding of the batch is needed
    for R in (16, 32, 64, 128):
        for L in (128, 384):
            for Kd in (32, 128, 256):
                a = torch.tensor(rng.uniform(0, 2, (nT, R, Kd)),
                                 dtype=torch.float32, device="cuda")
                b = torch.tensor(rng.uniform(0, 2, (nT, L, Kd)),
                                 dtype=torch.float32, device="cuda")
                got = td.tile_dot_bf16x3(a, b)
                ref = td.tile_dot_bf16x3_plain(a, b)
                torch.cuda.synchronize()
                rel = max_rel(got, ref)
                worst_rel = max(worst_rel, rel)
                worst_abs = max(worst_abs, float((got - ref).abs().max()))
                if not rel <= TILE_REL_TOL:
                    fail(f"tile_dot R={R} L={L} K={Kd}: max rel {rel:.3e} "
                         f"vs plain > {TILE_REL_TOL}")
                exact = torch.bmm(a.double(), b.double().transpose(1, 2))
                err = (got.double() - exact).abs()
                bad = (err >= 1e-5) & (err / exact.abs() >= 1e-3)
                if bool(bad.any()):
                    fail(f"tile_dot R={R} L={L} K={Kd}: {int(bad.sum())} "
                         "cells outside abs 1e-5 / rel 1e-3 vs fp64")
    return worst_rel, worst_abs


def check_gather_dot(torch, hy, rng):
    worst_rel = worst_abs = 0.0
    m, n, nR = 4096, 6144, 65536
    for Kd in (32, 128, 256):
        a = torch.tensor(rng.uniform(0, 2, (m + 1, Kd)), dtype=torch.float32,
                         device="cuda")
        bt = torch.tensor(rng.uniform(0, 2, (n + 1, Kd)),
                          dtype=torch.float32, device="cuda")
        rows = torch.tensor(rng.integers(0, m + 1, nR), dtype=torch.int32,
                            device="cuda")
        gids = torch.tensor(rng.integers(0, n + 1, nR), dtype=torch.int32,
                            device="cuda")
        got = hy.residual_gather_dot(a, bt, rows, gids)
        ref = hy.residual_gather_dot_plain(a, bt, rows, gids)
        torch.cuda.synchronize()
        rel = max_rel(got, ref)
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, float((got - ref).abs().max()))
        if not rel <= GATHER_REL_TOL:
            fail(f"gather_dot K={Kd}: max rel {rel:.3e} vs plain > "
                 f"{GATHER_REL_TOL}")
    return worst_rel, worst_abs


def main() -> None:
    if not (ROOT / "sddmm_tpu_torch" / "__init__.py").is_file() or not (
            ROOT / "results" / "tuned_configs.json").is_file():
        fail(f"{ROOT} is not a checkout of the repo (sddmm_tpu_torch/ and "
             "results/tuned_configs.json are missing)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

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
    from sddmm_tpu_torch.ops.reference import sddmm_reference
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    from sddmm_tpu_torch.data import generate

    # -- 2. build --
    t0 = time.perf_counter()
    _kernels.load()
    say(f"[build] nvcc sm_90a {_kernels.lib_path().name}: "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")

    # -- 3./4. kernels against their plain versions --
    rng = np.random.default_rng(0)
    rel1, abs1 = check_tile_dot(torch, td, rng)
    say(f"[tile_dot] 24 shapes R in 16..128, L in (128, 384), K in "
        f"(32, 128, 256), nT=37: max rel vs plain {rel1:.3e} (tol "
        f"{TILE_REL_TOL}), max abs {abs1:.3e}; fp64 contract ok")
    rel2, abs2 = check_gather_dot(torch, hy, rng)
    say(f"[gather_dot] 65536 entries, K in (32, 128, 256): max rel vs "
        f"plain {rel2:.3e} (tol {GATHER_REL_TOL}), max abs {abs2:.3e}")

    # -- 5. the main path at full scale --
    configs = json.loads((ROOT / "results" / "tuned_configs.json")
                         .read_text())[f"k{K}"]
    cells = {}
    for name, gen in suite().items():
        t0 = time.perf_counter()
        csr = gen()
        t = tuned(csr, configs[name])
        runner = hy.HybridSDDMM(t.packed, compute_dtype="tf32",
                                k_chunks=t.k_chunks,
                                use_pallas=t.use_pallas,
                                a_layout=t.a_layout, device="cuda")
        a = generate.make_dense(csr.m, K, seed=1)
        b = generate.make_dense(K, csr.n, seed=2)
        ops = runner.prepare_operands(a, b=b)
        p = t.packed
        say(f"[pack] {name}: {csr.m}x{csr.n} nnz {csr.nnz} packed "
            f"{p.packed_size} super/quad/pair/group {p.num_super}/"
            f"{p.num_quads}/{p.num_pairs}/{p.num_groups} residual "
            f"{p.nnz_res} a_layout {t.a_layout}: "
            f"{time.perf_counter() - t0:.1f} s")
        cells[name] = (csr, runner, ops, a, b)

    td.tile_dot_bf16x3.launches = 0
    hy.residual_gather_dot.launches = 0
    outs = {name: runner.run_padded(*ops, order="csr")
            for name, (_, runner, ops, _, _) in cells.items()}
    torch.cuda.synchronize()
    launches = {"tile_dot_bf16x3": td.tile_dot_bf16x3.launches,
                "residual_gather_dot": hy.residual_gather_dot.launches}
    say(f"[main] launches during the main path: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            fail(f"{kname} was not launched by the main path")

    for name, (csr, runner, ops, a, b) in cells.items():
        got = outs[name].cpu().numpy()
        if got.shape != (csr.nnz,) or not np.isfinite(got).all():
            fail(f"{name}: output shape {got.shape} or non-finite values")
        res = check_values(sddmm_reference(a, b, csr), got)
        say(f"[check] {name} CSR order vs fp64 golden: {res}")
        if not res.passed or res.num_errors:
            fail(f"{name}: {res.num_errors} values outside the contract")

    # -- 6. timing --
    kernel_ms = {"tile_dot_bf16x3": [0.0, 0.0],
                 "residual_gather_dot": [0.0, 0.0]}
    for name, (csr, runner, ops, _, _) in cells.items():
        flops = 2.0 * csr.nnz * K
        packed = cuda_time_ms(lambda: runner.run_padded(*ops),
                              TIMING_ITERS)
        plain = cuda_time_ms(lambda: runner.run_padded(*ops, plain=True),
                             TIMING_ITERS)
        csr_t = cuda_time_ms(lambda: runner.run_padded(*ops, order="csr"),
                             TIMING_ITERS)
        for label, tm in (("packed, kernels", packed),
                          ("packed, plain versions", plain),
                          ("CSR order, kernels", csr_t)):
            ms = tm["median_ms"]
            say(f"[time] {name} {label}: median {ms:.4f} ms (min "
                f"{tm['min_ms']:.4f}, max {tm['max_ms']:.4f}, n {tm['n']}) "
                f"= {flops / ms / 1e6:.1f} GFLOPS on {card}")

        dense = list(runner.dense_inputs(*ops))
        outs_k = [torch.empty(seg.n_runs, seg.rows, seg.lanes,
                              device="cuda") for seg, _, _ in dense]
        residual = runner.residual_inputs(*ops)
        res_out = torch.empty(residual[2].shape[0], device="cuda")

        def k1():
            for (_, a_run, bg), o in zip(dense, outs_k):
                td.tile_dot_bf16x3(a_run, bg, out=o)

        def k1_plain():
            for _, a_run, bg in dense:
                td.tile_dot_bf16x3_plain(a_run, bg)

        # each kernel against its plain version at the main path's shapes
        k1()
        hy.residual_gather_dot(*residual, out=res_out)
        for (seg, a_run, bg), o in zip(dense, outs_k):
            ref = td.tile_dot_bf16x3_plain(a_run, bg)
            rel = max_rel(o, ref)
            abs1 = max(abs1, float((o - ref).abs().max()))
            if not rel <= TILE_REL_TOL:
                fail(f"{name} tile_dot at {tuple(a_run.shape)} x "
                     f"{tuple(bg.shape)}: max rel {rel:.3e} vs plain")
        ref = hy.residual_gather_dot_plain(*residual)
        abs2 = max(abs2, float((res_out - ref).abs().max()))
        if not max_rel(res_out, ref) <= GATHER_REL_TOL:
            fail(f"{name} gather_dot: max rel {max_rel(res_out, ref):.3e} "
                 "vs plain")
        say(f"[check] {name}: both kernels agree with their plain versions "
            f"at the main path's {len(dense)} tile shapes and "
            f"{res_out.numel()} residual entries")

        timings = (
            ("tile_dot_bf16x3", cuda_time_ms(k1, TIMING_ITERS),
             cuda_time_ms(k1_plain, TIMING_ITERS)),
            ("residual_gather_dot",
             cuda_time_ms(lambda: hy.residual_gather_dot(*residual,
                                                         out=res_out),
                          TIMING_ITERS),
             cuda_time_ms(lambda: hy.residual_gather_dot_plain(*residual),
                          TIMING_ITERS)))
        for kname, tk, tp in timings:
            kernel_ms[kname][0] += tk["median_ms"]
            kernel_ms[kname][1] += tp["median_ms"]
            say(f"[time] {name} {kname} (all launches of one call): kernel "
                f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms "
                f"on {card}")
        # bytes the tile dots must move at least: read the gathered A and
        # B^T blocks once, write the output (computed from the shapes)
        tile_bytes = 4 * sum(a_run.numel() + bg.numel() + seg.size
                             for seg, a_run, bg in dense)
        say(f"[bytes] {name} tile_dot_bf16x3: {tile_bytes / 1e6:.1f} MB per "
            f"call in {len(dense)} launches = "
            f"{tile_bytes / timings[0][1]['median_ms'] / 1e6:.1f} GB/s at "
            "the event-timed kernel ms")
        del dense, outs_k

    if "jax" in sys.modules:
        fail("jax was imported")
    record = [
        {"name": "tile_dot_bf16x3", "route": "cuda",
         "source": "sddmm_tpu_torch/csrc/tile_dot.cu",
         "replaces": "sddmm_tpu/ops/pallas_tiles.py:39",
         "launches": launches["tile_dot_bf16x3"], "max_abs_err": abs1,
         "ms": kernel_ms["tile_dot_bf16x3"][0],
         "plain_ms": kernel_ms["tile_dot_bf16x3"][1]},
        {"name": "residual_gather_dot", "route": "cuda",
         "source": "sddmm_tpu_torch/csrc/gather_dot.cu",
         "replaces": "sddmm_tpu/ops/hybrid.py:306",
         "launches": launches["residual_gather_dot"], "max_abs_err": abs2,
         "ms": kernel_ms["residual_gather_dot"][0],
         "plain_ms": kernel_ms["residual_gather_dot"][1]},
    ]
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
