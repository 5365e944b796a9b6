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
   128); the segment softmax kernel and its backward against their plain
   versions (the long rows also against their plain counterpart in the
   kernel's order of sums; the backward entry by entry, each to the size
   of its terms, and 0 in the padding slots) on random patterns (every
   7th row empty, one row of 200,000 entries) at H in (1, 12), from
   packed scores through an ``inv_idx`` and from CSR-order scores, two
   runs bit-equal, and at 12
   heads each row class of the kernel's plan (8-lane groups, warps, block
   rows, split rows) timed alone, forward and backward;
4b. MiMo-V2-Flash's attention layers (``models.HybridAttentionStack``):
   one full layer (causal, 64 query heads over 4 key/value heads) and one
   window layer (a causal band of 128 keys with a learned sink, over 8) at
   the published widths (hidden 4096, q/k heads of 192, v heads of 128,
   RoPE on 64 dims, V times 0.707) and the benchmark cell's 4096
   positions, each kind's mask packed once.  Each layer's forward and the
   backward of mean(out^2), the launch counters zeroed just before each:
   RoPE, the tile kernel, the softmax and the SpMM once a forward (the
   residual's gather-dot once where the packing has one); RoPE, the
   softmax backward, the gather-dot (dP), the SpMM (dV, plus the
   residual's two) and tile-grad with its reduction once a backward.  The
   output against the fp64 reference (``models.mimo_reference``) under
   the contract and against the plain path; the step timed.  Then each
   new path at the layer's shapes against its plain version: RoPE forward
   and backward (unrotated dims and the sentinel row untouched), the
   scores of query head h against key head h >> s read in place and their
   backward (the group's dK summed), the softmax forward and backward with
   the sink's gradient (each row's mass under 1 with a sink), the
   aggregation against V of the group and its backward (dV summing the
   group), each in norm within 1e-5, and timed forward and backward beside
   its plain version and its bound;
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
   packing has a residual; the Longformer's projections two split and two
   GEMM launches (``ops.project``).  Each output is checked against an fp64
   reference under the contract and against the same forward with every
   kernel's plain version; both forwards, the SpMM at the models' shapes
   (beside ``torch.sparse.mm`` on a CSR tensor and its bound) and the
   segment softmax at the models' shapes (beside ``torch.sparse.softmax``
   on a COO tensor of the same scaled scores and its bound, and by row
   class) are timed; so are the Longformer layer's projections forward and
   backward, beside their plain version and the library path they
   replaced, with each output and gradient held to fp64 at a limit a
   three-product control fails.

10. the backward passes at the main path's shapes: the hybrid's (B1: the
   tile-grad kernel over the work table's units and its reduction, one
   launch each for all heads and chunks, plus two SpMM launches for the
   residual's entries) on clustered16 K=128 (G=1, panels), banded K=64
   (G=2, rows, a residual), clustered16 K=32 (G=4) and powerlaw K=128 at
   bench scale (123 M packed slots, the hub and hot-row slabs), and on a
   small powerlaw packing with both slabs and C=2 at 2 heads: the backward
   index's host seconds, exactly those launches around ``backward()`` and
   no per-slot read pattern built, the kernels' gradients against the
   plain Function's (``tile_table_grad_plain``) within 1e-5, a repeat
   backward bit-equal, and against fp64 scipy (G ⊙ S)·B with a cotangent on
   the real slots under the contract; the CSR SDDMM's (B4, its launches
   counted alone) and the dense class's (B5, cuBLAS) timed;
11. the training path: the graph layer's and the Longformer-shaped
   model's backward of sum(out^2) (the counts zeroed just before the
   ``backward()`` calls and read just after, and by op: one
   softmax-backward launch, one gather-dot and one SpMM launch for the
   aggregation, and B1's launches), their weight gradients against the
   plain path and against fp64 autograd of the dense references; B1 at the
   Longformer's 12 heads timed beside the read-pattern route; then
   ``SparseFactorizationModel.from_csr`` on the bench's clustered16 at
   K=128, "float32", Adam at lr 1e-2: step 1's gradients against fp64
   scipy, 20 steps (counts zeroed just before and read just after: 1 tile,
   1 gather-dot and B1's launches a step), the loss finite and falling, the
   first 3 losses against the plain path's, a checkpoint saved, restored
   and stepped bit-equal, and the step's time split into forward, backward
   and optimizer beside the plain path's; each backward kernel timed beside
   its plain version, a library call where one exists, and its bound (B1
   also beside the read-pattern route, its bound counted as the work's:
   g, A and B^T read once, dA and dB^T written once, the six bf16 products
   of each cell on the tensor cores);
12. the entry points a user runs, in this process: the bench route
   (``sddmm_tpu_torch.bench.main``, the five-matrix suite at K=128 on the
   committed configs, one session each; its JSON printed, its keys, every
   cell above 0 GFLOPS, ``roofline_fraction`` null, ``sol_fraction`` at
   most 1.05, its launch counts zeroed before and read after); the
   measured shoot-out (``autotune(measure=True)``) on banded at K=128, each
   finalist's time and host set-up printed, the winner in CSR order
   against the fp64 golden; the CLI (``cli.main``) on banded written to an
   .mtx file, once with ``--validate`` and once with ``--tune``, each log
   parsed (the card's name, GFLOPS above 0, no failed check), and ``-t 1``
   on a 256x256 matrix (140 logs); and ``utils.profiling.trace`` around
   one call, whose Chrome trace must name the tile kernel; last, each
   bench cell's packed time must be at least 75 % of the device time of
   the kernels its call launches (the profiler's, timed now), and the
   bench's own timer (``measure_kernel_ms``) on the same call, timed now
   between two event samples, must lie between that floor and 125 % of
   the slowest sample (a host-bound call reads the host's enqueue, which
   moves by up to 2x between phases, so only the device floor holds the
   bench's number from the start of the phase);
13. device row clustering: on the probe matrix of the JAX package's
   ``scripts/probe_cluster.py`` (``block_clustered(6400, 2048,
   block_prob=0.004, ...)``, 102,400 rows, 2,048 column blocks, alpha 0.3)
   ``batched_cluster_device`` with the kernel (``csrc/cluster_round.cu``,
   its two launches counted a round enqueued, the counts zeroed just
   before) against the plain round on the card, exactly (the same
   ``cluster_of``); the rounds, the launches a clustering, the kernel's
   device time a round (CUDA events around each batch of rounds), the
   leaders' and the rows' launches timed apart (events around every
   launch, a second run, bit-equal), the host wall a round, the plain
   round's, the bound and its share, the native host greedy's time on the
   same matrix and the routing constant (seconds a cell) printed; on a
   mid matrix (16,384 rows) the kernel, the plain round and the host's
   ``rows._batched_cluster(hat_dtype=np.float32)`` equal, and the kernel
   at 96 leaders a round (the accepted mask over three 32-bit words) equal
   to the plain round at 96; the native library's path, which must lie under
   ``sddmm_tpu_torch/`` (``[host] native source``), and on
   ``powerlaw_graph(8192, avg_degree=16, seed=44)`` at alpha 0.2 the numpy
   fallback greedy (``rows._greedy_cluster``, native arithmetic) with the
   native greedy's cluster ids exactly, both host times printed (``[host]
   greedy fallback == native``); and
   ``HybridSDDMM.from_csr(method="device")`` on clustered16 with 0 errors
   against fp64;
14. the multi-device path (``parallel``): ``dryrun_multichip`` over a
   (2, 2) mesh of 4 ranks (NCCL with a card a rank where there are 4, else
   gloo over CUDA tensors on the one card) and over (1, 1) on NCCL: its
   checks (every real slot bit-equal to the single-device runner, or each
   feat partial bit-equal and the sum within one rounding; the loss; one
   all-reduce over 'feat' and no all-gather in the packed step) and each
   rank's launches; then clustered16 at K=128 over (2, 2) on its committed
   config: CSR order with 0 errors against fp64, each rank's step, its
   local kernels and its all-reduce timed (CUDA events), the dense class on
   dlmc with 0 errors, and 5 steps of the distributed trainer within 1e-5
   of the single-device model's losses;
15. the harness on the card, each script through its ``main`` in a
   temporary directory: ``scripts/torch_make_synth_suite.py`` writes
   three full-size matrices of three regimes (planted blocks
   fineblock_mid, the hub rows of powerlaw40, and dlmc_dense_10 of the
   DLMC density class); ``torch_run_baselines.py`` runs all five tools on
   them at K=128 with ``--measure --validate`` (every check PASS, every
   GFLOPS above 0, the tile kernel's and the gather-dot's launch counts
   moved; the shoot-out's strategy printed: on the DLMC class the dense
   class and the hybrid's packing time within the card's noise of each
   other, so either may win);
   ``torch_analyze_results.py`` tabulates the logs (its table and the
   geomean speed-ups of bsmr over csr and dense printed);
   ``torch_run_bench_suite.py`` runs the CLI on fineblock_mid at K = 32
   and 128 (each log names the card, GFLOPS above 0); and
   ``torch_scaling_bench.py --devices 1 2 4`` runs the sharded runner over
   1, 2 and 4 ranks (gloo on one card, NCCL with a card a rank) within
   1e-5 of the single-device runner, no all-gather, one all-reduce over
   'feat' at (2, 2);
16. the layout model's calibration: ``scripts/torch_calibrate.py``'s
   ``main`` at full size into a temporary file (the launch counts zeroed
   just before): every rate finite and above 0, its footprints and its 20
   mode x height keys there, and each mode's tile-kernel instance launched
   by every timed or warm-up call of its four dot probes; the file loaded
   into the port's ``autotune`` and its constants checked against it; the
   measured shoot-out on banded and powerlaw at K=128 with the shipped
   constants and calibrated, each finalist's score and time, the Spearman
   correlation of the two and both winners printed, the calibrated
   winners' CSR-order output against the fp64 golden with 0 errors; the
   shipped constants put back at the end;
17. the config probes, each script through its ``main`` in a temporary
   directory, the launch counts zeroed just before each and read just
   after: ``scripts/torch_probe_configs.py`` on banded at K=128 over the
   committed config T, phase 12's shoot-out winner S, the card file's
   entry H and T's first one-factor neighbours, four configs in all
   (``torch_autofold.grid_specs``), 2 rounds, each config's contract PASS
   against fp64, event and device times and the winner printed, the tile
   kernel launched; ``torch_probe_dense_dlmc.py`` at K=128 (the hybrid,
   the dense class and three cuBLAS yardsticks), the tile kernel launched;
   then ``torch_autofold.py --validate`` folds both logs into a temporary
   copy of ``sddmm_tpu_torch/tuned_configs_h100.json``: banded's entry is
   the one the fold's rule picks from the log (the winner where its
   margin over H beats both configs' spreads, else H) and dlmc's follows
   the arbitration, each validated at 0 errors against fp64, the copy
   passes ``validate_tuned_configs`` and names the card, and neither
   committed configs file changes.

It then prints one JSON line with the kernels' record (per kernel: its
launches on its path, max abs error against its plain version, and the
summed times of the timed calls: kernel, plain version, PyTorch library
call, and bound with what sets it) and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
those lines.  Without a CUDA card, or outside the repo, it fails at once.
"""

import json
import statistics
import subprocess
import sys
import tempfile
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
# the backward phases: a backward kernel vs its plain version on U[0,2) data
# (no cancellation), as max |kernel - plain| / |plain|: the same fp32
# products summed in another order (the SpMM row by row, the plain
# index_add_ with atomics)
BACKWARD_REL = 1e-5
# the hybrid's backward is checked on these main-path cells (powerlaw at
# bench scale: 123 M packed slots, both slabs)
GRAD_CELLS = [("clustered16", 128), ("banded", 64), ("clustered16", 32),
              ("powerlaw", 128)]
# weight gradients vs fp64 autograd, as max abs err / max |exact| per
# weight: each is a sum over every position (4096 or 16384) of terms of both
# signs, so no elementwise contract holds near its zeros
GRAD_FP64_TOL = 1e-4
# the factorization's first losses, kernels vs plain versions: the forward
# within about one fp32 rounding, the gradients summed in another order
LOSS_REL_TOL = 1e-5
TRAIN = dict(k=128, lr=1e-2, steps=20)
# the entry points phase: the bench JSON's keys, its sol_fraction's ceiling
# (above 1.0 only by L2 residency), the margin of a bench cell's packed time
# below its kernels' device time and of the bench's timer above the same
# call's slowest event sample, and
# the -t 1 sweep's logs (5 alphas x 7 deltas x 4 K)
BENCH_KEYS = ("metric", "value", "value_4matrix", "vs_baseline", "backend",
              "device", "stream_gbps", "per_matrix", "per_matrix_csr_order",
              "geomean_csr_order", "speedup_vs_csr_same_chip",
              "geomean_vs_csr", "sol_fraction", "roofline_fraction",
              "timing_sessions_ms", "tuning_s", "warnings")
SOL_MAX = 1.05
BENCH_AGREE = 0.25
SWEEP_LOGS = 140
# the card's published peaks (H100 SXM, NVIDIA's data sheet), for bounds
# the device clustering phase: the probe matrix of the JAX package's
# scripts/probe_cluster.py (102,400 rows, 2,048 column blocks of 16) and a
# mid matrix the host's numpy batched clustering takes in seconds
PROBE = dict(num_row_groups=6400, num_col_groups=2048, block_prob=0.004,
             block_density=0.6, noise_density=0.0, seed=71)
MID = dict(num_row_groups=1024, num_col_groups=512, block_prob=0.004,
           block_density=0.6, noise_density=0.0, seed=72)
CLUSTER_ALPHA = 0.3
# the host greedy's numpy fallback against the native library (a matrix
# whose rows fall near alpha, a few seconds in numpy)
FALLBACK_GRAPH = dict(num_nodes=8192, avg_degree=16, seed=44)
FALLBACK_ALPHA = 0.2
# the multi-device phase: the full-size mesh, its cell and its timing
MESH_SCALE = (2, 2)
ONE_RANK_BACKEND = "nccl"
SCALE_CELL = ("clustered16", 128)
SCALE_ITERS = 10
FACT_STEPS = 5
# the harness phase: its matrices (of torch_make_synth_suite.py's corpus),
# K, the baselines' tools, the bench suite's Ks, the scaling run's rank
# counts and the sharded runner's tolerance against one device
HARNESS_MATRICES = ("fineblock_mid", "powerlaw40", "dlmc_dense_10")
HARNESS_K = 128
HARNESS_TOOLS = ("csr", "dense", "bsmr", "bsmr_dense_only",
                 "bsmr_residual_only")
HARNESS_SUITE_KS = (32, 128)
HARNESS_RANKS = (1, 2, 4)
SCALING_REL = 1e-5
# the device clustering phase's leaders a round past one 64-bit word
WIDE_LEADERS = 96
# the calibration phase: the shoot-outs' cells, shipped and calibrated
CALIBRATION_CELLS = (("banded", 128), ("powerlaw", 128))
# the probes phase: the probed cell, its rounds, and the dlmc probe's K
PROBE_CELL = ("banded", 128)
PROBE_ROUNDS = 2
DENSE_PROBE_K = 128
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
FP32_FLOPS = 67e12      # fp32 outside the tensor cores


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only one of them still reads why
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
    from sddmm_tpu_torch import bench
    return bench.suite(quick=False)


def tuned(csr, k, cfg):
    """from_params on a committed config, mapped as bench.py maps it."""
    from sddmm_tpu_torch.bench import fold_config
    return fold_config(csr, k, cfg, cfg.get("dtype", "tf32"))


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


def check_softmax(torch, sm, rng, card):
    """The segment softmax kernel and its backward against their plain
    versions (the long rows also against their plain counterpart in the
    kernel's order of sums), from packed scores through inv_idx and from
    CSR-order scores, at SOFTMAX_HEADS; a second run bit-equal; at 12
    heads each row class timed alone, forward and backward.  Returns
    (max |kernel - plain| / plain, max abs)."""
    worst_rel = worst_abs = 0.0
    for heads in SOFTMAX_HEADS:
        row_ptr, inv, flat = softmax_case(torch, rng, heads)
        plan = sm.softmax_plan(row_ptr.cpu().numpy(), DEVICE)
        for packed in (True, False):
            x, idx = ((flat, inv) if packed
                      else (flat[:, inv.long()].contiguous(), None))
            got = sm.segment_softmax_torch(x, row_ptr, 0.125, idx, plan)
            again = sm.segment_softmax_torch(x, row_ptr, 0.125, idx, plan)
            want = sm.segment_softmax_plain(x, row_ptr, 0.125, idx)
            split = sm.segment_softmax_split_plain(x, row_ptr, 0.125, idx)
            g = torch.randn(got.shape, device=DEVICE)
            d = sm.segment_softmax_backward(got, g, row_ptr, 0.125, idx,
                                            x.shape[1], plan)
            d2 = sm.segment_softmax_backward(got, g, row_ptr, 0.125, idx,
                                             x.shape[1], plan)
            want_d = sm.segment_softmax_backward_plain(got, g, row_ptr,
                                                       0.125, idx, x.shape[1])
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want).max())
            rel_s = float(((got - split).abs() / split).max())
            rel_d = backward_rel(sm, d, want_d, got, g, row_ptr, 0.125, idx)
            worst_rel = max(worst_rel, rel)
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            if not max(rel, rel_s, rel_d) <= SOFTMAX_REL_TOL:
                fail(f"segment_softmax H={heads} "
                     f"{'packed' if packed else 'CSR order'}: max rel "
                     f"{rel:.3e} vs plain, {rel_s:.3e} vs the split "
                     f"combine, backward {rel_d:.3e} (the worst entry to "
                     f"its terms) > {SOFTMAX_REL_TOL}")
            if not (torch.equal(got, again) and torch.equal(d, d2)):
                fail(f"segment_softmax H={heads}: two runs differ")
            if heads == max(SOFTMAX_HEADS) and packed:
                label = f"softmax case H={heads}"
                class_times(f"{label} forward",
                            lambda pl: sm.segment_softmax_torch(
                                x, row_ptr, 0.125, idx, pl, out=got),
                            plan, card)
                class_times(f"{label} backward",
                            lambda pl: sm.segment_softmax_backward(
                                got, g, row_ptr, 0.125, idx, x.shape[1],
                                pl), plan, card)
            del got, again, want, split, d, d2, want_d
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


def backward_rel(sm, d, want, p, g, row_ptr, scale, inv):
    """The softmax backward ``d`` against ``want``, both (H, F) at the
    packed slots ``inv`` (or (H, nnz) in CSR order where ``inv`` is None),
    from the output ``p`` and the cotangent ``g`` (H, nnz): the largest
    entry's |d - want| over the size of its terms (``backward_rel_err``;
    inf if a padding slot of ``d`` is not 0)."""
    if inv is None:
        return sm.backward_rel_err(d, want, p, g, row_ptr, scale)
    slots = inv.long()
    pad = d.clone()
    pad[:, slots] = 0
    if bool(pad.any()):
        return float("inf")
    return sm.backward_rel_err(d[:, slots], want[:, slots], p, g, row_ptr,
                               scale)


def class_times(label, run, plan, card):
    """Times ``run(plan)`` (one launch of a softmax entry) on each row
    class of ``plan`` alone, and prints them: {class: (rows, ms)}."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    times = {name: (part.rows.numel(),
                    cuda_time_ms(lambda part=part: run(part), 20)[
                        "median_ms"])
             for name, part in plan.by_class().items()}
    say(f"[time] {label} by row class: " + ", ".join(
        f"{name} {n} rows {ms:.4f} ms" for name, (n, ms) in times.items())
        + f" on {card}")
    return times


def head_csrs(torch, agg, values):
    """The (H, nnz) ``values`` of H heads at an aggregation's pattern as H
    sparse CSR matrices, one a head: what the libraries take."""
    return [torch.sparse_csr_tensor(agg.row_ptr, agg.cols.long(), v,
                                    size=agg.shape) for v in values]


def time_spmm(torch, sp, label, agg, heads, d, card):
    """The SpMM kernel against its plain version at one model's shapes
    (its aggregation's pattern and plan, ``heads`` heads of random
    positive weights in one launch, V of width ``d``), beside
    ``torch.sparse.mm`` on a CSR tensor a head: the record's numbers."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    g = torch.Generator(device=DEVICE).manual_seed(0)
    (m, n), nnz = agg.shape, agg.cols.shape[0]
    w = torch.rand((heads, nnz), generator=g, device=DEVICE)
    v = torch.rand((heads, n, d), generator=g, device=DEVICE)

    def kernel():
        return sp.head_spmm(w, v, agg)

    def plain():
        return sp.head_spmm(w, v, agg, plain=True)

    s_csr = head_csrs(torch, agg, w)

    def library():
        return torch.stack([torch.sparse.mm(s, v[h])
                            for h, s in enumerate(s_csr)])

    got, want = kernel(), plain()
    lib = library()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = max_rel(got[want > 0], want[want > 0])  # = err / sum |terms|
    if not rel <= SPMM_REL_TOL:
        fail(f"{label} head_spmm at the model's shapes: max rel {rel:.3e} "
             "vs plain")
    if not max_rel(lib[want > 0], want[want > 0]) <= SPMM_REL_TOL:
        fail(f"{label}: torch.sparse.mm does not compute the same function")
    del got, want, lib
    tk = cuda_time_ms(kernel, 20)
    tp = cuda_time_ms(plain, 5)
    tl = cuda_time_ms(library, 20)
    used = int(torch.unique(agg.cols).numel())
    # the pattern read once for all heads, each head's weights, the V rows
    # it uses and its output
    nbytes = (8 * (m + 1) + 4 * nnz + 4 * heads * nnz + 4 * heads * used * d
              + 4 * heads * m * d)
    bnd = bound_times(nbytes, 2.0 * heads * nnz * d, FP32_FLOPS)
    gathered = 4.0 * heads * nnz * d
    say(f"[time] {label} {_kernels.SPMM_ENTRY} ({heads} head(s) x {nnz} "
        f"entries, K={d}, max rel vs plain {rel:.3e}): kernel "
        f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms, "
        f"torch.sparse.mm (a call a head) {tl['median_ms']:.4f} ms, bound "
        f"{max(bnd.values()):.4f} ms ({nbytes / 1e6:.1f} MB read once + "
        f"written once); gathered V rows {gathered / 1e9:.2f} GB = "
        f"{gathered / tk['median_ms'] / 1e9:.2f} TB/s of L2/L1 reads on "
        f"{card}")
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl["median_ms"], **bnd}


def head_coos(torch, agg, values):
    """The (H, nnz) ``values`` of H heads at an aggregation's pattern as H
    coalesced sparse COO matrices, one a head (their values in CSR
    order)."""
    idx = torch.stack([agg.rows, agg.cols.long()])
    return [torch.sparse_coo_tensor(idx, v, size=agg.shape).coalesce()
            for v in values]


def time_softmax(torch, sm, label, model, heads, d, card):
    """The segment softmax kernel against its plain version at one model's
    shapes (its heads, pattern and packing; N(0, 16) packed scores, scale
    1/sqrt(d)), beside ``torch.sparse.softmax`` on a COO tensor a head of
    the same scaled scores: the record's numbers."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    core = model.core
    runner = core.runner
    g = torch.Generator(device=DEVICE).manual_seed(0)
    flat = torch.randn((heads, runner.packed.packed_size), generator=g,
                       device=DEVICE) * 4
    inv, scale = runner.inv_idx32, 1.0 / d ** 0.5

    def kernel(plan=core.softmax_plan):
        return sm.segment_softmax_torch(flat, core.row_ptr, scale, inv, plan)

    def plain():
        return sm.segment_softmax_plain(flat, core.row_ptr, scale, inv)

    coos = head_coos(torch, core.agg, flat[:, inv.long()] * scale)

    def library():
        return [torch.sparse.softmax(c, dim=1) for c in coos]

    got, want = kernel(), plain()
    lib = torch.stack([c.values() for c in library()])
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want).max())
    if not rel <= SOFTMAX_REL_TOL:
        fail(f"{label} segment softmax at the model's shapes: max rel "
             f"{rel:.3e} vs plain")
    if not float(((lib - want).abs() / want).max()) <= SOFTMAX_REL_TOL:
        fail(f"{label}: torch.sparse.softmax does not compute the same "
             "function")
    err = float((got - want).abs().max())
    del got, want, lib
    tk = cuda_time_ms(kernel, 20)
    tp = cuda_time_ms(plain, 5)
    tl = cuda_time_ms(library, 20)
    nnz = inv.numel()
    nbytes = 8 * heads * nnz + 4 * nnz + 8 * core.row_ptr.numel()
    bnd = bound_times(nbytes, 5.0 * heads * nnz, FP32_FLOPS)
    say(f"[time] {label} {_kernels.SOFTMAX_ENTRY} ({heads} heads x {nnz} "
        f"entries, max rel vs plain {rel:.3e}): kernel "
        f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms, "
        f"torch.sparse.softmax (a call a head) {tl['median_ms']:.4f} ms, "
        f"bound {max(bnd.values()):.4f} ms ({nbytes / 1e6:.1f} MB read once "
        f"+ written once) = {100 * max(bnd.values()) / tk['median_ms']:.1f} "
        f"% of it on {card}")
    class_times(f"{label} {_kernels.SOFTMAX_ENTRY}", kernel,
                core.softmax_plan, card)
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl["median_ms"], **bnd}


#: the Longformer layer's projections (L, F, H, D), as the train cell runs
#: them: Q, K, V from x, the output projection, and the backward of both
#: with x needing its gradient: six products, 58.0 GFLOP
PROJ_LAYER = (4096, 768, 12, 64)
#: the projections' outputs and gradients against fp64, max abs err over
#: max |exact|: on an H100 the kernel reads at most 4.2e-7 here (6.0e-7 in
#: the card tests, on U[0,2) data), a three-product control ("tf32"'s
#: split: hi.hi, hi.lo, lo.hi) 4.6-5.3e-6 on the forward's products, so an
#: arithmetic short of the six fails here
PROJ_FP64_TOL = 2e-6


def time_projections(torch, card):
    """The Longformer layer's projections (``ops.project``: ``qkv_project``
    and ``out_project``, forward and backward) at the main path's shapes,
    against their plain version (the six products on cuBLAS fp32) and the
    library path they replaced (``library_ms``: einsums, pads, the heads'
    transpose and ``torch.matmul`` fp32 with TF32 off, through autograd;
    the port never calls it): each output and gradient checked against
    the library path in fp64 at PROJ_FP64_TOL, which a three-product
    control of the forward's products exceeds; the record's numbers."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops import project as pj
    from sddmm_tpu_torch.ops.tile_dot import full_fp32_matmul, split_bf16
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    L, F, H, D = PROJ_LAYER
    g = torch.Generator(device=DEVICE).manual_seed(7)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    leaves = [draw(L, F), *(draw(H, F, D) for _ in range(3)),
              draw(H, L, D), draw(H * D, F)]   # x, w_q, w_k, w_v, heads, w_o
    for t in leaves:
        t.requires_grad_()
    cots = [draw(H, L + 1, D), draw(H, L + 1, D), draw(H * L, D),
            draw(L, F)]
    leaves64 = [t.detach().double().requires_grad_() for t in leaves]
    cots64 = [c.double() for c in cots]

    def kernels(plain=False):
        x, w_q, w_k, w_v, heads, w_o = leaves
        outs = [*pj.qkv_project(x, w_q, w_k, w_v, plain=plain),
                pj.out_project(heads, w_o, plain=plain)]
        torch.autograd.backward(outs, cots)
        return outs

    def library(ts=leaves, cs=cots):
        x, *ws, heads, w_o = ts
        with full_fp32_matmul():
            q, k, v = (torch.einsum("lf,hfd->hld", x, w) for w in ws)
            pad = (0, 0, 0, 1)
            outs = [torch.nn.functional.pad(q, pad),
                    torch.nn.functional.pad(k, pad),
                    v.reshape(H * L, D).contiguous(),
                    heads.transpose(0, 1).reshape(L, H * D) @ w_o]
            torch.autograd.backward(outs, cs)
        return outs

    def run(fn, ts=leaves):
        for t in ts:
            t.grad = None
        outs = fn()
        torch.cuda.synchronize()
        return [o.detach() for o in outs] + [t.grad for t in ts]

    got = run(kernels)
    exact = run(lambda: library(leaves64, cots64), leaves64)
    names = ["q_pad", "k_pad", "v", "out", "dx", "dw_q", "dw_k", "dw_v",
             "dheads", "dw_o"]
    err = rel = 0.0
    for name, k, e in zip(names, got, exact):
        d = float((k.double() - e).abs().max())
        r = d / float(e.abs().max())
        say(f"[check] projection {name} {tuple(k.shape)}: max abs err / "
            f"max |exact| {r:.3e}")
        if not r <= PROJ_FP64_TOL:
            fail(f"projection {name}: max abs err / max |exact| {r:.3e} > "
                 f"{PROJ_FP64_TOL}")
        err, rel = max(err, d), max(rel, r)
    del got

    def three(a, b):   # a (M, K) . b (N, K)^T on "tf32"'s three products
        ap, bp = split_bf16(a, 2), split_bf16(b, 2)
        with full_fp32_matmul():
            return sum(ap[i].float() @ bp[j].float().T
                       for i, j in ((0, 0), (0, 1), (1, 0)))

    x, *ws, heads, w_o = (t.detach() for t in leaves)
    w_rows = torch.cat([w.transpose(1, 2).reshape(H * D, F) for w in ws])
    h_cat = heads.transpose(0, 1).reshape(L, H * D)
    for name, a, b in (("qkv", x, w_rows), ("out", h_cat, w_o.T)):
        e = a.double() @ b.double().T
        r = float((three(a, b) - e).abs().max() / e.abs().max())
        say(f"[check] projection {name}, three-product control: max abs "
            f"err / max |exact| {r:.3e} (limit {PROJ_FP64_TOL})")
        if not r > PROJ_FP64_TOL:
            fail(f"projection {name}: the three-product control reads "
                 f"{r:.3e}, within {PROJ_FP64_TOL}: the limit cannot tell "
                 f"six products from three")
    del exact, leaves64, e
    before = dict(_kernels.launches)
    run(kernels)
    launched = {n: _kernels.launches[n] - before.get(n, 0)
                for n in (_kernels.PROJ_SPLIT_ENTRY, _kernels.PROJ_GEMM_ENTRY)}
    if launched != {_kernels.PROJ_SPLIT_ENTRY: 4, _kernels.PROJ_GEMM_ENTRY: 6}:
        fail(f"projections forward and backward: launches {launched}, want "
             f"4 split (2 forward, 2 backward) and 6 GEMM (2, 4)")
    tk = cuda_time_ms(kernels, 10)
    tp = cuda_time_ms(lambda: kernels(True), 3, warmup=1)
    tl = cuda_time_ms(library, 10)
    # Q, K, V and the output projection, their dX and dW: 12 widths of
    # L x F x H*D; each leaf read and its gradient written, each output
    # written and its cotangent read
    flops = 2.0 * L * F * H * D * 12
    nbytes = 4 * 2 * sum(t.numel() for t in leaves + cots)
    bnd = bound_times(nbytes, flops, BF16_FLOPS / 6)
    say(f"[time] projections forward and backward, L {L}, F {F}, {H} heads "
        f"of {D} (launches {launched}; max abs err / max |exact| {rel:.3e})"
        f": kernels {tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} "
        f"ms, library (einsum, pad, torch.matmul fp32) "
        f"{tl['median_ms']:.4f} ms, bound {bnd['ops_ms']:.4f} ms "
        f"(operations at 989/6 TFLOP/s) = "
        f"{100 * bnd['ops_ms'] / tk['median_ms']:.1f} % of it on {card}")
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl["median_ms"], **bnd}


def run_models(torch, sp, sm, card, adj):
    """Phase 9 on the clustered16 adjacency ``adj``: returns the launch
    counts of the models' forwards, the records of the SpMM and of the
    segment softmax at the models' shapes, summed over the two models, and
    the two models with their inputs (graph, x, block, x, mask)."""
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
        if label == "block-sparse attention":   # Q, K, V; the output
            want.update({_kernels.PROJ_SPLIT_ENTRY: 2,
                         _kernels.PROJ_GEMM_ENTRY: 2})
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
    for label, model, heads, d in (
            ("graph attention", graph, 1, GRAPH_WIDTH),
            ("block-sparse attention", block, lf["heads"], lf["head_dim"])):
        add_times(rec, {_kernels.SPMM_ENTRY: time_spmm(
            torch, sp, label, model.core.agg, heads, d, card)})
        add_times(rec, {_kernels.SOFTMAX_ENTRY: time_softmax(
            torch, sm, label, model, heads, d, card)})
    rec[_kernels.PROJ_GEMM_ENTRY] = new_record(0.0)
    add_times(rec, {_kernels.PROJ_GEMM_ENTRY: time_projections(torch, card)})
    return counts, rec, (graph, x_graph, block, x_block, mask)


#: the MiMo phase: MiMo-V2-Flash's attention layers
#: (XiaomiMiMo/MiMo-V2-Flash, config.json) at the published widths and the
#: benchmark cell's length: 64 query heads over 4 (full: causal) or 8
#: (window: causal band of 128 with a learned sink) key/value heads, q/k
#: heads of 192, v heads of 128, RoPE on 64 dims, V scaled by 0.707
MIMO = dict(seq_len=4096, hidden=4096, heads=64, head_dim=192,
            v_head_dim=128, rotary=64, value_scale=0.707)
#: each kind of layer: (name, key/value heads, RoPE base, sink, window)
MIMO_KINDS = (("full", 4, 5e6, False, None), ("window", 8, 1e4, True, 128))
#: a grouped-query kernel vs its plain version, |got - want| / |want| in
#: norm: the same fp32 products summed in another order, K's and V's
#: gradients over up to G * L = 65,536 terms (the plain version's atomics
#: in any order), which err by up to about sqrt(65,536) * 2^-24 = 1.5e-5
#: of their scale: the full layer's dV reads 2.0e-6 on an H100 (the card
#: tests' 2e-6 is for L = 1024); a key head read from another group, a
#: sink left out or a group's gradient short of one head is off by 6e-2
#: to O(1)
MIMO_NORM_REL = 1e-5
#: RoPE vs its plain version, max abs err / max |plain|: the same rounded
#: products and sums
ROPE_REL = 1e-6
MIMO_ITERS = 5          # timed kernel calls, after 2 warm-ups
MIMO_PLAIN_ITERS = 1    # and plain calls (their check warmed them up)


def norm_rel(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def mimo_launch_want(core, backward):
    """One MiMo layer's launches of the kernels this phase holds to their
    plain versions (the projections' are the card tests'): the forward's,
    or the backward's."""
    from sddmm_tpu_torch import _kernels
    res = int(bool(core.runner.packed.nnz_res))
    gather = "sddmm_gather_dot_float32_float32"
    if backward:   # dP, dV with the group sum (+ the residual's two), B1
        return {_kernels.ROPE_ENTRY: 1, _kernels.SOFTMAX_BWD_ENTRY: 1,
                gather: 1, _kernels.SPMM_ENTRY: 1 + 2 * res,
                _kernels.TILE_GRAD_ENTRY: 1,
                _kernels.TILE_GRAD_REDUCE_ENTRY: 1}
    want = {_kernels.ROPE_ENTRY: 1, "sddmm_tile_dot_float32": 1,
            _kernels.SOFTMAX_ENTRY: 1, _kernels.SPMM_ENTRY: 1}
    if res:
        want[gather] = 1
    return want


def mimo_kernel_times(torch, label, kernel, plain, nbytes, flops, card):
    """``kernel()`` and ``plain()`` timed (CUDA events) beside the bound of
    ``nbytes`` and ``flops`` (at the "float32" peak, 989/6 TFLOP/s): the
    record's numbers, with no library call."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    tk = cuda_time_ms(kernel, MIMO_ITERS, warmup=2)
    tp = cuda_time_ms(plain, MIMO_PLAIN_ITERS, warmup=0)
    bnd = bound_times(nbytes, flops, BF16_FLOPS / 6)
    say(f"[time] {label}: kernels {tk['median_ms']:.4f} ms (min "
        f"{tk['min_ms']:.4f}, max {tk['max_ms']:.4f}, n {tk['n']}), plain "
        f"{tp['median_ms']:.4f} ms, bound {max(bnd.values()):.4f} ms (by "
        f"{'bytes' if bnd['bytes_ms'] >= bnd['ops_ms'] else 'operations'}) "
        f"= {100 * max(bnd.values()) / tk['median_ms']:.1f} % of it on "
        f"{card}")
    return {"ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": None, **bnd}


def check_mimo_ops(torch, layer, core, x, card):
    """A MiMo layer's new kernel paths at its shapes, each against its plain
    version and timed: the scores of 64 query heads against the key heads
    h >> s read in place and their backward (tile kernel, residual
    gather-dot, tile-grad with the group's dK summed); the softmax (with the
    sink in a window layer) forward and backward, the sinks' gradient
    included; the aggregation against V of the group and its backward (dP
    by the gather-dot, dV summing the group); RoPE forward and backward.
    Returns {part: numbers} for the record."""
    from sddmm_tpu_torch.models import hybrid_attention as ha
    from sddmm_tpu_torch.ops import rope as rp
    from sddmm_tpu_torch.ops import softmax as sm
    from sddmm_tpu_torch.ops import spmm as sp
    mm = MIMO
    L, H, D, Dv = mm["seq_len"], mm["heads"], mm["head_dim"], mm["v_head_dim"]
    R = mm["rotary"]
    kind = layer.kind
    g = torch.Generator(device=DEVICE).manual_seed(13)
    with torch.no_grad():
        q, k, v = ha.qkv_project(x, layer.w_q, layer.w_k, layer.w_v,
                                 v_scale=layer.value_scale)
    hkv, nnz = k.shape[0], core.nnz
    out = {}

    def grads(fn, leaves, cot, plain):
        ls = [t.clone().requires_grad_() for t in leaves]
        res = fn(*ls, plain)
        torch.autograd.backward(res, cot)
        torch.cuda.synchronize()
        return [r.detach() for r in
                (res if isinstance(res, tuple) else (res,))] + [
                    t.grad for t in ls]

    def held(part, fn, leaves, cot, names):
        got, want = (grads(fn, leaves, cot, p) for p in (False, True))
        errs = {n: norm_rel(a, b) for n, a, b in zip(names, got, want)}
        say(f"[mimo] {kind} {part} vs plain, |got - want| / |want|: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {MIMO_NORM_REL})")
        if not max(errs.values()) <= MIMO_NORM_REL:
            fail(f"MiMo {kind} {part}: {errs} vs plain > {MIMO_NORM_REL}")
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    def timed(part, fn, leaves, cot, nbytes, flops):
        ls = [t.clone().requires_grad_() for t in leaves]

        def run(plain=False):
            res = fn(*ls, plain)
            torch.autograd.grad(res, ls, cot)
        return mimo_kernel_times(
            torch, f"MiMo {kind} {part} forward + backward", run,
            lambda: run(True), nbytes, flops, card)

    # RoPE (in place forward, inverse into new tensors backward)
    with torch.no_grad():
        qr, kr = rp.apply_rope(q.clone(), k.clone(), core.table)
    gq, gk = (torch.randn(t.shape, generator=g, device=DEVICE)
              for t in (q, k))
    checks = [(qr, rp.rope_plain(q, core.table)),
              (kr, rp.rope_plain(k, core.table))]
    with torch.enable_grad():
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        torch.autograd.backward(rp.apply_rope(qq * 1, kk * 1, core.table),
                                (gq, gk))
    checks += [(qq.grad, rp.rope_plain(gq, core.table, True)),
               (kk.grad, rp.rope_plain(gk, core.table, True))]
    rope_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in checks)
    untouched = (torch.equal(qr[:, :, R:], q[:, :, R:])
                 and not bool(qr[:, L].any()) and not bool(kr[:, L].any()))
    say(f"[mimo] {kind} RoPE forward and backward vs plain: max abs err / "
        f"max |plain| {rope_rel:.3e} (tol {ROPE_REL}); dims {R}.. and the "
        f"sentinel row untouched: {untouched}")
    if not rope_rel <= ROPE_REL or not untouched:
        fail(f"MiMo {kind} RoPE: {rope_rel:.3e} vs plain, or the unrotated "
             "dims or the sentinel row changed")
    rope_err = max(float((a - b).abs().max()) for a, b in checks)
    del checks, qq, kk

    # the two launches alone (forward in place, backward into new tensors)
    qw, kw = qr.clone(), kr.clone()
    dq, dk = torch.empty_like(gq), torch.empty_like(gk)

    def rope_kernels():
        rp._launch((qw, kw), (qw, kw), core.table, False)
        rp._launch((gq, gk), (dq, dk), core.table, True)

    def rope_plains():
        for t, inverse in ((qw, False), (kw, False), (gq, True),
                           (gk, True)):
            rp.rope_plain(t, core.table, inverse)
    # the rotated dims read and written once, forward and backward, with
    # the table (the rest is the identity: the backward's copy of it is
    # the kernel's own cost)
    rope_bytes = 2 * (2 * (H + hkv) * L * R * 4 + L * R * 4)
    out["rope"] = {"err": rope_err, **mimo_kernel_times(
        torch, f"MiMo {kind} RoPE forward + backward launches",
        rope_kernels, rope_plains, rope_bytes, 0.0, card)}
    del qw, kw, dq, dk, gq, gk

    # the scores against the key head of the group, and their backward
    def scores(a, b, plain):
        return core.batched.run_padded(a, b, order="csr", plain=plain)

    gs = torch.randn((H, nnz), generator=g, device=DEVICE)
    err = held("scores (head shift) and tile-grad", scores, [qr, kr], gs,
               ["scores", "dQ", "dK"])
    nbytes = 4 * (3 * (H + hkv) * L * D + 2 * H * nnz)
    out["scores"] = {"err": err, **timed("scores", scores, [qr, kr], gs,
                                         nbytes, 6.0 * H * nnz * D)}
    del gs

    # the softmax, with the sink in a window layer
    flat = torch.randn((H, core.runner.packed.packed_size), generator=g,
                       device=DEVICE) * 4
    sink = (torch.randn(H, generator=g, device=DEVICE) * 2
            if layer.sink is not None else None)
    gp = torch.randn((H, nnz), generator=g, device=DEVICE)
    leaves = [flat] + ([sink] if sink is not None else [])

    def softmax(f, *rest):
        *s, plain = rest
        return sm.segment_softmax_sink(f, s[0] if s else None, core.row_ptr,
                                       D ** -0.5, core.runner.inv_idx32,
                                       core.softmax_plan, plain)

    err = held("softmax" + (" with the sink" if sink is not None else ""),
               softmax, leaves, gp, ["p", "d scores", "d sink"])
    with torch.no_grad():
        p = softmax(flat, *leaves[1:], False)
    if sink is not None:
        mass = torch.zeros(H * L, dtype=torch.float64, device=DEVICE)
        mass.index_add_(0, sm._head_rows(core.row_ptr, H, DEVICE),
                        p.reshape(-1).double())
        say(f"[mimo] {kind} softmax: the largest row's mass without its "
            f"sink {float(mass.max()):.6f} (< 1)")
        if not float(mass.max()) < 1.0:
            fail(f"MiMo {kind} softmax: a row's mass without its sink is "
                 f"{float(mass.max())}")
    # p and the packed scores read, p written; g, p read and the packed
    # gradient written; the sinks' row shares
    nbytes = 4 * H * (2 * core.runner.packed.packed_size + 3 * nnz
                      + (3 * L if sink is not None else 0))
    out["softmax"] = {"err": err, **timed("softmax", softmax, leaves, gp,
                                          nbytes, 0.0)}
    del flat, gp

    # the aggregation against V of the group, and its backward
    go = torch.randn((H, L, Dv), generator=g, device=DEVICE)
    v3 = v.view(hkv, L, Dv)

    def aggregate(pp, vv, plain):
        return sp.head_spmm(pp, vv, core.agg, plain)

    err = held("aggregation (head shift, dV summing the group)", aggregate,
               [p, v3], go, ["out", "dP", "dV"])
    nbytes = 4 * (3 * H * nnz + 3 * hkv * L * Dv + 2 * H * L * Dv)
    out["aggregate"] = {"err": err, **timed(
        "aggregation", aggregate, [p, v3], go, nbytes, 6.0 * H * nnz * Dv)}
    return out


def run_mimo(torch, card):
    """The MiMo phase: one full and one window layer at the published widths
    and L = 4096 (each kind's mask packed once): each layer's forward and
    backward with the launch counters zeroed just before (the new kernels'
    exact launches), its output against the fp64 reference
    (``models.mimo_reference``) under the contract and against the plain
    path, then ``check_mimo_ops``.  Returns the launches of the two layers'
    forward and backward and the record's numbers by kernel."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.models import (AttentionKind, HybridAttentionStack,
                                        mimo_reference)
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    mm = MIMO
    kinds = [AttentionKind(*k) for k in MIMO_KINDS]
    t0 = time.perf_counter()
    stack = HybridAttentionStack(
        mm["seq_len"], [k.name for k in kinds], kinds, mm["hidden"],
        mm["heads"], mm["head_dim"], mm["v_head_dim"], mm["rotary"],
        mm["value_scale"], device=DEVICE)
    say(f"[pack] MiMo layers: {time.perf_counter() - t0:.1f} s to pack "
        "both masks")
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    stack.init(gen)
    x = torch.randn((mm["seq_len"], mm["hidden"]), generator=gen,
                    device=DEVICE)
    cfg = {"rotary_dim": mm["rotary"], "value_scale": mm["value_scale"]}
    launches, parts = {}, {}
    for layer, kind in zip(stack.layers, kinds):
        core = stack.cores[kind.name]
        p = core.runner.packed
        label = f"MiMo {kind.name} layer"
        say(f"[pack] {label}: {core.nnz} entries a head, packed "
            f"{p.packed_size} slots, residual {p.nnz_res}, {kind.kv_heads} "
            f"key/value heads for {mm['heads']} query heads")
        xx = x.clone().requires_grad_()
        torch.cuda.synchronize()
        _kernels.launches.clear()
        y = layer(xx)
        torch.cuda.synchronize()
        fwd = dict(_kernels.launches)
        _kernels.launches.clear()
        y.square().mean().backward()
        torch.cuda.synchronize()
        bwd = dict(_kernels.launches)
        say(f"[mimo] {label} launches: forward {fwd}; backward {bwd}")
        for got, backward in ((fwd, False), (bwd, True)):
            want = mimo_launch_want(core, backward)
            seen = {n: got.get(n, 0) for n in want}
            if seen != want:
                fail(f"{label} {'backward' if backward else 'forward'}: "
                     f"launches {seen}, want {want}")
            for n, c in got.items():
                launches[n] = launches.get(n, 0) + c
        if not all(w.grad is not None and bool(torch.isfinite(w.grad).all())
                   for w in layer.parameters()):
            fail(f"{label}: a weight's gradient is missing or not finite")
        del xx, y
        layer.zero_grad(set_to_none=True)
        weights = {n: w.detach().double()
                   for n, w in layer.named_parameters()}
        ref_kind = dict(kv_heads=kind.kv_heads, rope_theta=kind.rope_theta,
                        window=kind.window, sink=kind.sink)
        check_model(torch, f"{label} (L {mm['seq_len']}, {mm['heads']} "
                    f"heads over {kind.kv_heads})", layer, x,
                    lambda: mimo_reference.attention(x.double(), weights,
                                                     ref_kind, cfg))
        del weights

        def step():
            layer(x).square().mean().backward()
        t = cuda_time_ms(step, 3, warmup=1)
        layer.zero_grad(set_to_none=True)
        say(f"[time] {label} forward + backward (weights' gradients): "
            f"median {t['median_ms']:.3f} ms (n {t['n']}) on {card}")
        for part, nums in check_mimo_ops(torch, layer, core, x,
                                         card).items():
            parts.setdefault(part, []).append(nums)
        torch.cuda.empty_cache()
    del stack, x, layer, core
    torch.cuda.empty_cache()
    rec = {}
    for part, nums in parts.items():
        rec[part] = new_record(0.0)
        for n in nums:
            add_times({part: rec[part]}, {part: n})
    return launches, rec


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
    the fp64 dots of a few entries, beforehand); a (H, m, K) and bt (H, n,
    K): H heads at the one pattern, a call a head."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    if a.dim() == 2:
        a, bt = a[None], bt[None]
    order = torch.argsort(rows.long() * bt.shape[1] + cols.long())
    r, c = rows.long()[order], cols.long()[order]
    crow = torch.searchsorted(r, torch.arange(a.shape[1] + 1,
                                              device=r.device))
    s = torch.sparse_csr_tensor(crow, c, torch.zeros(r.numel(),
                                                     device=r.device),
                                size=(a.shape[1], bt.shape[1]))
    mat2 = bt.transpose(1, 2)

    def run():
        return [torch.sparse.sampled_addmm(s, a[h], mat2[h], beta=0.0)
                for h in range(a.shape[0])]

    got = run()[-1]
    k = min(1000, r.numel())
    want = (a[-1, r[:k]].double() * bt[-1, c[:k]].double()).sum(dim=1)
    if not float(((got.values()[:k].double() - want).abs()
                  / want.abs().clamp_min(1e-30)).max()) <= 1e-3:
        fail("torch.sparse.sampled_addmm does not compute the same function")
    return cuda_time_ms(run, iters)["median_ms"]


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


def pad_rows(torch, x):
    """(..., M, K) -> (..., M+1, K) with a zero row: the runners' pads."""
    return torch.nn.functional.pad(x, (0, 0, 0, 1))


def rel_nonzero(got, want) -> float:
    """max |got - want| / |want| over want != 0; inf if got is not 0 where
    want is."""
    nz = want != 0
    if bool(got[~nz].any()):
        return float("inf")
    return float(((got[nz] - want[nz]).abs() / want[nz].abs()).max())


def b1_launches(runner):
    """B1's launches a backward: the tile-grad kernel and its reduction for
    all heads and chunks, and the residual's two SpMMs where the packing
    has a residual."""
    from sddmm_tpu_torch import _kernels
    want = {_kernels.TILE_GRAD_ENTRY: 1, _kernels.TILE_GRAD_REDUCE_ENTRY: 1}
    if runner.packed.nnz_res:
        want[_kernels.SPMM_ENTRY] = 2
    return want


def grad_index_line(runner):
    """The backward index's size and host seconds, for the [grad] lines."""
    idx, res = runner.grad_state()
    return (f"{runner.table.n_entries} table entries in "
            f"{idx.n_units_a} dA + {idx.units.shape[0] - idx.n_units_a} dB^T "
            f"units, {idx.partials} partial rows, "
            f"{0 if res is None else res[0].n_entries} residual entries; "
            f"built in {runner.grad_pattern_seconds:.3f} s on the host")


def check_backward(torch, label, runner, csr, a_np, b_np, heads):
    """B1 on one packing, ``heads`` heads through ``BatchedHybridSDDMM``:
    the first backward builds the backward index (host seconds printed);
    each backward is the tile-grad kernel, its reduction and, with a
    residual, 2 SpMM launches (counted around ``backward()`` alone); no
    per-slot read pattern is built; with a U[0,2) cotangent on every packed
    slot the kernel's gradients equal the plain Function's
    (``tile_table_grad_plain``, the plain SpMM) within BACKWARD_REL and a
    second backward is bit-equal; with one on the real slots they pass the
    contract against fp64 scipy (G ⊙ S)·B and (G ⊙ S)^T·A.  Returns (max
    rel vs plain, max abs vs plain)."""
    import numpy as np
    import scipy.sparse as sps
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops.batch import BatchedHybridSDDMM
    from sddmm_tpu_torch.utils.check import check_values
    p = runner.packed
    a = torch.as_tensor(a_np, device=DEVICE)
    bt = torch.as_tensor(np.ascontiguousarray(b_np.T), device=DEVICE)
    a = torch.stack([a, a.flip(0)][:heads])
    bt = torch.stack([bt, bt.flip(0)][:heads])
    batched = BatchedHybridSDDMM(runner)

    def grads(g, order, plain=False, launched=None):
        a_t, b_t = a.clone().requires_grad_(), bt.clone().requires_grad_()
        out = batched.run_padded(pad_rows(torch, a_t), pad_rows(torch, b_t),
                                 order=order, plain=plain)
        torch.cuda.synchronize()
        before = dict(_kernels.launches)
        out.backward(g)
        torch.cuda.synchronize()
        if launched is not None:
            launched.update({n: c - before.get(n, 0)
                             for n, c in _kernels.launches.items()
                             if c > before.get(n, 0)})
        return a_t.grad, b_t.grad

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    g_all = torch.rand((heads, p.packed_size), generator=gen,
                       device=DEVICE) * 2
    launched = {}
    ka, kb = grads(g_all, "packed", launched=launched)
    want = b1_launches(runner)
    if launched != want:
        fail(f"{label} backward: launches {launched}, want {want}")
    if runner._read_grad is not None:
        fail(f"{label} backward built the per-slot read pattern")
    say(f"[grad] {label}: backward index of {p.packed_size} slots: "
        f"{grad_index_line(runner)}; workspace "
        f"{heads * runner.grad_state()[0].partials * a.shape[-1] * 4 / 1e6:.1f}"
        " MB a backward")
    ka2, kb2 = grads(g_all, "packed")
    pa, pb = grads(g_all, "packed", plain=True)
    torch.cuda.synchronize()
    if not (torch.equal(ka, ka2) and torch.equal(kb, kb2)):
        fail(f"{label}: two backward passes differ")
    rel = max(rel_nonzero(ka, pa), rel_nonzero(kb, pb))
    err = max(float((ka - pa).abs().max()), float((kb - pb).abs().max()))
    if not rel <= BACKWARD_REL:
        fail(f"{label} backward: max rel {rel:.3e} vs the plain Function > "
             f"{BACKWARD_REL}")
    del ka2, kb2, pa, pb, g_all
    g = torch.rand((heads, csr.nnz), generator=gen, device=DEVICE) * 2
    ka, kb = grads(g, "csr")
    worst = None
    for h in range(heads):
        s = sps.csr_matrix((g[h].double().cpu().numpy(), csr.col_idx,
                            csr.row_ptr), shape=csr.shape)
        for name, got, want in (
                ("dA", ka[h], s @ bt[h].double().cpu().numpy()),
                ("dB^T", kb[h], s.T @ a[h].double().cpu().numpy())):
            res = check_values(want, got.cpu().numpy())
            worst = res if worst is None or (
                res.max_rel_err > worst.max_rel_err) else worst
            if not res.passed or res.num_errors:
                fail(f"{label} {name} vs fp64: {res}")
    say(f"[grad] {label} ({heads} head(s), G={p.group_size}, "
        f"C={runner.k_chunks}, {runner.a_layout}): launches a backward "
        f"{launched}; vs the plain Function max rel {rel:.3e} (tol "
        f"{BACKWARD_REL}); repeat bit-equal; vs fp64 (cotangent on the "
        f"real slots), worst {worst}")
    return rel, err


def b1_work(runner, a_pad, bt_phys, g):
    """B1's bound as the work's, not an implementation's: g, A and B^T
    read once, dA and dB^T written once (no index), and the operations:
    every table cell's two products of K (dA and dB^T, 2 flops each) in
    the six bf16 products of the "float32" split on the tensor cores, and
    the residual's in fp32."""
    ent = runner.table.entries.cpu()
    cells = int((ent[:, 1] * ent[:, 4]).sum())
    H, K = a_pad.shape[0], a_pad.shape[-1]
    nbytes = 4 * g.numel() + 8 * a_pad.numel() + 8 * bt_phys.numel()
    ops_ms = (4.0 * H * cells * K * 6 / BF16_FLOPS
              + 4.0 * H * runner.packed.nnz_res * K / FP32_FLOPS) * 1e3
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops_ms}


def time_hybrid_backward(torch, label, runner, a_pad, bt_phys, g, card):
    """B1 at one packing, in one call: its launches (``vjp``: the
    tile-grad kernel, its reduction and the residual's SpMMs) beside the
    read-pattern route (``vjp_read_pattern``: two SpMMs over every packed
    slot), the plain version (``vjp(plain=True)``) and, at one head,
    ``torch.sparse.mm`` of the read pattern (one call each for P·B and
    P^T·A); the bound recounted as the work's (``b1_work``) beside the
    read-pattern route's fp32 operations bound.  Returns the record's
    numbers (library null above one head)."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    H, C, ng1, gk = bt_phys.shape
    m1, K = a_pad.shape[1:]
    kc = K // C
    lanes = ng1 * (gk // kc)
    da, db = runner.vjp(a_pad, bt_phys, g)
    ra, rb = runner.vjp_read_pattern(a_pad, bt_phys, g)
    pa, pb = runner.grad_patterns()
    qa, qb = runner.vjp(a_pad, bt_phys, g, plain=True)
    torch.cuda.synchronize()
    rel = max(rel_nonzero(da, qa), rel_nonzero(db, qb))
    rel_route = max(rel_nonzero(da, ra), rel_nonzero(db, rb))
    if not max(rel, rel_route) <= BACKWARD_REL:
        fail(f"{label} B1: max rel {rel:.3e} vs plain, {rel_route:.3e} vs "
             "the read-pattern route")
    err = max(float((da - qa).abs().max()), float((db - qb).abs().max()))
    mats = lib = None
    if H == 1 and C == 1:
        b2 = bt_phys.view(lanes, kc)
        mats = []
        for pat, ncols in ((pa, lanes), (pb, m1)):
            # garbage slots repeat (row, lane) pairs: coalesced (summed)
            # first, as a CSR tensor must not repeat a column in a row
            vals = g[0] if pat.vidx is None else g[0, pat.vidx.long()]
            mats.append(torch.sparse_coo_tensor(
                torch.stack([pat.rows, pat.cols.long()]),
                vals[:pat.n_entries], size=(pat.num_rows, ncols)
            ).coalesce().to_sparse_csr())
        lib = (torch.sparse.mm(mats[0], b2), torch.sparse.mm(mats[1],
                                                             a_pad[0]))
        torch.cuda.synchronize()
        for got, want in ((da[0], lib[0]), (db.view(lanes, kc), lib[1])):
            if not rel_nonzero(got, want) <= BACKWARD_REL:
                fail(f"{label}: torch.sparse.mm of the read pattern does not "
                     "compute the same function")
    del da, db, ra, rb, qa, qb, lib
    tk = cuda_time_ms(lambda: runner.vjp(a_pad, bt_phys, g), 10)
    tr = cuda_time_ms(lambda: runner.vjp_read_pattern(a_pad, bt_phys, g), 10)
    tp = cuda_time_ms(lambda: runner.vjp(a_pad, bt_phys, g, plain=True), 3,
                      warmup=1)
    tl = None if mats is None else cuda_time_ms(
        lambda: (torch.sparse.mm(mats[0], b2),
                 torch.sparse.mm(mats[1], a_pad[0])), 10)["median_ms"]
    bnd = b1_work(runner, a_pad, bt_phys, g)
    # the read-pattern route's bound as first counted: its P and P^T
    # entries' fp32 products
    old_ops = 2.0 * (pa.n_entries + pb.n_entries) * H * kc / FP32_FLOPS * 1e3
    idx, _ = runner.grad_state()
    ws_mb = H * idx.partials * K * 4 / 1e6
    say(f"[time] {label} hybrid backward B1 ({H} head(s), K={K}, C={C}; "
        f"{runner.table.n_entries} entries, {idx.units.shape[0]} units, "
        f"workspace {ws_mb:.1f} MB; vs plain {rel:.3e}, vs the read-pattern "
        f"route {rel_route:.3e}): tile-grad kernels {tk['median_ms']:.4f} ms "
        f"(min {tk['min_ms']:.4f}, max {tk['max_ms']:.4f}), read-pattern "
        f"route (2 x {pa.n_entries} SpMM entries, patterns built in "
        f"{runner.read_pattern_seconds:.3f} s on the host) "
        f"{tr['median_ms']:.4f} ms, "
        f"plain {tp['median_ms']:.4f} ms, torch.sparse.mm of the read "
        f"pattern " + (f"{tl:.4f} ms" if tl is not None else "n/a")
        + f"; bound {max(bnd.values()):.4f} ms (bytes "
        f"{bnd['bytes_ms']:.4f}, tensor-core ops {bnd['ops_ms']:.4f}) = "
        f"{100 * max(bnd.values()) / tk['median_ms']:.1f} % of it; the read "
        f"pattern's fp32-ops bound {old_ops:.4f} ms; kernels "
        f"{tr['median_ms'] / tk['median_ms']:.2f}x faster than the "
        f"read-pattern route on {card}")
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl, **bnd}


def time_csr_backward(torch, label, csr, a, bt, plan, card):
    """B4: csr_sddmm_torch's backward on one cell's CSR baseline operands.
    Its path: one forward, then the counts zeroed just before the user's
    ``backward()`` and read just after (2 SpMM launches, over the pattern
    and its transpose, built at that first backward and kept on the CSR
    baseline's ``plan``).  Its record: the two
    launches beside their plain versions and torch.sparse.mm of (g ⊙ S)
    and of its transpose.  Returns (launches, record)."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm_torch
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    rows = torch.as_tensor(csr.row_indices(), dtype=torch.int32,
                           device=DEVICE)
    cols = torch.as_tensor(csr.col_idx, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    g = torch.rand((1, csr.nnz), generator=gen, device=DEVICE) * 2
    a_t, bt_t = a.clone().requires_grad_(), bt.clone().requires_grad_()
    out = csr_sddmm_torch(a_t, bt_t, rows, cols, plan)
    torch.cuda.synchronize()
    _kernels.launches.clear()
    out.backward(g[0])
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    if counts != {_kernels.SPMM_ENTRY: 2}:
        fail(f"{label} csr_sddmm backward: launches {counts}")
    grads = plan.grads
    da = torch.empty((1, 1) + tuple(a.shape), device=DEVICE)
    db = torch.empty((1, 1) + tuple(bt.shape), device=DEVICE)

    def kernel(plain=False):
        grads.spmm(g, bt[None, None], da, plain)
        grads.spmm_t(g, a[None, None], db, plain)

    kernel(plain=True)
    torch.cuda.synchronize()
    rel = max(rel_nonzero(a_t.grad, da[0, 0]), rel_nonzero(bt_t.grad,
                                                            db[0, 0]))
    if not rel <= BACKWARD_REL:
        fail(f"{label} csr_sddmm backward: max rel {rel:.3e} vs plain")
    err = float(max((a_t.grad - da[0, 0]).abs().max(),
                    (bt_t.grad - db[0, 0]).abs().max()))
    row_ptr = torch.as_tensor(csr.row_ptr, device=DEVICE)
    s = torch.sparse_csr_tensor(row_ptr, cols.long(), g[0], size=csr.shape)
    st = s.to_sparse_coo().t().to_sparse_csr()
    tk = cuda_time_ms(kernel, 10)
    tp = cuda_time_ms(lambda: kernel(plain=True), 3, warmup=1)
    tl = cuda_time_ms(lambda: (torch.sparse.mm(s, bt),
                               torch.sparse.mm(st, a)), 10)
    K = a.shape[1]
    # g read once, A and B^T read and dA, dB^T written once, the pattern
    # once: each entry's row and column, int32 each
    nbytes = 4 * csr.nnz + 8 * (a.numel() + bt.numel()) + 8 * csr.nnz
    bnd = bound_times(nbytes, 4.0 * csr.nnz * K, FP32_FLOPS)
    say(f"[time] {label} csr_sddmm backward B4 (2 x sddmm_csr_spmm_float32, "
        f"{csr.nnz} entries, K={K}, max rel vs plain {rel:.3e}): kernel "
        f"{tk['median_ms']:.4f} ms, plain {tp['median_ms']:.4f} ms, "
        f"torch.sparse.mm of S and S^T {tl['median_ms']:.4f} ms, bound "
        f"{max(bnd.values()):.4f} ms on {card}")
    return counts, {"err": err, "ms": tk["median_ms"],
                    "plain_ms": tp["median_ms"],
                    "library_ms": tl["median_ms"], **bnd}


def time_aggregation_backward(torch, label, model, heads, d, card):
    """B3's two records at one model's shapes, all heads in one launch
    each: the attention's cotangent (the gather-dot at the pattern, beside
    ``sampled_addmm``, a call a head) and V's (the SpMM on the transpose,
    beside ``torch.sparse.mm``, a call a head), each beside its plain
    version and its bound."""
    from sddmm_tpu_torch.ops import hybrid as hy
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    agg = model.core.agg
    grads, H = agg.grads, heads
    m, n = grads.shape
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    nnz = agg.cols.shape[0]
    attn = torch.rand((H, nnz), generator=gen, device=DEVICE)
    v = torch.rand((H, n, d), generator=gen, device=DEVICE)
    dout = torch.rand((H, m, d), generator=gen, device=DEVICE)
    dv = torch.empty((H, 1, n, d), device=DEVICE)
    rows32, cols32, _ = grads.gather_index
    out = {}

    def d_values():
        return grads.sddmm(dout, v)

    def d_values_plain():
        return torch.stack([hy.residual_gather_dot_plain(
            dout[h], v[h], rows32, cols32) for h in range(H)])

    def d_dense(plain=False):
        return grads.spmm_t(attn, dout[:, None], dv, plain)

    got, want = d_values(), d_values_plain()
    torch.cuda.synchronize()
    rel = rel_nonzero(got, want)
    if not rel <= BACKWARD_REL:
        fail(f"{label} B3 d values: max rel {rel:.3e} vs plain")
    lib = sampled_addmm_ms(torch, dout, v, agg.rows, agg.cols, 10)
    nbytes = 4 * H * nnz + 4 * H * d * (m + n) + 8 * nnz
    bnd = bound_times(nbytes, 2.0 * H * nnz * d, FP32_FLOPS)
    out["B3 values"] = {"err": float((got - want).abs().max()),
                        "ms": cuda_time_ms(d_values, 10)["median_ms"],
                        "plain_ms": cuda_time_ms(d_values_plain, 3,
                                                 warmup=1)["median_ms"],
                        "library_ms": lib, **bnd}
    got = d_dense().clone()
    want = d_dense(plain=True).clone()
    torch.cuda.synchronize()
    rel2 = rel_nonzero(got, want)
    if not rel2 <= BACKWARD_REL:
        fail(f"{label} B3 d dense: max rel {rel2:.3e} vs plain")
    st = [s.to_sparse_coo().t().to_sparse_csr()
          for s in head_csrs(torch, agg, attn)]

    def library():
        return torch.stack([torch.sparse.mm(s, dout[h])
                            for h, s in enumerate(st)])

    lib = library()
    if not rel_nonzero(got[:, 0], lib) <= BACKWARD_REL:
        fail(f"{label}: torch.sparse.mm of S^T does not compute the same "
             "function")
    # as d values': the heads' attention and dOut read, dV written, the
    # pattern (row and column, int32 each) read once for all heads
    nbytes = 4 * H * nnz + 4 * H * d * (m + n) + 8 * nnz
    bnd = bound_times(nbytes, 2.0 * H * nnz * d, FP32_FLOPS)
    out["B3 dense"] = {"err": float((got - want).abs().max()),
                       "ms": cuda_time_ms(d_dense, 10)["median_ms"],
                       "plain_ms": cuda_time_ms(lambda: d_dense(True), 3,
                                                warmup=1)["median_ms"],
                       "library_ms": cuda_time_ms(library, 10)["median_ms"],
                       **bnd}
    for key, what, lname in (("B3 values", "gather-dot, d values",
                              "sampled_addmm"),
                             ("B3 dense", "SpMM on S^T, d V",
                              "torch.sparse.mm")):
        r = out[key]
        say(f"[time] {label} aggregation backward B3 ({what}; {H} head(s) "
            f"x {nnz} entries, K={d}, max rel vs plain "
            f"{max(rel, rel2):.3e}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, {lname} {r['library_ms']:.4f} ms, "
            f"bound {max(r['bytes_ms'], r['ops_ms']):.4f} ms on {card}")
    return out


def time_softmax_backward(torch, sm, label, model, heads, d, card):
    """B2's record at one model's shapes: the softmax backward kernel
    (one launch, written at inv_idx into the zeroed packed gradient)
    beside its plain version and ``torch._sparse_softmax_backward_data``
    on COO tensors of the same p and g (the op behind torch.sparse.softmax's
    backward; a call a head, the scale applied outside the timed call, as
    K10's yardstick does)."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    core = model.core
    runner, H = core.runner, heads
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    F = runner.packed.packed_size
    flat = torch.randn((H, F), generator=gen, device=DEVICE) * 4
    inv, scale = runner.inv_idx32, 1.0 / d ** 0.5
    p = sm.segment_softmax_torch(flat, core.row_ptr, scale, inv,
                                 core.softmax_plan)
    g = torch.randn(p.shape, generator=gen, device=DEVICE)

    def kernel(plan=core.softmax_plan):
        return sm.segment_softmax_backward(p, g, core.row_ptr, scale, inv,
                                           F, plan)

    def plain():
        return sm.segment_softmax_backward_plain(p, g, core.row_ptr, scale,
                                                 inv, F)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    rel = backward_rel(sm, got, want, p, g, core.row_ptr, scale, inv)
    if not rel <= SOFTMAX_REL_TOL:
        fail(f"{label} softmax backward: |kernel - plain| over its terms "
             f"{rel:.3e} at the worst entry")
    err = float((got - want).abs().max())

    p_c, g_c, x_c = (head_coos(torch, core.agg, x)
                     for x in (p, g, flat[:, inv.long()] * scale))

    def library():
        return [torch._sparse_softmax_backward_data(gc, pc, 1, xc)
                for gc, pc, xc in zip(g_c, p_c, x_c)]

    lib = torch.stack([c.values() for c in library()]) * scale
    at_inv = got[:, inv.long()]
    lib_rel = float((lib - at_inv).abs().max() / at_inv.abs().max())
    if not lib_rel <= BACKWARD_REL:
        fail(f"{label}: torch._sparse_softmax_backward_data does not compute "
             f"the same function (max |diff| / max |kernel| {lib_rel:.3e})")
    del got, want, lib, at_inv
    tk = cuda_time_ms(kernel, 20)
    tp = cuda_time_ms(plain, 5)
    tl = cuda_time_ms(library, 20)
    nnz = inv.numel()
    # p and g read once, inv_idx and the row pointers once, every packed
    # slot written once (the zeroed gradient)
    nbytes = 8 * H * nnz + 4 * nnz + 8 * core.row_ptr.numel() + 4 * H * F
    bnd = bound_times(nbytes, 4.0 * H * nnz, FP32_FLOPS)
    say(f"[time] {label} sddmm_segment_softmax_backward_float32 ({H} "
        f"head(s) x {nnz} entries into {F} slots, |kernel - plain| over "
        f"its terms {rel:.3e} at the worst entry): kernel {tk['median_ms']:.4f} ms, plain "
        f"{tp['median_ms']:.4f} ms, torch._sparse_softmax_backward_data (a "
        "call a head) "
        f"{tl['median_ms']:.4f} ms (max |diff| / max |kernel| "
        f"{lib_rel:.3e}), bound {max(bnd.values()):.4f} ms = "
        f"{100 * max(bnd.values()) / tk['median_ms']:.1f} % of it on {card}")
    class_times(f"{label} sddmm_segment_softmax_backward_float32",
                kernel, core.softmax_plan, card)
    return {"err": err, "ms": tk["median_ms"], "plain_ms": tp["median_ms"],
            "library_ms": tl["median_ms"], **bnd}


def op_launches(torch, loss, ops=("_HybridFnBackward", "_SoftmaxFnBackward",
                                  "_HeadSpmmFnBackward")):
    """``{op: {kernel: launches}}``, filled while ``loss.backward()`` runs:
    hooks on the nodes of ``loss``'s graph of the port's autograd ops
    ``ops`` read the launch counts just before and just after each node's
    backward, so each kernel's launches are told apart by the op that made
    them."""
    from sddmm_tpu_torch import _kernels
    counts = {op: {} for op in ops}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
        op = type(node).__name__
        if op not in counts:
            continue
        before = {}

        def pre(grad_out, before=before):
            before.clear()
            before.update(_kernels.launches)

        def post(grad_in, grad_out, before=before, into=counts[op]):
            for name, c in _kernels.launches.items():
                if c > before.get(name, 0):
                    into[name] = into.get(name, 0) + c - before.get(name, 0)

        node.register_prehook(pre)
        node.register_hook(post)
    return counts


def model_grads(torch, model, x, plain=False):
    """The weight gradients of sum(out^2) through ``model``."""
    model.zero_grad()
    model(x, plain=plain).square().sum().backward()
    return [w.grad.clone() for w in model.parameters()]


def check_model_grads(torch, label, model, x, kernel_grads, golden_fn):
    """A model's kernel-path weight gradients against its plain path's
    (max abs diff / max |plain| per weight, MODEL_PLAIN_TOL) and against
    autograd of an fp64 reference (max abs err / max |exact| per weight,
    GRAD_FP64_TOL: each is a sum over every position of terms of both
    signs, so no elementwise contract holds near its zeros)."""
    plain = model_grads(torch, model, x, plain=True)
    exact = golden_fn()
    rel_p = rel_e = 0.0
    for g_k, g_p, g_e in zip(kernel_grads, plain, exact):
        rel_p = max(rel_p, float((g_k - g_p).abs().max() / g_p.abs().max()))
        rel_e = max(rel_e, float((g_k.double() - g_e).abs().max()
                                 / g_e.abs().max()))
    say(f"[train] {label} weight gradients of sum(out^2): vs the plain path "
        f"max abs diff / max |plain| {rel_p:.3e} (tol {MODEL_PLAIN_TOL}); "
        f"vs fp64 autograd max abs err / max |exact| {rel_e:.3e} (tol "
        f"{GRAD_FP64_TOL})")
    if not rel_p <= MODEL_PLAIN_TOL:
        fail(f"{label}: weight gradients {rel_p:.3e} off the plain path's")
    if not rel_e <= GRAD_FP64_TOL:
        fail(f"{label}: weight gradients {rel_e:.3e} off fp64")


def fp64_params(torch, model):
    return [w.detach().double().requires_grad_() for w in model.parameters()]


def run_training(torch, sm, card, graph, x_graph, block, x_block, mask,
                 adj, csr16):
    """Phase 11, the training path: the two models' backward of
    sum(out^2) (the launch counts zeroed just before the two
    ``backward()`` calls and read just after, and by op around each op's
    backward), their weight gradients against the plain path and fp64
    autograd, then the factorization trainer on clustered16 (20 Adam
    steps, the counts zeroed just before and read just after), checked and
    timed.  Returns (the models' backward launches by op, training
    launches, records)."""
    import numpy as np
    import scipy.sparse as sps
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.models import (SparseFactorizationModel,
                                        dense_reference_attention)
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.checkpoint import Checkpointer
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    rec = {name: new_record(0.0)
           for name in ("B1", "B2", "B3 values", "B3 dense")}
    # -- the models' backward --
    losses = {}
    for label, model, x in (("graph attention", graph, x_graph),
                            ("block-sparse attention", block, x_block)):
        model.zero_grad()
        losses[label] = model(x).square().sum()
    by_op = {label: op_launches(torch, loss) for label, loss in losses.items()}
    torch.cuda.synchronize()
    _kernels.launches.clear()
    per_model = {}
    for label, loss in losses.items():
        before = dict(_kernels.launches)
        loss.backward()
        per_model[label] = {n: c - before.get(n, 0)
                            for n, c in _kernels.launches.items()
                            if c > before.get(n, 0)}
    torch.cuda.synchronize()
    del losses
    gather = "sddmm_gather_dot_float32_float32"
    runners = {"graph attention": graph.runner,
               "block-sparse attention": block.runner}
    for label, got in per_model.items():
        b1 = b1_launches(runners[label])
        want_by_op = {"_HybridFnBackward": b1,
                      "_SoftmaxFnBackward": {_kernels.SOFTMAX_BWD_ENTRY: 1},
                      "_HeadSpmmFnBackward": {gather: 1,
                                              _kernels.SPMM_ENTRY: 1}}
        want = {}
        for counts in want_by_op.values():
            for name, c in counts.items():
                want[name] = want.get(name, 0) + c
        if label == "block-sparse attention":   # x needs no gradient
            want.update({_kernels.PROJ_SPLIT_ENTRY: 2,
                         _kernels.PROJ_GEMM_ENTRY: 3})
        say(f"[train] {label} backward launches: {got}; by op: "
            f"{by_op[label]}")
        if got != want or by_op[label] != want_by_op:
            fail(f"{label} backward: launches {got} by op {by_op[label]}, "
                 f"want {want} by op {want_by_op}")
        if runners[label]._read_grad is not None:
            fail(f"{label} backward built the per-slot read pattern")
    # each op's launches over both models: B2's in the softmax's backward,
    # B3's two kernels' in the aggregation's
    model_bwd = {op: {} for op in want_by_op}  # the ops of either model
    for ops in by_op.values():
        for op, counts in ops.items():
            for name, c in counts.items():
                model_bwd[op][name] = model_bwd[op].get(name, 0) + c
    for label, model in (("graph attention", graph),
                         ("block-sparse attention", block)):
        say(f"[train] {label}: backward index "
            f"{grad_index_line(model.runner)}")
    grads = {label: [w.grad.clone() for w in model.parameters()]
             for label, model in (("graph attention", graph),
                                  ("block-sparse attention", block))}

    def graph_golden():
        params = fp64_params(torch, graph)
        graph_reference(torch, x_graph, params, adj).square().sum().backward()
        return [w.grad for w in params]

    def block_golden():
        params = fp64_params(torch, block)
        dense_reference_attention(params, x_block,
                                  mask).square().sum().backward()
        return [w.grad for w in params]

    check_model_grads(torch, "graph attention (clustered16, F=D=128)", graph,
                      x_graph, grads["graph attention"], graph_golden)
    check_model_grads(torch, "block-sparse attention (Longformer-base shape)",
                      block, x_block, grads["block-sparse attention"],
                      block_golden)
    for label, model, heads, d in (
            ("graph attention", graph, 1, GRAPH_WIDTH),
            ("block-sparse attention", block, LONGFORMER["heads"],
             LONGFORMER["head_dim"])):
        add_times(rec, {"B2": time_softmax_backward(torch, sm, label, model,
                                                    heads, d, card),
                        **time_aggregation_backward(torch, label, model,
                                                    heads, d, card)})

    # B1 at the Longformer's 12 heads, on U[0,2) operands and cotangent
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    br, lf = block.runner, LONGFORMER
    bp = br.packed
    a12 = torch.rand((lf["heads"], bp.m + 1, lf["head_dim"]), generator=gen,
                     device=DEVICE) * 2
    b12 = br.device_bt(torch.rand((lf["heads"], bp.n + 1, lf["head_dim"]),
                                  generator=gen, device=DEVICE) * 2)
    g12 = torch.rand((lf["heads"], bp.packed_size), generator=gen,
                     device=DEVICE) * 2
    time_hybrid_backward(torch, "Longformer shape", br, a12,
                         b12.contiguous(), g12, card)
    del a12, b12, g12

    # -- the factorization trainer --
    t0 = time.perf_counter()
    model = SparseFactorizationModel.from_csr(
        csr16, TRAIN["k"], learning_rate=TRAIN["lr"], device=DEVICE)
    p = model.packed
    say(f"[pack] factorization clustered16 K={TRAIN['k']}: packed "
        f"{p.packed_size} slots, residual {p.nnz_res}: "
        f"{time.perf_counter() - t0:.1f} s to pack")
    tgt = np.asarray(csr16.values, dtype=np.float32)
    tp = model.pack_targets(tgt)
    model.init(torch.Generator().manual_seed(0))
    init = [w.clone() for w in model.params()]
    # step 1's gradients against fp64 scipy
    loss = model.loss(tp)
    loss.backward()
    torch.cuda.synchronize()
    say(f"[train] factorization: backward index "
        f"{grad_index_line(model.runner)}")
    with torch.no_grad():
        pred = model(order="csr").double()
    g = (2.0 / p.nnz) * (pred - torch.as_tensor(tgt, device=DEVICE).double())
    s = sps.csr_matrix((g.cpu().numpy(), csr16.col_idx, csr16.row_ptr),
                       shape=csr16.shape)
    for name, got, want in (
            ("dA", model.a.grad, s @ init[1].double().cpu().numpy()),
            ("dB^T", model.bt.grad, s.T @ init[0].double().cpu().numpy())):
        res = check_values(want, got.cpu().numpy())
        rel = res.max_abs_err / float(np.abs(want).max())
        say(f"[train] factorization step 1 {name} vs fp64 scipy: {res}; max "
            f"abs err / max |exact| {rel:.3e} (tol {GRAD_FP64_TOL})")
        if not res.passed or res.num_errors or not rel <= GRAD_FP64_TOL:
            fail(f"factorization step 1 {name} vs fp64: {res}, max abs err "
                 f"/ max |exact| {rel:.3e}")
    model.zero_grad()
    # 20 steps, the launch counts zeroed just before and read just after
    step = model.make_train_step()
    _kernels.launches.clear()
    train_losses = [float(step(tp)) for _ in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    train_launches = dict(_kernels.launches)
    steps = TRAIN["steps"]
    want = {"sddmm_tile_dot_float32": steps,
            **{n: c * steps for n, c in b1_launches(model.runner).items()}}
    if p.nnz_res:
        want["sddmm_gather_dot_float32_float32"] = steps
    say(f"[train] factorization, {steps} Adam steps (lr {TRAIN['lr']}): "
        f"launches {train_launches}; losses {train_losses[0]:.6f} -> "
        f"{train_losses[-1]:.6f}")
    if train_launches != want:
        fail(f"factorization: launches {train_launches}, want {want}")
    if not (np.isfinite(train_losses).all()
            and train_losses[-1] < train_losses[0]):
        fail(f"factorization: losses {train_losses[0]} -> "
             f"{train_losses[-1]}")
    # the first 3 losses on the plain path, from the same start
    model.load_params(init)
    pstep = model.make_train_step(plain=True)
    plain_losses = [float(pstep(tp)) for _ in range(3)]
    rel = max(abs(a_ - b_) / abs(b_) for a_, b_ in
              zip(train_losses[:3], plain_losses))
    say(f"[train] factorization first 3 losses, kernels {train_losses[:3]} "
        f"vs plain {plain_losses}: max rel {rel:.3e} (tol {LOSS_REL_TOL})")
    if not rel <= LOSS_REL_TOL:
        fail(f"factorization: first losses {rel:.3e} off the plain path's")
    # a checkpoint: save, step, restore, the same step again bit for bit
    model.load_params(init)
    for _ in range(3):
        step(tp)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(3, model.state())
        after = float(step(tp))
        a_after = model.a.detach().clone()
        model.init(torch.Generator().manual_seed(9))
        model.load_state(ck.restore(map_location="cpu"))
        again = float(step(tp))
        if ck.latest_step != 3 or again != after or not torch.equal(
                a_after, model.a.detach()):
            fail(f"factorization checkpoint: resumed step gives {again}, "
                 f"the original {after}")
    say(f"[train] factorization checkpoint: saved at step 3, restored "
        f"into re-initialised factors; step 4 bit-equal ({after:.6f})")

    # the step's time, split with CUDA events, beside the plain path's
    def split(plain, iters, warmup):
        st = model.make_train_step(plain=plain)
        for _ in range(warmup):
            st(tp)
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(iters)]
        for e in ev:
            model.optimizer.zero_grad(set_to_none=True)
            e[0].record()
            loss = model.loss(tp, plain=plain)
            e[1].record()
            loss.backward()
            e[2].record()
            model.optimizer.step()
            e[3].record()
        torch.cuda.synchronize()
        med = [statistics.median(e[i].elapsed_time(e[i + 1]) for e in ev)
               for i in range(3)]
        total = statistics.median(e[0].elapsed_time(e[3]) for e in ev)
        return med, total

    (fk, bk, ok), tk = split(False, 10, 3)
    (fp, bp, op), tpl = split(True, 3, 1)
    say(f"[time] factorization step (clustered16, K={TRAIN['k']}, "
        f"{p.packed_size} slots): kernels {tk:.4f} ms = forward {fk:.4f} + "
        f"backward {bk:.4f} + Adam {ok:.4f} (medians of 10 after 3); plain "
        f"versions {tpl:.4f} ms = {fp:.4f} + {bp:.4f} + {op:.4f} (of 3 after "
        f"1) on {card}")
    # B1's record at the trainer's shapes, on U[0,2) operands and
    # cotangent (the yardstick is compared element by element)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    a_ops, bt_phys = model.runner.device_prepare(*(
        torch.rand((n + 1, TRAIN["k"]), generator=gen, device=DEVICE) * 2
        for n in (p.m, p.n)))
    gp = torch.rand((1, p.packed_size), generator=gen, device=DEVICE) * 2
    add_times(rec, {"B1": time_hybrid_backward(
        torch, "factorization clustered16", model.runner, a_ops[None],
        bt_phys[None], gp, card)})
    return model_bwd, train_launches, rec


def run_entry_points(torch, card, kind, cells, passes, goldens):
    """Phase 12, the entry points a user runs: the bench route, the
    shoot-out, the CLI (single run, --tune, -t 1) and the profiler, then
    the bench's times against the same calls' (``passes``: phase 6's
    ``kernel_pass`` per cell).  Returns the shoot-out's winning config on
    banded at K=128."""
    import contextlib
    import io as io_std
    from sddmm_tpu_torch import _kernels, bench, cli
    from sddmm_tpu_torch.data import generate, io
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.reorder.autotune import autotune
    from sddmm_tpu_torch.utils import profiling
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.logger import parse_log
    from sddmm_tpu_torch.utils.timing import cuda_time_ms

    # 1. the bench route: the full suite at K=128, committed configs
    _kernels.launches.clear()
    t0 = time.perf_counter()
    out = bench.main(["--k", "128", "--sessions", "1"])
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    say(f"[bench] python -m sddmm_tpu_torch.bench --k 128 --sessions 1: "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    missing = [k for k in BENCH_KEYS if k not in out]
    if missing:
        fail(f"bench JSON lacks {missing}")
    names = list(suite())
    if sorted(out["per_matrix"]) != sorted(names) or not all(
            v > 0 for v in out["per_matrix"].values()):
        fail(f"bench per_matrix {out['per_matrix']}: want 5 cells > 0")
    if any(v is not None for v in out["roofline_fraction"].values()):
        fail(f"bench roofline_fraction {out['roofline_fraction']} not null")
    if not all(v is not None and v <= SOL_MAX
               for v in out["sol_fraction"].values()):
        fail(f"bench sol_fraction {out['sol_fraction']} above {SOL_MAX}")
    for kname in ("sddmm_tile_dot_tf32", "sddmm_gather_dot_float32_float32"):
        if not launches.get(kname):
            fail(f"the bench route did not launch {kname}")
    # 2. the shoot-out on banded at bench scale, timed on the card
    csr, _, _, a, b = cells[("banded", 128)]
    t0 = time.perf_counter()
    win = autotune(csr, k=128, measure=True)
    say(f"[shootout] banded@K128: {len(win.shootout)} finalists in "
        f"{time.perf_counter() - t0:.1f} s on {card}:")
    for f in win.shootout:
        say(f"[shootout]   {bench.config_of(f, 'tf32')}: {f.measured_ms:.4f}"
            f" ms (set-up {f.setup_s:.2f} s, score {f.est_ms:.4f})"
            + ("; pallas=True runs the same tile kernel as its twin"
               if f.use_pallas else ""))
        if not f.measured_ms > 0:
            fail(f"shoot-out finalist {bench.config_of(f, 'tf32')} not "
                 "timed")
    if win.dense:
        runner = DenseSDDMM.from_csr(csr, compute_dtype="tf32", device=DEVICE)
    else:
        runner = hybrid_runner(win.packed, win, "tf32")
    res = check_values(goldens[("banded", 128)],
                       runner(a, b, order="csr").cpu().numpy())
    say(f"[shootout] winner {bench.config_of(win, 'tf32')} "
        f"({win.measured_ms:.4f} ms) in CSR order vs fp64 golden: {res}")
    if not res.passed or res.num_errors:
        fail(f"shoot-out winner: {res.num_errors} values outside the "
             "contract")
    del runner
    shootout_winner = bench.config_of(win, "tf32")

    # 3. the CLI: a single run with --validate, --tune, and -t 1
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "banded.mtx"
        io.save_mtx(path, csr)
        small = tmp / "small.mtx"
        io.save_mtx(small, generate.block_clustered(16, 16, block_prob=0.2,
                                                    seed=31))
        for label, argv, log_name in (
                ("single run", ["-f", str(path), "-k", "128", "--validate",
                                "-l", str(tmp / "one")], "one"),
                ("--tune", ["-f", str(path), "-k", "128", "--tune",
                            "--validate", "-l", str(tmp / "tune")], "tune")):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io_std.StringIO()):
                rc = cli.main(argv)
            entries = parse_log((tmp / log_name / "BSMR_torch_k_128.log")
                                .read_text())
            say(f"[cli] {label} on banded.mtx K=128: rc {rc}, "
                f"[Device : {entries.get('Device')}], bsmr_gflops "
                f"{float(entries['bsmr_gflops']):.1f}, bsmr_sddmm "
                f"{float(entries['bsmr_sddmm']):.4f} ms, "
                f"{time.perf_counter() - t0:.1f} s")
            if (rc != 0 or entries.get("Device") != f"cuda:{kind}"
                    or not float(entries["bsmr_gflops"]) > 0
                    or "checkResults" in entries):
                fail(f"cli {label}: rc {rc}, log {entries}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io_std.StringIO()):
            rc = cli.main(["-f", str(small), "-t", "1", "-l",
                           str(tmp / "sweep")])
        logs = sorted((tmp / "sweep").glob("*.log"))
        say(f"[cli] -t 1 on a 256x256 block_clustered matrix: rc {rc}, "
            f"{len(logs)} logs in {time.perf_counter() - t0:.1f} s")
        if rc != 0 or len(logs) != SWEEP_LOGS or not all(
                float(parse_log(p.read_text())["bsmr_gflops"]) > 0
                for p in logs):
            fail(f"cli -t 1: rc {rc}, {len(logs)} logs (want {SWEEP_LOGS}, "
                 "each > 0 GFLOPS)")

        # 4. the profiler around one call of a bench cell
        _, runner, ops, _, _ = cells[("banded", 128)]
        with profiling.trace(tmp / "trace") as prof:
            with profiling.span("banded@K128 packed call"):
                runner.run_padded(*ops)
        traces = list((tmp / "trace").glob("*.pt.trace.json"))
        text = traces[0].read_text() if len(traces) == 1 else ""
        kernels = sorted({e.key for e in prof.key_averages()
                          if "tile_table" in e.key or "gather_dot" in e.key})
        say(f"[profile] {len(traces)} trace file, {len(text)} bytes; "
            f"kernels named: {kernels}")
        if "tile_table_kernel" not in text or "banded@K128" not in text:
            fail("the profiler's trace does not name the tile kernel and "
                 "the annotation")

    # 5. one program, two timers.  The bench's packed time of each cell is
    # at least 75 % of the device time of the kernels its call launches
    # (the profiler's, now).  The bench's own timer (measure_kernel_ms, as
    # the bench calls it) on the same call, timed now between two samples
    # of events around single calls, lies between that floor and 125 % of
    # the slowest sample.  A host-bound call reads the host's enqueue, which
    # moves by up to 2x between phases, so the bench's number from the start
    # of this phase is held only to the device floor.
    for name in names:
        got = out["timing_sessions_ms"][name][0]
        _, runner, ops, _, _ = cells[(name, 128)]
        tile_ms = next(t["ms"] for k, t in passes[(name, 128)].items()
                       if k.startswith("sddmm_tile_dot_"))

        def call():
            with torch.no_grad():
                runner.run_padded(*ops)

        floor = device_ms(torch, call, 20)
        if not floor > 0:
            fail(f"{name}: the profiler saw no device time in 20 calls")
        before = cuda_time_ms(call, 20)
        timer = runner.measure_kernel_ms(*ops, iterations=40, repeats=4,
                                         order="packed")
        after = cuda_time_ms(call, 20)
        slowest = max(before["max_ms"], after["max_ms"])
        lo, hi = (1 - BENCH_AGREE) * floor, (1 + BENCH_AGREE) * slowest
        say(f"[bench] {name}@K128 packed: bench {got:.4f} ms; its kernels' "
            f"device time now {floor:.4f} ms (profiler); the bench's timer "
            f"now {timer:.4f} ms between event samples of medians "
            f"{before['median_ms']:.4f} and {after['median_ms']:.4f} ms "
            f"(slowest {slowest:.4f}); its tile kernel alone {tile_ms:.4f} "
            f"ms (phase 6) on {card}")
        if not got >= lo:
            fail(f"{name}: the bench's {got:.4f} ms lies below 75 % of its "
                 f"kernels' device time {floor:.4f} ms")
        if not lo <= timer <= hi:
            fail(f"{name}: the bench's timer reads {timer:.4f} ms now, "
                 f"outside [{lo:.4f}, {hi:.4f}] ms")
    return shootout_winner


def device_ms(torch, fn, calls):
    """Device ms of one ``fn()``: the profiler's device time of every
    kernel and copy it launches, over ``calls`` calls after 3 warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum((getattr(e, "device_time_total", None) or e.cuda_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls / 1e3


def cluster_args(csr, col_block_size=16):
    """(order, block_ptr, block_idx, block_cnt, num_blocks) as the JAX
    package's probe builds them."""
    import numpy as np
    from sddmm_tpu_torch.reorder import rows
    bp, bi, bc, nb = rows.row_encodings(csr, col_block_size)
    disp = rows.dispersion_scores(csr, bp, bc, col_block_size)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]
    return order, bp, bi, bc, nb


def cluster_round_bytes(args, cluster_of, record) -> float:
    """Mean bytes a kernel round must read: the encodings of the rows live
    in it (8 bytes a block, 16 a row), leaders among them, once."""
    import numpy as np
    order, bp = args[0], args[1]
    made = np.asarray(record["clusters"])
    n = len(made)
    # a row is live in the rounds up to the one that made its cluster
    live = np.minimum(np.searchsorted(made, cluster_of[order],
                                      side="right") + 1, n)
    lens = np.diff(bp)[order]
    return float(((8 * lens + 16) * live).sum()) / max(n, 1)


def launch_events(torch, kernels, names, run):
    """``run()`` with CUDA events recorded around every launch of the C
    entries ``names`` (``kernels.launch`` wrapped meanwhile): (its result,
    {name: [ms of each launch]})."""
    events = {k: [] for k in names}
    launch = kernels.launch

    def timed(name, *args):
        if name not in events:
            return launch(name, *args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        launch(name, *args)
        ev[1].record()
        events[name].append(ev)

    kernels.launch = timed
    try:
        res = run()
    finally:
        kernels.launch = launch
    torch.cuda.synchronize()
    return res, {k: [a.elapsed_time(b) for a, b in evs]
                 for k, evs in events.items()}


def check_greedy_fallback(card):
    """The native library is the port's own, and the numpy fallback greedy
    gives its cluster ids exactly."""
    import numpy as np
    from sddmm_tpu_torch import native
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.reorder import rows

    pkg = Path(native.__file__).resolve().parents[1]
    lib = native.lib_path()
    if not (native.available() and lib.is_relative_to(pkg)
            and native._SRC.is_relative_to(pkg)):
        fail(f"the native library {lib} (from {native._SRC}) is not the "
             f"port's own, or did not load")
    say(f"[host] native source: {lib.relative_to(pkg.parent)} built from "
        f"{native._SRC.relative_to(pkg.parent)}")
    csr = generate.powerlaw_graph(**FALLBACK_GRAPH)
    args = cluster_args(csr)
    t0 = time.perf_counter()
    nat = native.greedy_cluster(args[1], args[2], args[3], args[0], csr.m,
                                args[4], FALLBACK_ALPHA)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    fb = rows._greedy_cluster(*args, FALLBACK_ALPHA, arith="native")
    t_fallback = time.perf_counter() - t0
    diff = int(np.count_nonzero(fb[0] != nat[0]))
    if fb[1] != nat[1] or diff:
        fail(f"greedy fallback: {fb[1]} clusters, native {nat[1]}; {diff} "
             "rows differ")
    say(f"[host] greedy fallback == native: powerlaw {csr.m} rows nnz "
        f"{csr.nnz}, alpha {FALLBACK_ALPHA}: {nat[1]} clusters, ids equal; "
        f"native {t_native:.4f} s, fallback {t_fallback:.4f} s (host) on "
        f"{card}")


def run_device_clustering(torch, card, cells, goldens):
    """Phase 13: the clustering kernel on the probe matrix against its
    plain round (exact), the mid matrix against the host's batched
    clustering, the native greedy's time beside it and its numpy fallback
    held to it, the routing constant, and
    HybridSDDMM.from_csr(method="device") on clustered16."""
    import numpy as np
    from sddmm_tpu_torch import _kernels, native
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    from sddmm_tpu_torch.reorder import device_cluster as dc
    from sddmm_tpu_torch.reorder import rows
    from sddmm_tpu_torch.utils.check import check_values

    names = (_kernels.CLUSTER_LEADERS_ENTRY, _kernels.CLUSTER_ASSIGN_ENTRY)
    probe = generate.block_clustered(**PROBE)
    args = cluster_args(probe)
    m, nb = probe.m, args[4]
    say(f"[cluster] probe {probe.m}x{probe.n} nnz {probe.nnz}: "
        f"{len(args[0])} rows to cluster, {nb} blocks, "
        f"{len(args[2])} occupied (row, block) pairs, alpha {CLUSTER_ALPHA}")
    _kernels.launches.clear()
    rec = {}
    got, n_got = dc.batched_cluster_device(*args, CLUSTER_ALPHA,
                                           device=DEVICE, record=rec)
    torch.cuda.synchronize()
    launches = {k: _kernels.launches[k] for k in names}
    n_kernel = rec["rounds_enqueued"]
    if launches != {k: n_kernel for k in names}:
        fail(f"device clustering: launches {launches}, want {n_kernel} "
             "of each kernel")
    ran = len(rec["clusters"])
    # the leaders' and the rows' launches timed apart, in a second run with
    # CUDA events around every launch
    again, phase_ms = launch_events(torch, _kernels, names, lambda: (
        dc.batched_cluster_device(*args, CLUSTER_ALPHA, device=DEVICE)))
    if again[1] != n_got or not np.array_equal(again[0], got):
        fail("device clustering: a second run differs from the first")
    lead_ms, rows_ms = (sum(phase_ms[k]) / max(ran, 1) for k in names)
    rec_p = {}
    plain, n_plain = dc.batched_cluster_device(
        *args, CLUSTER_ALPHA, device=DEVICE, plain=True, record=rec_p)
    diff = int(np.count_nonzero(got != plain))
    if n_got != n_plain or diff:
        fail(f"device clustering on the probe: kernel {n_got} clusters, "
             f"plain round {n_plain}; {diff} rows differ")
    round_ms = rec["device_ms"] / max(ran, 1)
    wall_round = rec["seconds"] / max(ran, 1) * 1e3
    plain_round = rec_p["seconds"] / max(rec_p["rounds"], 1) * 1e3
    t0 = time.perf_counter()
    nat = native.greedy_cluster(args[1], args[2], args[3], args[0], m, nb,
                                CLUSTER_ALPHA)
    t_native = time.perf_counter() - t0
    if nat is None:
        fail("the native host greedy clustering is not available")
    m_pad = -(-m // 2048) * 2048
    per_cell = rec["seconds"] / (m_pad * nb)
    bytes_round = cluster_round_bytes(args, got, rec)
    bound_round = bytes_round / HBM_BYTES_PER_S * 1e3
    say(f"[cluster] probe: kernel = plain round exactly ({n_got} clusters, "
        f"{rec['rounds']} rounds, {ran} ran; {n_kernel} enqueued on the "
        f"card in {rec['fetches']} batches, {2 * n_kernel} launches a "
        f"clustering); kernel {round_ms:.4f} ms a round (CUDA events around "
        f"each batch), host wall {wall_round:.4f} ms a round, "
        f"{rec['seconds']:.4f} s in all; plain round {plain_round:.4f} ms a "
        f"round ({rec_p['seconds']:.3f} s); bound {bound_round:.4f} ms a "
        f"round ({bytes_round / 1e6:.2f} MB read) = "
        f"{100 * bound_round / round_ms:.2f} % of it; native host greedy "
        f"{t_native:.3f} s ({nat[1]} clusters) on {card}")
    say(f"[cluster] probe, phases apart (events around every launch, a "
        f"second run): leaders {lead_ms:.4f} ms a round, rows "
        f"{rows_ms:.4f} ms a round ({sum(phase_ms[names[0]]):.3f} + "
        f"{sum(phase_ms[names[1]]):.3f} ms over {ran} rounds, "
        f"{len(phase_ms[names[0]])} launches each) on {card}")
    check_greedy_fallback(card)
    say(f"[cluster] routing constant DEVICE_CLUSTER_S_PER_CELL: "
        f"{rec['seconds']:.3f} s / ({m_pad} x {nb} cells) = {per_cell:.3e} "
        f"s a cell (the port's rows.py holds "
        f"{rows.DEVICE_CLUSTER_S_PER_CELL:.3e}) on {card}")
    mid = generate.block_clustered(**MID)
    margs = cluster_args(mid)
    k_mid = dc.batched_cluster_device(*margs, CLUSTER_ALPHA, device=DEVICE)
    p_mid = dc.batched_cluster_device(*margs, CLUSTER_ALPHA, device=DEVICE,
                                      plain=True)
    t0 = time.perf_counter()
    h_mid = rows._batched_cluster(*margs, CLUSTER_ALPHA,
                                  hat_dtype=np.float32)
    t_host = time.perf_counter() - t0
    for label, other in (("plain round", p_mid), ("host batched", h_mid)):
        if other[1] != k_mid[1] or not np.array_equal(other[0], k_mid[0]):
            fail(f"device clustering on the mid matrix: kernel {k_mid[1]} "
                 f"clusters, {label} {other[1]}")
    say(f"[cluster] mid {mid.m}x{mid.n} nnz {mid.nnz}: kernel = plain round "
        f"= host batched (fp32 hats) exactly, {k_mid[1]} clusters; host "
        f"batched {t_host:.3f} s")
    wide = {}
    for plain in (False, True):
        rec_w = {}
        wide[plain] = (dc.batched_cluster_device(
            *margs, CLUSTER_ALPHA, leaders_per_round=WIDE_LEADERS,
            device=DEVICE, plain=plain, record=rec_w), rec_w)
    (k_w, rec_w), (p_w, rec_pw) = wide[False], wide[True]
    if (k_w[1] != p_w[1] or not np.array_equal(k_w[0], p_w[0])
            or rec_w["clusters"] != rec_pw["clusters"]):
        fail(f"device clustering at L={WIDE_LEADERS} on the mid matrix: "
             f"kernel {k_w[1]} clusters, plain round {p_w[1]}")
    say(f"[cluster] mid at {WIDE_LEADERS} leaders a round: kernel = plain "
        f"round exactly, {k_w[1]} clusters in {rec_w['rounds']} rounds; "
        f"kernel {rec_w['device_ms'] / max(len(rec_w['clusters']), 1):.4f} "
        f"ms a round on {card}")
    csr, _, _, a, b = cells[SCALE_CELL]
    t0 = time.perf_counter()
    runner = HybridSDDMM.from_csr(csr, method="device", device=DEVICE)
    t_pack = time.perf_counter() - t0
    res = check_values(goldens[SCALE_CELL], runner(a, b=b).cpu().numpy())
    say(f"[check] clustered16@K128 HybridSDDMM.from_csr(method='device') "
        f"(packed in {t_pack:.1f} s) vs fp64 golden: {res}")
    if not res.passed or res.num_errors:
        fail(f"method='device' runner: {res.num_errors} values outside the "
             "contract")
    r = new_record(0.0)
    r.update(ms=round_ms, plain_ms=plain_round, bytes_ms=bound_round,
             bound_ms=bound_round, library_ms=None)
    return launches, r


def scale_rank(rank, world, packed, t_info, a, b, golden, dense_case,
               fact, backend, device):
    """One rank of the full-size (2, 2) check: CSR order against the fp64
    golden, the packed step timed (and its local part and all-reduce
    alone), the dense class on dlmc, and the trainer's steps."""
    import torch
    import torch.distributed as dist
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.models import DistributedSparseFactorizationModel
    from sddmm_tpu_torch.parallel import (DistributedDenseSDDMM,
                                          DistributedHybridSDDMM, make_mesh)
    from sddmm_tpu_torch.utils.check import check_values
    from sddmm_tpu_torch.utils.timing import cuda_time_ms

    mesh = make_mesh(MESH_SCALE, backend=backend, device=device)
    mode, a_layout = t_info
    d = DistributedHybridSDDMM(packed, mesh, compute_dtype=mode,
                               a_layout=a_layout, device=device)
    ops = d.prepare_operands(a, b=b)
    _kernels.launches.clear()
    d.collectives.clear()
    with torch.no_grad():
        flat = d.run_padded(*ops)
        torch.cuda.synchronize()
        launches = dict(_kernels.launches)
        log = list(d.collectives)
        vals = d.to_csr_order(flat).cpu().numpy()
        res = check_values(golden, vals)
        step = cuda_time_ms(lambda: d.run_padded(*ops), SCALE_ITERS)
        local = cuda_time_ms(lambda: d.run_local(*ops), SCALE_ITERS)
        plain = cuda_time_ms(lambda: d.run_local(*ops, plain=True), 3, 1)
        buf = flat.clone()
        ar = cuda_time_ms(lambda: dist.all_reduce(
            buf, group=mesh.groups["feat"]), SCALE_ITERS)
    dcsr, da, db, dgolden = dense_case
    dd = DistributedDenseSDDMM.from_csr(dcsr, mesh, device=device)
    with torch.no_grad():
        dres = check_values(dgolden, dd(da, b=db).cpu().numpy())
    fpacked, k, targets = fact
    model = DistributedSparseFactorizationModel(fpacked, mesh, k,
                                                device=device)
    model.init(torch.Generator().manual_seed(0))
    stepf = model.make_train_step()
    tp, mask = model.pack_targets(targets)
    _kernels.launches.clear()
    losses = [float(stepf(tp, mask)) for _ in range(FACT_STEPS)]
    torch.cuda.synchronize()
    # the shard's bound: its A rows, B^T and output once each over the
    # card's memory rate; the feat sum: the F partials read, one written
    a_loc = ops[0][0] if isinstance(ops[0], tuple) else ops[0]
    shard = sum(x.numel() * x.element_size() for x in (a_loc, ops[1], flat))
    reduce_bytes = (mesh.shape["feat"] + 1) * flat.numel() * 4
    return dict(coords=mesh.coords, mesh=str(mesh), errors=res.num_errors,
                res=str(res), dense=str(dres), dense_errors=dres.num_errors,
                launches=launches, log=log, step=step, local=local, ar=ar,
                plain=plain, bound_ms=(shard + reduce_bytes)
                / HBM_BYTES_PER_S * 1e3, shard_mb=shard / 1e6,
                reduce_mb=reduce_bytes / 1e6,
                flat_local=d.plan.flat_local, losses=losses,
                train_launches=dict(_kernels.launches))


def run_multi_device(torch, card, cells, packs, goldens):
    """Phase 14: the dry run over (2, 2) (NCCL with a card a rank where
    there are 4, else gloo over CUDA tensors on the one card) and over
    (1, 1) on NCCL; then the full-size (2, 2) check on clustered16 at
    K=128, the dense class on dlmc and the distributed trainer against
    the single-device one."""
    from sddmm_tpu_torch.models import SparseFactorizationModel
    from sddmm_tpu_torch.parallel.dist import _ShardPlan
    from sddmm_tpu_torch.parallel.dryrun import dryrun_multichip
    from sddmm_tpu_torch.parallel.launch import spawn

    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    say(f"[mesh] {torch.cuda.device_count()} card(s): the 4-rank meshes run "
        f"over {backend}" + (" with CUDA tensors, all ranks on card 0"
                             if backend == "gloo" else ", a card a rank"))
    out = {}
    for n, be in ((4, backend), (1, ONE_RANK_BACKEND)):
        t0 = time.perf_counter()
        s = dryrun_multichip(n, backend=be, device=DEVICE, verbose=False)
        want = {"sddmm_tile_dot_float32": 1,
                "sddmm_gather_dot_float32_float32": 1}
        for r in s["ranks"]:
            got = {k: r["launches"].get(k, 0) for k in want}
            if got != want:
                fail(f"dry run rank {r['coords']}: forward launches "
                     f"{r['launches']}, want {want} and B1's")
        say(f"[dryrun] {n} rank(s) over {be}: {s['ranks'][0]['mesh']}; "
            f"units {s['units']}, weight spread {s['weight_spread']:.3f} "
            f"(equal counts {s['naive_spread']:.3f}); loss {s['loss']:.6f} "
            f"(single device {s['loss_single']:.6f}); single vs multi: "
            f"{s['bits']} ({s['bit_equal']}/{s['real_slots']} real slots "
            f"bit-equal, worst {s['worst_ulps']:.1f} ulps); rank 0 "
            f"launches {s['ranks'][0]['launches']}; "
            f"{time.perf_counter() - t0:.1f} s")
        out[n] = s
    csr, runner, _, a, b = cells[SCALE_CELL]
    packed = packs[SCALE_CELL][0]
    dcsr, _, _, da, db = cells[("dlmc", 128)]
    single = SparseFactorizationModel.from_csr(csr, 128, device=DEVICE)
    single.init(torch.Generator().manual_seed(0))
    stepf = single.make_train_step()
    tp = single.pack_targets(csr.values)
    want_losses = [float(stepf(tp)) for _ in range(FACT_STEPS)]
    t0 = time.perf_counter()
    ranks = spawn(MESH_SCALE[0] * MESH_SCALE[1], scale_rank, (
        packed, (runner.compute_dtype, runner.a_layout), a, b,
        goldens[SCALE_CELL], (dcsr, da, db, goldens[("dlmc", 128)]),
        (single.packed, 128, csr.values), backend, DEVICE),
        backend=backend, timeout_s=600)
    plan = _ShardPlan(packed, MESH_SCALE[0])
    n = plan.flat_local
    tile = f"sddmm_tile_dot_{runner.compute_dtype}"
    for r in ranks:
        if r["launches"].get(tile) != 1 or not r["train_launches"].get(
                "sddmm_tile_grad_float32"):
            fail(f"full-size rank {r['coords']}: launches {r['launches']} "
                 f"(want one {tile}), training {r['train_launches']}")
        if r["errors"] or r["dense_errors"]:
            fail(f"full-size rank {r['coords']}: {r['res']}; dense "
                 f"{r['dense']}")
        if r["log"] != [dict(kind="all_reduce", group="feat", numel=n,
                             bytes=4 * n)]:
            fail(f"rank {r['coords']}: the packed step issued {r['log']}")
        rel = max(abs(x - y) / abs(y) for x, y in zip(r["losses"],
                                                      want_losses))
        if not rel <= 1e-5:
            fail(f"rank {r['coords']}: losses {r['losses']} vs single "
                 f"{want_losses} (max rel {rel:.2e})")
        share = r["ar"]["median_ms"] / r["step"]["median_ms"]
        say(f"[scale] {SCALE_CELL[0]}@K{SCALE_CELL[1]} rank {r['coords']} "
            f"({r['mesh']}): CSR order vs fp64 golden {r['res']}; dlmc "
            f"dense class {r['dense']}; launches {r['launches']}; step "
            f"{r['step']['median_ms']:.4f} ms (local kernels "
            f"{r['local']['median_ms']:.4f} ms, their plain versions "
            f"{r['plain']['median_ms']:.4f} ms; all-reduce of {n} floats "
            f"{r['ar']['median_ms']:.4f} ms = {share:.1%} of the step); "
            f"bound {r['bound_ms']:.4f} ms ({r['shard_mb']:.1f} MB of the "
            f"shard's operands and output, {r['reduce_mb']:.1f} MB of the "
            f"feat sum, over 3.35 TB/s) on {card}; {FACT_STEPS} trainer "
            f"losses {r['losses']} (single "
            f"{want_losses}, max rel {rel:.2e}), launches "
            f"{r['train_launches']}")
    say(f"[scale] {len(ranks)} ranks over {backend}: "
        f"{time.perf_counter() - t0:.1f} s")
    return out, ranks


def harness_script(name):
    """The module of ``scripts/<name>.py`` (scripts/ on the path, so that
    the ranks the scaling script spawns import it too)."""
    import importlib
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def run_harness(torch, card, kind):
    """Phase 15: the harness scripts through their ``main`` on the card, in
    a temporary directory: the synthetic corpus's three matrices, the five
    tools at K=128 measured and validated, their table, the CLI suite and
    the scaling run."""
    import contextlib
    import io as io_mod
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.utils.logger import parse_log

    synth = harness_script("torch_make_synth_suite")
    baselines = harness_script("torch_run_baselines")
    analyze = harness_script("torch_analyze_results")
    bench_suite = harness_script("torch_run_bench_suite")
    scaling = harness_script("torch_scaling_bench")
    with tempfile.TemporaryDirectory(prefix="sddmm_harness_") as tmp:
        tmp = Path(tmp)
        mats, logs = tmp / "mats", tmp / "logs"
        t0 = time.perf_counter()
        if synth.main([str(mats), "--only", *HARNESS_MATRICES]) != 0:
            fail("torch_make_synth_suite.py failed")
        say(f"[harness] corpus: {len(HARNESS_MATRICES)} matrices in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _kernels.launches.clear()
        if baselines.main([str(mats), str(logs), "--ks", str(HARNESS_K),
                           "--tools", *HARNESS_TOOLS, "--measure",
                           "--validate"]) != 0:
            fail("torch_run_baselines.py failed")
        torch.cuda.synchronize()
        moved = dict(_kernels.launches)
        tile = sum(v for k, v in moved.items()
                   if k.startswith("sddmm_tile_dot_"))
        gather = sum(v for k, v in moved.items()
                     if k.startswith("sddmm_gather_dot_"))
        if not tile or not gather:
            fail(f"the baselines launched the tile kernel {tile} and the "
                 f"gather-dot {gather} times")
        say(f"[harness] baselines: {len(HARNESS_MATRICES)} matrices x "
            f"{len(HARNESS_TOOLS)} tools at K={HARNESS_K}, measured and "
            f"validated, in {time.perf_counter() - t0:.1f} s; tile kernel "
            f"{tile} launches, gather-dot {gather}")
        for name in HARNESS_MATRICES:
            log = parse_log((logs / f"{name}_k{HARNESS_K}.log").read_text())
            bad = [t for t in HARNESS_TOOLS
                   if log.get(f"{t}_check") != "PASS"
                   or not float(log.get(f"{t}_gflops", 0)) > 0]
            if bad or not float(log["bsmr_gflops"]) > 0:
                fail(f"{name}: tools {bad} did not PASS with GFLOPS > 0")
            if log["Device"] != "cuda:" + kind:
                fail(f"{name}: the log's device is {log['Device']}")
            strategy = log.get("bsmr_strategy", "hybrid")
            say(f"[harness] {name}@K{HARNESS_K} ({log['NNZ']} nnz, bsmr "
                f"{strategy}): " + ", ".join(
                    f"{t} {float(log[t + '_gflops']):.1f}"
                    for t in ("bsmr", "bsmr_csr_order") + HARNESS_TOOLS[:2]
                    + HARNESS_TOOLS[3:]) + f" GFLOPS, every check PASS, on "
                f"{card}")
        table = analyze.collect(logs, HARNESS_K)
        if analyze.main([str(logs), "--k", str(HARNESS_K), "--hybrid"]) != 0:
            fail("torch_analyze_results.py failed")
        speedups = analyze.geomean_speedups(table)
        say("[harness] geomean speed-ups of bsmr at K="
            f"{HARNESS_K}: over csr {speedups[('bsmr', 'csr')]:.3f}x, over "
            f"dense {speedups[('bsmr', 'dense')]:.3f}x on {card}")
        one = tmp / "one"
        one.mkdir()
        (mats / f"{HARNESS_MATRICES[0]}.mtx").rename(
            one / f"{HARNESS_MATRICES[0]}.mtx")
        t0 = time.perf_counter()
        if bench_suite.main([str(one), str(tmp / "suite"), "--ks",
                             *map(str, HARNESS_SUITE_KS)]) != 0:
            fail("torch_run_bench_suite.py failed")
        for k in HARNESS_SUITE_KS:
            log = parse_log((tmp / "suite" / HARNESS_MATRICES[0]
                             / f"BSMR_torch_k_{k}.log").read_text())
            if log["Device"] != "cuda:" + kind or not (
                    float(log["bsmr_gflops"]) > 0):
                fail(f"bench suite K={k}: device {log['Device']}, "
                     f"{log['bsmr_gflops']} GFLOPS")
            say(f"[harness] bench suite {HARNESS_MATRICES[0]}@K{k} (CLI, "
                f"float32): {float(log['bsmr_gflops']):.1f} GFLOPS on "
                f"{card}")
        say(f"[harness] bench suite: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out = io_mod.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = scaling.main(["--devices", *map(str, HARNESS_RANKS)])
        except RuntimeError as e:
            fail(f"torch_scaling_bench.py: {e}")
        for line in out.getvalue().splitlines()[:-1]:
            say(f"[harness] scaling {line}")
        if rc != 0:
            fail("torch_scaling_bench.py failed")
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        for r in res["results"]:
            coll = r["collectives"]
            if not r["max_rel_err"] < SCALING_REL or coll["all-gather"] or (
                    r["mesh"][1] == 2 and coll["all-reduce"] != 1):
                fail(f"scaling at {r['devices']} ranks: {r}")
        say(f"[harness] scaling over {res['backend']} at "
            f"{[r['mesh'] for r in res['results']]}: max rel err "
            f"{max(r['max_rel_err'] for r in res['results']):.2e} (tol "
            f"{SCALING_REL}), no all-gather, one all-reduce over 'feat' at "
            f"(2, 2); {time.perf_counter() - t0:.1f} s on {card}")


def run_calibration(torch, card, cells, goldens):
    """Phase 16: ``torch_calibrate.py`` at full size, its file loaded into
    the port's layout model, and the measured shoot-out on
    ``CALIBRATION_CELLS`` with the shipped constants and calibrated; the
    shipped constants put back at the end."""
    import contextlib
    import io as io_mod
    import math
    from sddmm_tpu_torch import _kernels, bench
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.tile_dot import MODES
    from sddmm_tpu_torch.reorder import autotune as at
    from sddmm_tpu_torch.utils.check import check_values

    calib = harness_script("torch_calibrate")
    fit = harness_script("torch_calibration_fit")
    shipped = fit.snapshot()
    with tempfile.TemporaryDirectory(prefix="sddmm_calibration_") as tmp:
        path = Path(tmp) / "calibration.json"
        t0 = time.perf_counter()
        _kernels.launches.clear()
        with contextlib.redirect_stdout(io_mod.StringIO()):
            rc = calib.main(["-o", str(path)])
        torch.cuda.synchronize()
        launches = dict(_kernels.launches)
        cal = json.loads(path.read_text())
    if rc != 0:
        fail(f"torch_calibrate.py exited {rc}")
    say(f"[calibration] torch_calibrate.py at full size: "
        f"{time.perf_counter() - t0:.1f} s on {cal['card']}")
    say(f"[calibration] stream {cal['stream_gbps']} GB/s (read-reduce); "
        f"gather M rows/s at 8 MB by row bytes {cal['row_rate_8mb']}; "
        f"512 B factor by footprint (MB) {cal['src_factor']}")
    say("[calibration] tile kernel M 16-row groups/s: " + "; ".join(
        f"{mode} " + "/".join(str(cal["dot_g16_ms"][f"{mode},{m}"])
                              for m in calib.DOT_HEIGHTS)
        for mode in MODES) + f" at m = {calib.DOT_HEIGHTS}")
    if cal["card"] != card:
        fail(f"the calibration names {cal['card']!r}, the card is {card!r}")
    keys = {"row_rate_8mb": {str(rb) for rb in calib.ROW_BYTES},
            "src_factor": {str(mb) for mb in calib.SRC_MB},
            "dot_g16_ms": {f"{mode},{m}" for mode in MODES
                           for m in calib.DOT_HEIGHTS}}
    for field, want in keys.items():
        if set(cal[field]) != want:
            fail(f"calibration {field}: keys {sorted(cal[field])}, want "
                 f"{sorted(want)}")
    rates = [cal["stream_gbps"]] + [v for field in keys
                                    for v in cal[field].values()]
    if not all(math.isfinite(r) and r > 0 for r in rates):
        fail(f"calibration rates not all finite and above 0: {cal}")
    # each probe raises unless every one of its calls launched the kernel;
    # a session whose stream hold the host outran times its calls again
    per_mode = len(calib.DOT_HEIGHTS) * calib.dot_calls()
    got = {k: v for k, v in launches.items()
           if k.startswith("sddmm_tile_dot_")}
    if sorted(got) != sorted(f"sddmm_tile_dot_{m}" for m in MODES) or not \
            all(v >= per_mode for v in got.values()):
        fail(f"the dot probes launched the tile kernel {got}, want at least "
             f"{per_mode} a mode ({len(calib.DOT_HEIGHTS)} probes x "
             f"{calib.dot_calls()} calls)")
    say(f"[calibration] tile kernel launches by the 20 dot probes: {got} "
        f"(at least {calib.dot_calls()} calls a probe)")

    try:
        at.load_calibration(cal)
        wrong = [f"row_rate_8mb {rb}" for rb, r in cal["row_rate_8mb"].items()
                 if at._ROW_RATE_8MB[int(rb)] != r]
        wrong += [f"dot_g16_ms {key}" for key, r in cal["dot_g16_ms"].items()
                  if at._DOT_G16_MS[(key.split(",")[0],
                                     int(key.split(",")[1]))] != r * 1e6]
        pts = dict(zip(at._SRC_MB.tolist(), at._SRC_F.tolist()))
        wrong += [f"src_factor {mb}" for mb, f in cal["src_factor"].items()
                  if pts.get(float(mb)) != f]
        if at.STREAM_GBPS != cal["stream_gbps"] or pts.get(8.0) != 1.0:
            wrong.append("stream_gbps or the 8 MB anchor")
        if wrong:
            fail(f"the loaded constants differ from the file: {wrong}")
        say("[calibration] loaded into reorder.autotune: every constant "
            "equals the file's")
        for name, k in CALIBRATION_CELLS:
            csr, _, _, a, b = cells[(name, k)]
            for label in ("shipped", "calibrated"):
                fit.restore(shipped)
                if label == "calibrated":
                    at.load_calibration(cal)
                t0 = time.perf_counter()
                win = at.autotune(csr, k=k, measure=True)
                secs = time.perf_counter() - t0
                fins = [{"config": bench.config_of(f, "tf32"),
                         "est_ms": f.est_ms, "measured_ms": f.measured_ms}
                        for f in win.shootout]
                stats = fit.fit_stats(fins)
                say(f"[calibration] {name}@K{k} {label}: "
                    f"{len(fins)} finalists in {secs:.1f} s on {card}: "
                    + "; ".join(f"{f['config']} est {f['est_ms']:.4f} / "
                                f"measured {f['measured_ms']:.4f} ms"
                                for f in fins))
                say(f"[calibration] {name}@K{k} {label}: spearman "
                    f"{stats['spearman']:+.3f}, median |log(est/measured)| "
                    f"{stats['median_abs_log']:.3f}, worst "
                    f"{stats['worst_abs_log']:.3f}; winner {stats['winner']}"
                    f" {stats['winner_ms']:.4f} ms, the model's top "
                    f"{stats['top']} {stats['top_ms']:.4f} ms")
                if label != "calibrated":
                    continue
                if win.dense:
                    runner = DenseSDDMM.from_csr(csr, compute_dtype="tf32",
                                                 device=DEVICE)
                else:
                    runner = hybrid_runner(win.packed, win, "tf32")
                res = check_values(goldens[(name, k)],
                                   runner(a, b, order="csr").cpu().numpy())
                say(f"[calibration] {name}@K{k} calibrated winner in CSR "
                    f"order vs fp64 golden: {res}")
                if not res.passed or res.num_errors:
                    fail(f"{name}@K{k}: the calibrated winner has "
                         f"{res.num_errors} values outside the contract")
                del runner
    finally:
        fit.restore(shipped)
    if at.STREAM_GBPS != shipped["STREAM_GBPS"]:
        fail("the shipped constants were not put back")


def probe_main(torch, script, argv, label):
    """``script.main(argv)`` with its standard output captured, the launch
    counts zeroed just before and read just after: ``(output, launches)``;
    a non-zero exit fails the run."""
    import contextlib
    import io as io_mod
    from sddmm_tpu_torch import _kernels
    out = io_mod.StringIO()
    t0 = time.perf_counter()
    _kernels.launches.clear()
    with contextlib.redirect_stdout(out):
        rc = script.main(argv)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    say(f"[probes] {label}: exit {rc}, {time.perf_counter() - t0:.1f} s, "
        f"launches {launches}")
    if rc != 0:
        fail(f"{label} exited {rc}:\n{out.getvalue()[-2000:]}")
    return out.getvalue(), launches


def run_probes(torch, card, shootout_winner):
    """Phase 17: the config probes through their ``main`` on the card, in a
    temporary directory: ``torch_probe_configs`` on ``PROBE_CELL`` over T,
    S (phase 12's shoot-out winner), the card file's entry H and T's first
    one-factor neighbours (four configs),
    ``torch_probe_dense_dlmc`` at ``DENSE_PROBE_K``, and their fold by
    ``torch_autofold --validate`` into a copy of the card's configs file:
    the entry it writes is the one its rule (``choose``) picks from the
    log, the winner or H."""
    import contextlib
    import hashlib
    import io as io_mod
    import shutil
    from sddmm_tpu_torch import bench

    probe = harness_script("torch_probe_configs")
    dense = harness_script("torch_probe_dense_dlmc")
    fold = harness_script("torch_autofold")
    utc = harness_script("torch_update_tuned_configs")
    name, k = PROBE_CELL
    t_cfg = bench.load_tuned_config(name, k)
    h_cfg = bench.load_tuned_config(name, k, bench.H100_CONFIGS)
    # T, S and H (unless equal to T or the dense class), T's neighbours
    specs = fold.grid_specs(name, t_cfg, shootout_winner, h_cfg)[:4]
    committed = {p: hashlib.sha256(p.read_bytes()).hexdigest()
                 for p in (bench.TUNED_CONFIGS, bench.H100_CONFIGS)}
    with tempfile.TemporaryDirectory(prefix="sddmm_probes_") as tmp:
        logs = Path(tmp) / "probes"
        logs.mkdir()
        out, launches = probe_main(
            torch, probe, ["--matrix", name, "--k", str(k), "--rounds",
                           str(PROBE_ROUNDS), "--configs", ";".join(specs)],
            f"torch_probe_configs {name}@K{k} over {len(specs)} configs")
        tile = launches.get("sddmm_tile_dot_tf32", 0)
        for line in out.splitlines():
            if (" tiles=" in line or " contract " in line
                    or " sessions=" in line or "winner: [" in line):
                say(f"[probes] {line}")
        if out.count("contract PASS") != len(specs) or not tile:
            fail(f"torch_probe_configs: {out.count('contract PASS')} of "
                 f"{len(specs)} configs PASS, tile kernel {tile} launches")
        log = logs / f"probe_configs_{name}_k{k}.log"
        log.write_text(out)
        out, launches = probe_main(
            torch, dense, ["--k", str(DENSE_PROBE_K)],
            f"torch_probe_dense_dlmc K={DENSE_PROBE_K}")
        tile_dense = launches.get("sddmm_tile_dot_tf32", 0)
        for line in out.splitlines()[1:]:
            say(f"[probes] {line}")
        if "\ndense class: " not in out or not tile_dense:
            fail(f"torch_probe_dense_dlmc: no dense class line or no tile "
                 f"launch ({tile_dense})")
        dense_log = logs / f"probe_dense_dlmc_k{DENSE_PROBE_K}.log"
        dense_log.write_text(out)
        cfg_path = Path(tmp) / "tuned_configs_h100.json"
        shutil.copy(bench.H100_CONFIGS, cfg_path)
        out, _ = probe_main(torch, fold, [str(logs), "--validate",
                                          "--configs", str(cfg_path)],
                            "torch_autofold --validate")
        for line in out.splitlines():
            say(f"[probes] {line}")
        data = json.loads(cfg_path.read_text())
        want, why = fold.choose(log, utc.winner_of(log), h_cfg)
        with contextlib.redirect_stdout(io_mod.StringIO()):
            dense_won = fold.dense_decision(dense_log)
        old_dlmc = bench.load_tuned_config("dlmc", DENSE_PROBE_K,
                                           bench.H100_CONFIGS)
        want_dlmc = {"dense": True} if dense_won else old_dlmc
        staged = 1 + dense_won
        if (data[f"k{k}"][name] != want
                or data[f"k{DENSE_PROBE_K}"].get("dlmc") != want_dlmc
                or out.count("contract PASS errors=0/") != staged
                or bench.validate_tuned_configs(cfg_path)
                or card not in data["_comment"]):
            fail(f"torch_autofold: {name} {data[f'k{k}'][name]} (want "
                 f"{want}), dlmc {data[f'k{DENSE_PROBE_K}'].get('dlmc')} "
                 f"(want {want_dlmc}), comment {data['_comment']!r}")
    if committed != {p: hashlib.sha256(p.read_bytes()).hexdigest()
                     for p in committed}:
        fail("a committed configs file changed")
    say(f"[probes] {name}@K{k} ({why}): {want} folded and validated (0 "
        f"errors against fp64); dlmc@K{DENSE_PROBE_K} "
        f"{'dense class' if dense_won else 'hybrid kept'}; the committed "
        f"configs files unchanged; on {card}")


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
    from sddmm_tpu_torch.reorder.autotune import from_params

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
        rel4, abs4 = check_softmax(torch, sm, rng, card)
        say(f"[softmax] 20000 rows (every 7th empty, row 3 with 200000 "
            f"entries), H in {SOFTMAX_HEADS}, packed scores through inv_idx "
            "and CSR-order scores, forward and backward, two runs "
            "bit-equal: max |kernel - plain| / plain "
            f"{rel4:.3e} (tol {SOFTMAX_REL_TOL}), max abs {abs4:.3e}")

    # -- 4b. MiMo-V2-Flash's grouped-query layers --
    with Phase("MiMo layers"):
        mimo_launches, mimo_rec = run_mimo(torch, card)

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
    call_ms, passes = {}, {}
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
            passes[(name, k)] = kernel_pass(torch, td, runner, ops, iters,
                                            label, card)
            # the record's times sum the K=128 cells, one call each
            add_times(rec, passes[(name, k)], with_ms=k == 128)

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
        model_launches, model_rec, models = run_models(
            torch, sp, sm, card, csrs[GRAPH_CELL])
    rec.update(model_rec)

    # -- 10. the backward passes at the main path's shapes --
    with Phase("backward checks"):
        grad_abs = 0.0
        for name, k in GRAD_CELLS:
            csr, runner, _, a, b = cells[(name, k)]
            _, err = check_backward(torch, f"{name}@K{k}", runner, csr, a, b,
                                    heads=1)
            grad_abs = max(grad_abs, err)
        pl = generate.powerlaw_graph(2048, avg_degree=16, seed=44)
        t = from_params(pl, 64, alpha=0.1, delta=0.05, group_size=2,
                        k_chunks=2, hub_cols=256, hot_rows=128,
                        hot_rows_pre=True)
        _, err = check_backward(
            torch, "powerlaw 2048 slabs C=2", hybrid_runner(
                t.packed, t, "tf32"), pl,
            generate.make_dense(pl.m, 64, seed=1),
            generate.make_dense(64, pl.n, seed=2), heads=2)
        grad_abs = max(grad_abs, err)
        csr, _, _, a, b = cells[("clustered16", 128)]
        csr_bwd_launches, b4 = time_csr_backward(
            torch, "clustered16@K128", csr, torch.as_tensor(a, device=DEVICE),
            torch.as_tensor(np.ascontiguousarray(b.T), device=DEVICE),
            base_plan["clustered16"], card)
        # B5: the dense class's backward is two fp32 cuBLAS products and the
        # CSR gather's scatter (no hand kernel)
        csr, dense, ops, _, _ = cells[("dlmc", 128)]
        a_t, bt_t = (x.float().clone().requires_grad_() for x in ops)
        out = dense.run_padded(a_t, bt_t, order="csr")
        g = torch.rand(out.shape, device=DEVICE)
        b5 = cuda_time_ms(lambda: torch.autograd.grad(
            out, (a_t, bt_t), g, retain_graph=True), 10)
        # g read, the (M, N) cotangent written once, A and B^T read, dA and
        # dB^T written; two products of 2*M*N*K operations in fp32
        K = a_t.shape[1]
        bnd = bound_times(4 * csr.nnz + 4 * csr.m * csr.n
                          + 8 * (a_t.numel() + bt_t.numel()),
                          4.0 * csr.m * csr.n * K, FP32_FLOPS)
        say(f"[time] dlmc@K128 dense backward B5 (scatter into (M, N), 2 "
            f"fp32 cuBLAS products): {b5['median_ms']:.4f} ms, bound "
            f"{max(bnd.values()):.4f} ms (by "
            f"{'bytes' if bnd['bytes_ms'] >= bnd['ops_ms'] else 'operations'}"
            f") on {card}")
        del out, a_t, bt_t, g

    # -- 11. the training path --
    with Phase("training"):
        graph, x_graph, block, x_block, mask = models
        model_bwd, train_launches, train_rec = run_training(
            torch, sm, card, graph, x_graph, block, x_block, mask,
            csrs[GRAPH_CELL], csrs["clustered16"])
    train_rec["B1"]["max_abs_err"] = grad_abs
    train_rec["B4"] = new_record(0.0)
    add_times(train_rec, {"B4": b4})
    rec[_kernels.SPMM_ENTRY]["max_abs_err"] = max(
        rec[_kernels.SPMM_ENTRY]["max_abs_err"], abs3)
    rec[_kernels.SOFTMAX_ENTRY]["max_abs_err"] = max(
        rec[_kernels.SOFTMAX_ENTRY]["max_abs_err"], abs4)

    # -- 12. the entry points: bench route, shoot-out, CLI, profiler --
    with Phase("entry points"):
        shootout_winner = run_entry_points(torch, card, kind, cells, passes,
                                           goldens)

    # -- 13. device row clustering --
    with Phase("device clustering"):
        cluster_launches, cluster_rec = run_device_clustering(
            torch, card, cells, goldens)

    # -- 14. the multi-device path --
    with Phase("multi-device"):
        run_multi_device(torch, card, cells, packs, goldens)

    # -- 15. the harness scripts --
    with Phase("harness"):
        say(f"[harness] on {card}")
        run_harness(torch, card, kind)

    # -- 16. the layout model's calibration --
    with Phase("calibration"):
        run_calibration(torch, card, cells, goldens)

    # -- 17. the config probes --
    with Phase("probes"):
        run_probes(torch, card, shootout_winner)

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
                                      "attention, entry)", model_launches),
             _kernels.PROJ_GEMM_ENTRY: ("models (Longformer-shaped "
                                        "block-sparse attention)",
                                        model_launches)}
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
        elif kname == _kernels.PROJ_GEMM_ENTRY:
            source, replaces = ("proj_gemm.cu", "none (XLA's dots in "
                                "sddmm_tpu/models/block_sparse_attention.py)")
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
    # the backward kernels (this slice): the VJPs of the JAX programs
    for key, name, source, replaces, launches, path in (
            ("B1", f"{_kernels.TILE_GRAD_ENTRY} + "
             f"{_kernels.TILE_GRAD_REDUCE_ENTRY} (hybrid backward B1; the "
             "residual's SpMMs in the timed call)", "tile_grad.cu",
             "sddmm_tpu/ops/hybrid.py:135",
             train_launches.get(_kernels.TILE_GRAD_ENTRY, 0),
             f"factorization training ({TRAIN['steps']} steps)"),
            ("B2", _kernels.SOFTMAX_BWD_ENTRY, "segment_softmax.cu",
             "sddmm_tpu/models/graph_attention.py:30",
             model_bwd["_SoftmaxFnBackward"].get(_kernels.SOFTMAX_BWD_ENTRY,
                                                 0),
             "models' backward (graph attention, Longformer shape)"),
            # B3's counts: those read while the aggregation's backward ran
            ("B3 values", "sddmm_gather_dot_float32_float32 (SpMM backward "
             "B3, d values)", "gather_dot.cu", "sddmm_tpu/ops/spmm.py:23",
             model_bwd["_HeadSpmmFnBackward"].get(
                 "sddmm_gather_dot_float32_float32", 0),
             "models' backward (graph attention, Longformer shape)"),
            ("B3 dense", f"{_kernels.SPMM_ENTRY} (SpMM backward B3, d dense)",
             "spmm.cu", "sddmm_tpu/ops/spmm.py:23",
             model_bwd["_HeadSpmmFnBackward"].get(_kernels.SPMM_ENTRY, 0),
             "models' backward (graph attention, Longformer shape)"),
            ("B4", f"{_kernels.SPMM_ENTRY} (CSR SDDMM backward B4)",
             "spmm.cu", "sddmm_tpu/ops/csr_sddmm.py:25",
             csr_bwd_launches.get(_kernels.SPMM_ENTRY, 0),
             "csr_sddmm backward (clustered16 K=128)")):
        record.append(record_entry(name, f"sddmm_tpu_torch/csrc/{source}",
                                   replaces, launches, path, train_rec[key]))
    # the clustering kernel (this slice): both launches a round
    record.append(record_entry(
        f"{_kernels.CLUSTER_LEADERS_ENTRY} + {_kernels.CLUSTER_ASSIGN_ENTRY} "
        "(one clustering round K9)", "sddmm_tpu_torch/csrc/cluster_round.cu",
        "sddmm_tpu/reorder/device_cluster.py:51",
        cluster_launches[_kernels.CLUSTER_LEADERS_ENTRY],
        "device clustering (probe matrix, 102400 rows)", cluster_rec))
    # the grouped-query paths of MiMo-V2-Flash's layers (phase 4b)
    gather = "sddmm_gather_dot_float32_float32"
    for part, name, sources, replaces, kname in (
            ("rope", f"{_kernels.ROPE_ENTRY} (RoPE, forward in place and "
             "backward)", "rope.cu", "none (the JAX package has no RoPE)",
             _kernels.ROPE_ENTRY),
            ("scores", f"sddmm_tile_dot_float32 + {gather} + "
             f"{_kernels.TILE_GRAD_ENTRY} + {_kernels.TILE_GRAD_REDUCE_ENTRY}"
             " (grouped-query scores, head shift 4 and 3, and their "
             "backward)", "tile_dot.cu, gather_dot.cu, tile_grad.cu",
             "none (the JAX package has no grouped-query heads)",
             "sddmm_tile_dot_float32"),
            ("softmax", f"{_kernels.SOFTMAX_ENTRY} + "
             f"{_kernels.SOFTMAX_BWD_ENTRY} (the sink in the window layer, "
             "forward and backward)", "segment_softmax.cu",
             "none (the JAX package has no sink)", _kernels.SOFTMAX_ENTRY),
            ("aggregate", f"{_kernels.SPMM_ENTRY} + {gather} (V of the group"
             " read in place; dP; dV summing the group)",
             "spmm.cu, gather_dot.cu",
             "none (the JAX package has no grouped-query heads)",
             _kernels.SPMM_ENTRY)):
        record.append(record_entry(
            name, f"sddmm_tpu_torch/csrc/{sources}", replaces,
            mimo_launches.get(kname, 0), "MiMo layers (full and window, "
            "L=4096, 64 query heads over 4 or 8)", mimo_rec[part]))
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
