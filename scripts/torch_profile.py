#!/usr/bin/env python3
"""Device time by kernel of the PyTorch/CUDA port's calls, on one card.

    python scripts/torch_profile.py [--root DIR] [--label NAME] [--calls 20]
                                    [--training-only]

Imports ``sddmm_tpu_torch`` from the checkout at DIR (default: the one this
script is in), so that one session on one card can measure two checkouts
in turns, e.g. a parent commit unpacked with ``git archive`` beside the
working tree: parent, change, change, parent.  It uses only entry points
both have (``HybridSDDMM``, ``DenseSDDMM``, the two attention models,
``csr_spmm_torch``).

For each K=128 cell of ``chip_smoke.py`` (generated and packed as it does)
one call in packed order, the CSR baseline (``csr_sddmm_torch``, with
the checkout's gather-dot plan where it has one) and
``torch.sparse.sampled_addmm`` at the same entries, for the
graph-attention and Longformer-shaped forwards, and for the SpMM alone at
the models' shapes, it prints one JSON line: the host wall of a call
(CUDA-synchronised, without the profiler), the device time of a call by
kernel group from ``torch.profiler`` (the tile kernel, the hybrid
backward's tile-grad kernel and its reduction, the gather-dot, the segment
softmax, the SpMM, cuBLAS, and every other kernel: torch ops, cuSPARSE),
the launches of a call per group, the device busy share (device time over
host wall), and the largest kernels of the "other" group by name
(``other_top``: [name, ms a call, launches a call]); a packed call's record
also holds the runner's ``measure_kernel_ms`` (event time) where the
checkout has it.  Where the checkout
has the training path (``models.factorization``), it adds the training
cells: one factorization train step on clustered16 at K=128 (forward,
backward, Adam), the two models' forward and backward of sum(out^2), and
the dense class's forward and backward on dlmc into CSR order
(``--training-only``: these alone).  Needs a CUDA card; imports nothing of
JAX.
"""

import argparse
import collections
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("clustered16", "clustered128", "powerlaw", "banded", "dlmc")
K = 128


def group(name: str) -> str:
    """The kernel group of a device event's name (cuBLAS names carry
    "tilesize", so they are matched first)."""
    if "gemm" in name or "cutlass" in name or "xmma" in name:
        return "cublas"
    if "tile_grad" in name:
        return "tile_grad"
    if "tile_dot" in name or "tile_table" in name:
        return "tile"
    if "gather_dot" in name:
        return "gather_dot"
    if "spmm" in name:
        return "spmm"
    if "segment_softmax_backward" in name:
        return "softmax_bwd"
    if "segment_softmax" in name:
        return "softmax"
    return "other"


#: the "other" kernels listed by name in a record
OTHER_TOP = 8


def profile(torch, fn, calls: int) -> dict:
    """Host wall and device time by kernel group of one ``fn()``, averaged
    over ``calls`` calls after 3 warm-ups."""
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler now and then records no device events at all: try again
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = collections.Counter()
        launches = collections.Counter()
        other = collections.defaultdict(lambda: [0.0, 0.0])
        for e in prof.events():
            # a user annotation (``Optimizer.step#Adam.step``) spans kernels
            # the profiler lists too: not a kernel of its own
            if (e.device_type != DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            g = group(e.name)
            t = e.time_range.elapsed_us() / 1e3 / calls
            ms[g] += t
            launches[g] += 1 / calls
            if g == "other":
                other[e.name][0] += t
                other[e.name][1] += 1 / calls
        if ms:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    device_ms = sum(ms.values())
    return {"host_ms": host_ms, "device_ms": device_ms,
            "busy": device_ms / host_ms,
            "by_group_ms": dict(ms), "launches": dict(launches),
            "tile_plus_other_ms": ms["tile"] + ms["other"],
            "other_top": sorted(([n[:120], t, c] for n, (t, c)
                                 in other.items()),
                                key=lambda x: -x[1])[:OTHER_TOP]}


def csr_baseline(torch, csr, a, b):
    """One CSR-baseline call at the pattern of ``csr``, through the
    checkout's gather-dot plan where it has one (``csr_plan``)."""
    # the module by its full path: ``sddmm_tpu_torch.ops.csr_sddmm`` is
    # also a function of ``sddmm_tpu_torch.ops``
    cs = importlib.import_module("sddmm_tpu_torch.ops.csr_sddmm")
    args = (torch.as_tensor(a, device="cuda"),
            torch.as_tensor(np.ascontiguousarray(b.T), device="cuda"),
            torch.as_tensor(csr.row_indices(), dtype=torch.int32,
                            device="cuda"),
            torch.as_tensor(csr.col_idx, dtype=torch.int32, device="cuda"))
    kw = ({"plan": cs.csr_plan(csr).to("cuda")} if hasattr(cs, "csr_plan")
          else {})
    return lambda: cs.csr_sddmm_torch(*args, **kw)


def sampled_addmm(torch, csr, a, b):
    """``torch.sparse.sampled_addmm`` in fp32 at the pattern of ``csr``
    (the library call the CSR baseline is held against; the port never
    calls it)."""
    s = torch.sparse_csr_tensor(
        torch.as_tensor(csr.row_ptr, dtype=torch.int64, device="cuda"),
        torch.as_tensor(csr.col_idx, dtype=torch.int64, device="cuda"),
        torch.zeros(csr.nnz, device="cuda"), size=(csr.m, csr.n))
    a_t = torch.as_tensor(a, device="cuda")
    # B as the transpose of a row-major B^T, as chip_smoke.py times it:
    # cuSPARSE then reads each column of B contiguously
    mat2 = torch.as_tensor(np.ascontiguousarray(b.T), device="cuda").T
    return lambda: torch.sparse.sampled_addmm(s, a_t, mat2, beta=0.0)


def training(torch, smoke, emit, csrs, graph, x_graph, block, x_block,
             calls):
    """The training cells: a factorization train step, the models'
    forward and backward, and the dense class's into CSR order."""
    from sddmm_tpu_torch.models import SparseFactorizationModel
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.data import generate
    csr = csrs["clustered16"]
    model = SparseFactorizationModel.from_csr(
        csr, smoke.TRAIN["k"], learning_rate=smoke.TRAIN["lr"],
        device="cuda")
    model.init(torch.Generator().manual_seed(0))
    step = model.make_train_step()
    tp = model.pack_targets(csr.values)
    emit(f"factorization step K={smoke.TRAIN['k']}", profile(
        torch, lambda: step(tp), calls))
    for name, m, x in (("graph attention", graph, x_graph),
                       ("Longformer", block, x_block)):
        def fwd_bwd(m=m, x=x):
            m.zero_grad(set_to_none=True)
            m(x).square().sum().backward()
        emit(f"{name} forward + backward", profile(torch, fwd_bwd, calls))
    csr = csrs["dlmc"]
    dense = DenseSDDMM.from_csr(csr, compute_dtype="tf32", device="cuda")
    a, bt = dense.prepare_operands(generate.make_dense(csr.m, 128, seed=1),
                                   b=generate.make_dense(128, csr.n, seed=2))
    a.requires_grad_()
    bt.requires_grad_()
    g = torch.rand(csr.nnz, device="cuda")
    emit("dlmc dense forward + backward (CSR order)", profile(
        torch, lambda: dense.run_padded(a, bt, order="csr").backward(g),
        calls))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--training-only", action="store_true",
                    help="profile the training cells only")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script times the "
                 "card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.models import (BlockSparseAttention,
                                        GraphAttentionLayer,
                                        make_attention_mask)
    from sddmm_tpu_torch.ops import spmm as sp
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    import sddmm_tpu_torch

    label = args.label or str(root)
    card = torch.cuda.get_device_name(0)

    def emit(name, rec):
        print(json.dumps({"label": label, "package":
                          str(Path(sddmm_tpu_torch.__file__).parent),
                          "card": card, "cell": name, **rec}), flush=True)

    configs = json.loads((ROOT / "results" / "tuned_configs.json")
                         .read_text())[f"k{K}"]
    gens = smoke.suite()
    csrs = {name: gens[name]() for name in CELLS}
    # the models outside inference_mode: the training cells differentiate
    # through their weights
    lf = smoke.LONGFORMER
    adj = csrs[smoke.GRAPH_CELL]
    graph = GraphAttentionLayer(adj, smoke.GRAPH_WIDTH, smoke.GRAPH_WIDTH,
                                device="cuda")
    graph.init(torch.Generator().manual_seed(0))
    mask = make_attention_mask(lf["seq_len"], window=lf["window"],
                               num_global=lf["num_global"])
    block = BlockSparseAttention(mask, lf["hidden"], lf["heads"],
                                 lf["head_dim"], device="cuda")
    block.init(torch.Generator().manual_seed(1))
    x_graph = torch.as_tensor(generate.make_dense(
        adj.m, smoke.GRAPH_WIDTH, seed=1), device="cuda")
    x_block = torch.as_tensor(generate.make_dense(
        lf["seq_len"], lf["hidden"], seed=3), device="cuda")
    with torch.inference_mode():
        for name in () if args.training_only else CELLS:
            csr = csrs[name]
            cfg = configs[name]
            if cfg.get("dense"):
                runner = DenseSDDMM.from_csr(
                    csr, compute_dtype=cfg.get("dtype", "tf32"),
                    device="cuda")
            else:
                t = smoke.tuned(csr, K, cfg)
                runner = HybridSDDMM(t.packed,
                                     compute_dtype=cfg.get("dtype", "tf32"),
                                     k_chunks=t.k_chunks,
                                     use_pallas=t.use_pallas,
                                     a_layout=t.a_layout, device="cuda")
            a = generate.make_dense(csr.m, K, seed=1)
            b = generate.make_dense(K, csr.n, seed=2)
            ops = runner.prepare_operands(a, b=b)
            rec = profile(torch, lambda: runner.run_padded(*ops), args.calls)
            if hasattr(runner, "measure_kernel_ms"):
                # the runner's own timer (event time), beside device time
                rec["measure_kernel_ms"] = runner.measure_kernel_ms(*ops)
            emit(f"{name}@K{K} packed", rec)
            del runner, ops
            emit(f"{name}@K{K} CSR baseline", profile(
                torch, csr_baseline(torch, csr, a, b), args.calls))
            emit(f"{name}@K{K} sampled_addmm", profile(
                torch, sampled_addmm(torch, csr, a, b), args.calls))

        if not args.training_only:
            emit("graph attention forward", profile(
                torch, lambda: graph(x_graph), args.calls))
            emit("Longformer forward", profile(
                torch, lambda: block(x_block), args.calls))
        for name, agg, heads, d in () if args.training_only else (
                ("graph", graph.core.agg, 1, smoke.GRAPH_WIDTH),
                ("Longformer", block.core.agg, lf["heads"], lf["head_dim"])):
            g = torch.Generator(device="cuda").manual_seed(0)
            w = torch.rand((heads, agg.cols.shape[0]), generator=g,
                           device="cuda")
            v = torch.rand((heads, agg.shape[1], d), generator=g,
                           device="cuda")
            emit(f"SpMM at the {name} shape", profile(
                torch, lambda: sp.head_spmm(w, v, agg), args.calls))
    if importlib.util.find_spec("sddmm_tpu_torch.models.factorization"):
        training(torch, smoke, emit, csrs, graph, x_graph, block, x_block,
                 args.calls)
    if "jax" in sys.modules:
        sys.exit("jax was imported")


if __name__ == "__main__":
    main()
