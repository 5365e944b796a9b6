#!/usr/bin/env python3
"""Times the device row clustering (K9) and the segment softmax (K10 and its
backward B2) of one checkout of the PyTorch/CUDA port, on one card.

    python scripts/torch_kernel_cmp.py [--root DIR] [--label NAME]

Imports ``sddmm_tpu_torch`` from the checkout at DIR (default: the one this
script is in), so that one run on one card can measure two checkouts
in turns, e.g. a parent commit unpacked with ``git archive`` into the
git-ignored ``_checkout/``: parent, change, change, parent.  It uses only
entry points both must have: ``batched_cluster_device`` (its ``record``),
``segment_softmax_torch`` and ``segment_softmax_backward`` with the
models' attention core's row pointers and plan (``core.row_ptr``,
``core.softmax_plan``), the two attention models and
``utils.timing.cuda_time_ms``.
The shapes (the probe matrix, alpha, the Longformer shape), the probe's
row order and the per-launch timing come from this script's own
``chip_smoke.py``; the host enqueue time from ``b1_profile.py`` beside it.

It prints one JSON line: the card (``nvidia-smi`` name and power limit);
for the probe matrix of ``chip_smoke.py``'s phase 13 the rounds, the
clustering's host wall, its device time (CUDA events around the rounds'
launches, from the record) and each of the two kernels' device time (CUDA
events around every launch, a second run), all as ms a round of the
rounds that ran; and for the graph-attention and Longformer-shaped
patterns (``chip_smoke.py``'s models) the softmax forward and backward:
median CUDA-event ms of 20 calls back to back after 3 (``cuda_time_ms``;
a call's host time where it exceeds its device time), host ms a call takes
to enqueue behind a queue of device work (``enqueue_ms``), device ms by
``torch.profiler``, the call's cost apart from its kernel's (the same
times of the call and of its C entry alone, and of one call on an idle
device: ``launch_costs``), and by row class and by heads a group walks
(``head_group``, put in place of the checkout's rule) where the checkout
has them.  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from b1_profile import enqueue_ms

ROOT = Path(__file__).resolve().parents[1]
ITERS = 20
ENQUEUE_CALLS = 30


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (it runs nothing when
    imported)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(torch, fn, calls=10):
    """Device time of one ``fn()`` by ``torch.profiler``: its kernels'
    summed durations over ``calls`` calls after 3, divided by ``calls``."""
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # the profiler now and then records no device events
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "segment_softmax" in e.name)
        if us:
            return us / 1e3 / calls
    return None


def idle_ms(torch, fn, calls=ITERS):
    """Median CUDA-event ms of one ``fn()`` started on an idle device (a
    synchronise before each call): its host time and its launch latency
    with its device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    times.sort()
    return times[len(times) // 2]


def c_entry(kern, name, fn):
    """The C entry ``name`` alone, with the arguments ``fn()`` passes it
    (captured from one call through ``kern.launch``): a function of no
    arguments that calls it, skipping the wrapper and the launch count."""
    seen = []
    launch = kern.launch

    def capture(entry, *args):
        if entry == name:
            seen.append(args)
        return launch(entry, *args)

    kern.launch = capture
    try:
        fn()
    finally:
        kern.launch = launch
    entry = getattr(kern.load(), name)
    args = seen[-1]
    return lambda: entry(*args)


def launch_costs(torch, kern, name, fn):
    """A softmax call's time apart from its kernel's: ``fn()`` and its C
    entry alone (``c_entry``), each as host ms a call behind a queue of
    device work (``enqueue_ms``), CUDA-event ms of calls back to back and
    of one call on an idle device (``idle_ms``)."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    out = {}
    for what, f in (("call", fn), ("c_entry", c_entry(kern, name, fn))):
        out[f"{what}_enqueue_ms"] = enqueue_ms(torch, f, ENQUEUE_CALLS)
        out[f"{what}_events_ms"] = cuda_time_ms(f, ITERS)["median_ms"]
        out[f"{what}_idle_ms"] = idle_ms(torch, f)
    return out


def clustering(torch, pkg, cs):
    generate = importlib.import_module("sddmm_tpu_torch.data.generate")
    dc = importlib.import_module("sddmm_tpu_torch.reorder.device_cluster")
    args = cs.cluster_args(generate.block_clustered(**cs.PROBE))
    alpha = cs.CLUSTER_ALPHA
    dc.batched_cluster_device(*args, alpha, device="cuda")  # warm-up
    runs = []
    for _ in range(3):
        rec = {}
        torch.cuda.synchronize()
        dc.batched_cluster_device(*args, alpha, device="cuda", record=rec)
        ran = len(rec["clusters"])
        device_ms = rec.get("device_ms", sum(rec["round_ms"]))
        runs.append({"rounds": rec["rounds"], "ran": ran,
                     "seconds": rec["seconds"],
                     "wall_ms_round": rec["seconds"] * 1e3 / ran,
                     "device_ms_round": device_ms / ran,
                     "setup_seconds": rec.get("setup_seconds"),
                     "loop_wall_ms_round": (rec["loop_seconds"] * 1e3 / ran
                                            if "loop_seconds" in rec
                                            else None)})
    kern = pkg._kernels
    names = (kern.CLUSTER_LEADERS_ENTRY, kern.CLUSTER_ASSIGN_ENTRY)
    (_, n), phase = cs.launch_events(torch, kern, names, lambda: (
        dc.batched_cluster_device(*args, alpha, device="cuda")))
    runs.sort(key=lambda r: r["seconds"])
    best = runs[len(runs) // 2]
    best["clusters"] = n
    best["phase_ms_round"] = {k: sum(v) / best["ran"]
                              for k, v in phase.items()}
    return best


def softmax(torch, sm, kern, model, heads, d):
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    core = model.core
    plan, runner = core.softmax_plan, core.runner
    g0 = torch.Generator(device="cuda").manual_seed(0)
    F = runner.packed.packed_size
    flat = torch.randn((heads, F), generator=g0, device="cuda") * 4
    inv, scale = runner.inv_idx32, 1.0 / d ** 0.5
    out = torch.empty((heads, inv.numel()), device="cuda")

    def fwd(pl=plan):
        return sm.segment_softmax_torch(flat, core.row_ptr, scale, inv, pl,
                                        out=out)

    p = fwd().clone()
    g = torch.randn(p.shape, generator=g0, device="cuda")

    def bwd(pl=plan):
        return sm.segment_softmax_backward(p, g, core.row_ptr, scale, inv,
                                           F, pl)

    res = {"heads": heads, "nnz": int(inv.numel()),
           "forward_ms": cuda_time_ms(fwd, ITERS)["median_ms"],
           "backward_ms": cuda_time_ms(bwd, ITERS)["median_ms"],
           "forward_enqueue_ms": enqueue_ms(torch, fwd, ENQUEUE_CALLS),
           "backward_enqueue_ms": enqueue_ms(torch, bwd, ENQUEUE_CALLS),
           "forward_device_ms": device_ms(torch, fwd),
           "backward_device_ms": device_ms(torch, bwd)}
    res["forward_costs"] = launch_costs(torch, kern, kern.SOFTMAX_ENTRY, fwd)
    res["backward_costs"] = launch_costs(torch, kern, kern.SOFTMAX_BWD_ENTRY,
                                         bwd)
    if hasattr(sm, "head_group"):
        rule = sm.head_group
        res["head_group"] = [rule(heads, backward=b)
                             for b in (False, True)]
        try:
            for hg in sorted({1, 2, 3, 4, 6, heads}):
                if hg <= heads:
                    sm.head_group = lambda heads, backward, hg=hg: hg
                    res[f"hg{hg}_forward_device_ms"] = device_ms(torch, fwd)
                    res[f"hg{hg}_backward_device_ms"] = device_ms(torch,
                                                                  bwd)
        finally:
            sm.head_group = rule
    if hasattr(plan, "by_class"):
        for name, part in plan.by_class().items():
            res[f"{name}_rows"] = part.rows.numel()
            res[f"{name}_forward_device_ms"] = device_ms(
                torch, lambda: fwd(part))
            res[f"{name}_backward_device_ms"] = device_ms(
                torch, lambda: bwd(part))
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    pkg = importlib.import_module("sddmm_tpu_torch")
    assert Path(pkg.__file__).resolve().is_relative_to(
        Path(opts.root).resolve()), pkg.__file__
    pkg._kernels = importlib.import_module("sddmm_tpu_torch._kernels")
    pkg._kernels.load()
    sm = importlib.import_module("sddmm_tpu_torch.ops.softmax")
    models = importlib.import_module("sddmm_tpu_torch.models")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs = smoke()
    t0 = time.perf_counter()
    out = {"label": opts.label, "card": smi,
           "k9_probe": clustering(torch, pkg, cs)}
    bench = importlib.import_module("sddmm_tpu_torch.bench")
    adj = bench.suite(quick=False)[cs.GRAPH_CELL]()
    graph = models.GraphAttentionLayer(adj, cs.GRAPH_WIDTH, cs.GRAPH_WIDTH,
                                       device="cuda")
    lf = cs.LONGFORMER
    mask = models.make_attention_mask(lf["seq_len"], window=lf["window"],
                                      num_global=lf["num_global"])
    block = models.BlockSparseAttention(mask, lf["hidden"], lf["heads"],
                                        lf["head_dim"], device="cuda")
    out["softmax_graph"] = softmax(torch, sm, pkg._kernels, graph, 1,
                                   cs.GRAPH_WIDTH)
    out["softmax_longformer"] = softmax(torch, sm, pkg._kernels, block,
                                        lf["heads"], lf["head_dim"])
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
