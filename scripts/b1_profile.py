#!/usr/bin/env python3
"""The hybrid's backward (B1, ``HybridSDDMM.vjp``) by kernel and on the host,
on one card.

    python scripts/b1_profile.py [--calls 10]

At two shapes of ``chip_smoke.py``: the factorization packing (the bench's
clustered16, ``SparseFactorizationModel.from_csr`` at K=128, one head) and
the Longformer-shaped attention's packing (12 heads of 64), on U[0,2)
operands and cotangent.  For each it prints one JSON line: the device time
of one backward by kernel name (``torch.profiler``, ``--calls`` calls after
3 warm-ups), the host time one call takes to enqueue its work, for ``vjp``
and for the read-pattern route (``vjp_read_pattern``), measured behind a
long device queue so the host never waits, and the functions of ``vjp``'s
host path that take the most time (``cProfile``, cumulative seconds a
call).  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import cProfile
import importlib.util
import json
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def enqueue_ms(torch, fn, calls):
    """Host ms a call of ``fn`` takes to enqueue, with a queue of fp32
    products ahead of it on the device."""
    x = torch.rand(8192, 8192, device="cuda")
    for _ in range(3 * calls):
        x @ x
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def device_by_kernel(torch, fn, calls):
    """Device ms of one ``fn()`` by kernel name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "device_time_total", None) or e.cuda_time_total
            out[e.key[:80]] = t / calls / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_top(torch, fn, calls):
    """The 8 [function, cumulative ms a call] of ``fn``'s host path that
    take the most, the most first (cProfile, behind a long device queue)."""
    x = torch.rand(8192, 8192, device="cuda")
    for _ in range(3 * calls):
        x @ x
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = [(f"{Path(f).name}:{line}({name})", ct / calls * 1e3)
            for (f, line, name), (_, _, _, ct, _) in stats.items()]
    return sorted(rows, key=lambda r: -r[1])[:8]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script times the "
                 "card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sddmm_tpu_torch.models import (BlockSparseAttention,
                                        SparseFactorizationModel,
                                        make_attention_mask)
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def u02(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 2

    csr = smoke.suite()["clustered16"]()
    fact = SparseFactorizationModel.from_csr(csr, smoke.TRAIN["k"],
                                             device="cuda").runner
    p = fact.packed
    k = smoke.TRAIN["k"]
    cases = [("factorization clustered16 K=128", fact,
              u02(1, p.m + 1, k), fact.device_bt(u02(1, p.n + 1, k)),
              u02(1, p.packed_size))]
    lf = smoke.LONGFORMER
    mask = make_attention_mask(lf["seq_len"], window=lf["window"],
                               num_global=lf["num_global"])
    block = BlockSparseAttention(mask, lf["hidden"], lf["heads"],
                                 lf["head_dim"], device="cuda").runner
    bp = block.packed
    h, d = lf["heads"], lf["head_dim"]
    cases.append(("Longformer shape, 12 heads K=64", block,
                  u02(h, bp.m + 1, d), block.device_bt(u02(h, bp.n + 1, d)),
                  u02(h, bp.packed_size)))
    for label, runner, a, bt, g in cases:
        bt = bt.contiguous()

        def new():
            return runner.vjp(a, bt, g)

        def old():
            return runner.vjp_read_pattern(a, bt, g)

        rec = {"card": card, "cell": label,
               "device_ms_by_kernel": device_by_kernel(torch, new,
                                                       args.calls),
               "read_pattern_device_ms_by_kernel": device_by_kernel(
                   torch, old, args.calls)}
        rec["device_ms"] = sum(rec["device_ms_by_kernel"].values())
        rec["read_pattern_device_ms"] = sum(
            rec["read_pattern_device_ms_by_kernel"].values())
        rec["host_enqueue_ms"] = enqueue_ms(torch, new, 5 * args.calls)
        rec["read_pattern_host_enqueue_ms"] = enqueue_ms(torch, old,
                                                         5 * args.calls)
        rec["host_top_ms"] = host_top(torch, new, 5 * args.calls)
        print(json.dumps(rec), flush=True)
    if "jax" in sys.modules:
        sys.exit("jax was imported")


if __name__ == "__main__":
    main()
