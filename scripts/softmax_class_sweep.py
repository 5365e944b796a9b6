"""The segment softmax's row classes on the card, one launch at a time.

Times the kernel's forward and backward (device time by ``torch.profiler``:
the ``segment_softmax`` kernels' durations over 10 launches after 3, a
launch's share) over the attention patterns of the benchmark's train
cells:

- MiMo-V2-Flash's full layer: the causal mask over 4,096 positions, 64
  heads, 3,456 of its rows 641-4096 entries long;
- Longformer-base's mask: 4,096 positions, window 256 a side, one global
  token (its row of 4,096 entries), 12 heads;

each with its packing's ``inv_idx`` (the scores gathered as the models
read them).  For each pattern it prints one JSON line a case:

- ``all``: the plan as it stands, and each row class of it alone
  (``SoftmaxPlan.by_class``), with the class's entries and its share of
  the byte bound (scores read once and probabilities written once, 8 bytes
  an entry a head; the backward 12);
- ``block_heads``: the block rows alone with each head group
  (``SOFTMAX_BLOCK_HEADS``) of 1 to 64, forward and backward, outputs
  bit-equal to the first group's;
- ``block_row``: the whole plan with the block rows' limit
  (``SOFTMAX_BLOCK_ROW``) at 640 (no block rows: every long row on a
  cluster, as before the block rows), 1024, 2048 and 4096.

The head group and the limit in ``ops/softmax.py`` come from these
readings (PERF.md §6).  Prints the card's name and power limit first.
Run on the card::

    python scripts/softmax_class_sweep.py [--reps N] [--only NAME]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sddmm_tpu_torch.models import (AttentionKind,  # noqa: E402
                                    BlockSparseAttention,
                                    HybridAttentionStack,
                                    make_attention_mask)
from sddmm_tpu_torch.ops import softmax as sm  # noqa: E402

HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s


def mimo_full(device):
    """MiMo-V2-Flash's full layer at 4096 positions: (core, heads, head
    dim)."""
    kind = AttentionKind("full", 4, 5e6, False)
    st = HybridAttentionStack(4096, ["full"], [kind], 4096, 64, 192, 128,
                              64, 0.707, device=device)
    return st.cores["full"], 64, 192


def longformer(device):
    """Longformer-base's layer at 4096 positions: (core, heads, head
    dim)."""
    mask = make_attention_mask(4096, window=256, num_global=1)
    return BlockSparseAttention(mask, 768, 12, 64, device=device).core, 12, 64


PATTERNS = {"mimo_full": mimo_full, "longformer": longformer}


def device_ms(fn, reps):
    """Device ms of one ``fn()``: the ``segment_softmax`` kernels' summed
    durations over ``reps`` calls after 3, divided by ``reps``."""
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # the profiler now and then records no device events
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "segment_softmax" in e.name)
        if us:
            return us / 1e3 / reps
    return None


class Case:
    """A pattern's scores, probabilities and cotangent, and its launches."""

    def __init__(self, core, heads, head_dim, device):
        gen = torch.Generator(device).manual_seed(0)
        self.core, self.heads = core, heads
        self.inv = core.runner.inv_idx32
        self.size = core.runner.packed.packed_size
        self.scale = head_dim ** -0.5
        self.flat = torch.randn((heads, self.size), generator=gen,
                                device=device) * 4
        self.out = torch.empty((heads, self.inv.numel()), device=device)
        self.p = self.forward(core.softmax_plan).clone()
        self.g = torch.randn(self.p.shape, generator=gen, device=device)

    def forward(self, plan):
        return sm.segment_softmax_torch(self.flat, self.core.row_ptr,
                                        self.scale, self.inv, plan,
                                        out=self.out)

    def backward(self, plan):
        return sm.segment_softmax_backward(self.p, self.g, self.core.row_ptr,
                                           self.scale, self.inv, self.size,
                                           plan)

    def time(self, plan, entries, reps):
        """Forward and backward device ms over ``plan`` and their shares of
        the byte bound of ``entries`` entries a head."""
        fwd = device_ms(lambda: self.forward(plan), reps)
        bwd = device_ms(lambda: self.backward(plan), reps)
        bound = self.heads * entries * 4 / HBM_BYTES_PER_MS
        return {"entries": entries, "forward_ms": fwd, "backward_ms": bwd,
                "forward_bound_share": 2 * bound / fwd if fwd else None,
                "backward_bound_share": 3 * bound / bwd if bwd else None}


def sweep(name, case, reps):
    plan = case.core.softmax_plan
    base = {"pattern": name, "heads": case.heads,
            "counts": plan.counts(), "class_entries": plan.entries}
    res = dict(base, case="all", **case.time(plan, sum(plan.entries), reps))
    for cls, part in plan.by_class().items():
        res[cls] = case.time(part, sum(part.entries), reps)
    print(json.dumps(res), flush=True)
    block = plan.by_class().get("block")
    if block is not None:
        keep = sm.SOFTMAX_BLOCK_HEADS
        first = None
        try:
            for bh in (1, 2, 4, 8, 16, 32, 64):
                if bh > case.heads:
                    break
                sm.SOFTMAX_BLOCK_HEADS = (bh, bh)
                res = dict(base, case="block_heads", block_heads=bh,
                           **case.time(block, block.entries[2], reps))
                got = (case.forward(block).clone(),
                       case.backward(block).clone())
                if first is None:
                    first = got
                res["bit_equal"] = all(torch.equal(a, b)
                                       for a, b in zip(got, first))
                print(json.dumps(res), flush=True)
        finally:
            sm.SOFTMAX_BLOCK_HEADS = keep
    keep = sm.SOFTMAX_BLOCK_ROW
    try:
        for limit in (640, 1024, 2048, 4096):
            sm.SOFTMAX_BLOCK_ROW = limit
            plan = sm.softmax_plan(case.core.row_ptr.cpu().numpy(),
                                   case.flat.device)
            res = dict(base, case="block_row", block_row=limit,
                       counts=plan.counts(), class_entries=plan.entries,
                       **case.time(plan, sum(plan.entries), reps))
            print(json.dumps(res), flush=True)
    finally:
        sm.SOFTMAX_BLOCK_ROW = keep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", choices=sorted(PATTERNS))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi,
                      "block_heads": sm.SOFTMAX_BLOCK_HEADS,
                      "block_row": sm.SOFTMAX_BLOCK_ROW}), flush=True)
    for name, build in PATTERNS.items():
        if opts.only and name != opts.only:
            continue
        core, heads, head_dim = build(device)
        sweep(name, Case(core, heads, head_dim, device), opts.reps)
        del core
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
