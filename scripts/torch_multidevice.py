#!/usr/bin/env python3
"""The multi-device phase of ``chip_smoke.py`` alone, over the machine's
cards.

    python scripts/torch_multidevice.py

With 4 or more cards the 4-rank meshes run over NCCL with a card a rank;
with fewer, over gloo with CUDA tensors on card 0 (as the smoke does).
The phase's inputs are built as the smoke builds them: the bench's
clustered16 at K=128 on its committed config and the dlmc cell, with their
fp64 goldens; then ``chip_smoke.run_multi_device`` runs the dry run over
(2, 2) and (1, 1) and the full-size (2, 2) checks, printing each rank's
step, local kernels and all-reduce.  Needs a CUDA card; imports nothing of
JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K = 128


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.reference import sddmm_reference

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script "
                         "needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.device_count()} card(s):\n{card}",
          flush=True)
    card = card.splitlines()[0]
    t0 = time.perf_counter()
    _kernels.load()
    gens = cs.suite()
    configs = json.loads((ROOT / "results" / "tuned_configs.json")
                         .read_text())
    cells, packs, goldens = {}, {}, {}
    for name in ("clustered16", "dlmc"):
        csr = gens[name]()
        cfg = configs[f"k{K}"][name]
        mode = cfg.get("dtype", "tf32")
        if cfg.get("dense"):
            runner = DenseSDDMM.from_csr(csr, compute_dtype=mode,
                                         device="cuda")
        else:
            t = cs.tuned(csr, K, cfg)
            runner = cs.hybrid_runner(t.packed, t, mode)
            packs[(name, K)] = (t.packed, t)
        a = generate.make_dense(csr.m, K, seed=1)
        b = generate.make_dense(K, csr.n, seed=2)
        cells[(name, K)] = (csr, runner, None, a, b)
        goldens[(name, K)] = sddmm_reference(a, b, csr)
    print(f"[setup] build and inputs: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    cs.run_multi_device(torch, card, cells, packs, goldens)
    print(f"[done] multi-device phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
