"""The program under test for SDDMM cells: the port's ``HybridSDDMM``,
packed by ``bench.fold_config`` from the card's entry for the traffic's
pattern and K in the configuration's ``tuned_configs`` file.

The timed call is ``device_prepare`` (storage cast and B^T layout) then
``run_padded`` into the traffic's output order."""

from __future__ import annotations

import numpy as np

from perfbench import patterns


def pattern(config: dict, traffic: dict) -> patterns.Pattern:
    return patterns.make(traffic["pattern"])


class System:
    def __init__(self, runner, order: str, info: dict):
        self.runner = runner
        self.order = order
        self.info = info
        self.mode = runner.compute_dtype

    def prepare(self, a_pad, bt_pad):
        return self.runner.device_prepare(a_pad, bt_pad)

    def call(self, ops):
        a_ops, bt_phys = ops
        return self.runner.run_padded(a_ops, bt_phys, order=self.order)


def build(config: dict, traffic: dict, pat: patterns.Pattern,
          device) -> System:
    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.data.sparse import CSR
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM

    k, mode = traffic["k"], config["compute_mode"]
    entry = bench.load_tuned_config(traffic["tuned_entry"], k,
                                    bench.H100_CONFIGS)
    if entry is None or entry.get("dense"):
        raise ValueError(f"no hybrid entry {traffic['tuned_entry']!r} at "
                         f"K={k} in {bench.H100_CONFIGS}")
    if entry.get("dtype", mode) != mode:
        raise ValueError(f"entry {entry} pins another mode than {mode}")
    csr = CSR((pat.m, pat.n), pat.row_ptr, pat.col_idx,
              np.ones(pat.nnz, dtype=np.float32))
    tuned = bench.fold_config(csr, k, entry, mode)
    runner = HybridSDDMM(tuned.packed, compute_dtype=mode,
                         k_chunks=tuned.k_chunks, use_pallas=tuned.use_pallas,
                         a_layout=tuned.a_layout, device=device)
    p = tuned.packed
    info = {"entry": entry, "packed_slots": int(p.packed_size),
            "residual": int(p.nnz_res),
            "super/quad/pair/group": [int(p.num_super), int(p.num_quads),
                                      int(p.num_pairs), int(p.num_groups)],
            "hub": int(p.hub_cols), "hot_rows": int(p.rowslab_nrows)}
    return System(runner, traffic["order"], info)
