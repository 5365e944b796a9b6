"""The program under test for attention cells: a stack of the port's
``models.BlockSparseAttention`` layers, ``num_hidden_layers`` deep, each
with its residual connection (x + attention(x)), over the configuration's
sliding-window mask (``attention_window`` wide, ``port.num_global`` global
tokens) at the traffic's sequence length, in the configuration's compute
mode.

Every layer has the same mask, so the mask is packed once, into one
module, and each layer runs that module on its own weights
(``torch.func.functional_call``)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import patterns
from perfbench.attention_inputs import dims

#: the layer's weights, in ``load_weights``' order
NAMES = ("w_q", "w_k", "w_v", "w_o")


def pattern(config: dict, traffic: dict) -> patterns.Pattern:
    return patterns.attention_window(traffic["seq_len"],
                                     config["attention_window"][0] // 2,
                                     config["port"]["num_global"])


class System:
    def __init__(self, model, info: dict):
        self.model = model
        self.info = info
        self.mode = model.runner.compute_dtype
        self.layers = []

    def load_weights(self, weights) -> None:
        """One ``(w_q, w_k, w_v, w_o)`` a layer: (H, F, D) x 3 and
        (H*D, F)."""
        self.layers = [{name: torch.nn.Parameter(w.detach().float().clone())
                        for name, w in zip(NAMES, ws)} for ws in weights]

    def parameters(self):
        """The trained weights, layer by layer in ``load_weights``' order."""
        return [layer[name] for layer in self.layers for name in NAMES]

    def forward(self, x):
        for layer in self.layers:
            x = x + torch.func.functional_call(self.model, layer, (x,))
        return x


def build(config: dict, traffic: dict, pat: patterns.Pattern,
          device) -> System:
    from sddmm_tpu_torch.data.sparse import CSR
    from sddmm_tpu_torch.models.block_sparse_attention import (
        BlockSparseAttention)

    d = dims(config)
    mask = CSR((pat.m, pat.n), pat.row_ptr, pat.col_idx,
               np.ones(pat.nnz, dtype=np.float32))
    model = BlockSparseAttention(
        mask, d["hidden"], d["heads"], d["head_dim"],
        alpha=config["port"]["alpha"], delta=config["port"]["delta"],
        compute_dtype=config["compute_mode"], device=device)
    p = model.runner.packed
    info = {"mask_nnz": pat.nnz, "layers": d["layers"],
            "packed_slots": int(p.packed_size), "residual": int(p.nnz_res)}
    return System(model, info)
