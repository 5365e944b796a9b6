"""Dot-product graph attention, the serving path: the canonical inference
use of SDDMM.

Counterpart of ``sddmm_tpu/models/graph_attention.py``
(``segment_softmax``, ``GraphAttentionParams``, ``GraphAttentionLayer``).
A graph-transformer attention layer over a sparse adjacency: the scores
``e_ij = (x_i W_q) . (x_j W_k) / sqrt(d)`` are an SDDMM at the edges (the
port's ``HybridSDDMM``: tile kernel and gather-dot on the card), then a
softmax over each node's neighbours and an SpMM aggregation of the value
projections: the port's attention core (``models.hybrid_attention.
AttentionCore.mix``) with one head, as the attention models run it.

The JAX layer runs softmax and aggregation in the packed layout, with the
padding slots routed into a dropped sentinel segment (row ``m``) and a
zero V row (column ``n``).  Here they run in CSR order: the segment
softmax kernel reads the packed scores through ``inv_idx``, so only real
edges remain, and the aggregation walks the adjacency's ``row_ptr``.  On
the real slots this is the same arithmetic; only the order of the sums
differs.  A node with no edges outputs exact zeros.

The forward is differentiable: the projections through torch autograd
(cuBLAS), the SDDMM, the softmax and the SpMM through their autograd ops,
each backward on the hand kernels (the core's ``HeadAggregation`` keeps
the pattern's backward state, built at the first backward).  Serving runs
under ``torch.inference_mode()`` and pays nothing for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.models.hybrid_attention import AttentionCore
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, packing_row_order
from sddmm_tpu_torch.ops.softmax import segment_softmax
from sddmm_tpu_torch.ops.tile_dot import full_fp32_matmul

__all__ = ["GraphAttentionLayer", "GraphAttentionParams",
           "packing_row_order", "segment_softmax"]


class GraphAttentionParams(NamedTuple):
    w_q: torch.Tensor  # (F, D)
    w_k: torch.Tensor  # (F, D)
    w_v: torch.Tensor  # (F, D)


class GraphAttentionLayer(nn.Module):
    """Single-head sparse dot-product attention over a fixed graph, on one
    device (the card unless the caller asks for ``"cpu"``; the packing's
    index arrays live there, so the module is not moved with ``.to``)."""

    def __init__(self, adj: CSR, feature_dim: int, head_dim: int,
                 alpha: float = 0.3, delta: float = 0.3,
                 compute_dtype: str = "float32", device="cuda"):
        super().__init__()
        self.adj = adj
        self.feature_dim = feature_dim
        self.head_dim = head_dim
        self.runner = HybridSDDMM.from_csr(adj, alpha, delta,
                                           compute_dtype=compute_dtype,
                                           device=device)
        self.device = self.runner.device
        self.core = AttentionCore(adj, self.runner,
                                  packing_row_order(self.runner.packed))
        shape = (feature_dim, head_dim)
        self.w_q = nn.Parameter(torch.zeros(shape, device=self.device))
        self.w_k = nn.Parameter(torch.zeros(shape, device=self.device))
        self.w_v = nn.Parameter(torch.zeros(shape, device=self.device))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> GraphAttentionParams:
        """Fill the weights with N(0, 1/F) draws from the CPU ``generator``
        (not the JAX package's numbers: carry those across with
        ``interop.graph_attention_params_from_reference``)."""
        scale = 1.0 / np.sqrt(self.feature_dim)
        for w in (self.w_q, self.w_k, self.w_v):
            w.copy_(torch.randn(w.shape, generator=generator) * scale)
        return self.params()

    def params(self) -> GraphAttentionParams:
        return GraphAttentionParams(self.w_q.detach(), self.w_k.detach(),
                                    self.w_v.detach())

    @torch.no_grad()
    def load_params(self, params: GraphAttentionParams) -> None:
        for w, p in zip((self.w_q, self.w_k, self.w_v), params):
            w.copy_(torch.as_tensor(p, dtype=torch.float32))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (num_nodes, F) on the layer's device -> (num_nodes, D).
        ``plain=True`` runs every kernel's plain PyTorch version (the
        reference the kernels are held to on the card; its backward runs
        the plain versions too)."""
        with full_fp32_matmul():
            q = x @ self.w_q                    # (N, D)
            k = x @ self.w_k
            v = x @ self.w_v
        zero = q.new_zeros((1, q.shape[1]))
        q_pad = torch.cat([q, zero])[None]
        k_pad = torch.cat([k, zero])[None]
        # JAX divides by sqrt(D); the core multiplies by 1/sqrt(D), at most
        # one ulp of a score apart
        return self.core.mix(q_pad, k_pad, v[None], plain=plain)[0]
