"""Dot-product graph attention, the serving path: the canonical inference
use of SDDMM.

Counterpart of ``sddmm_tpu/models/graph_attention.py``
(``segment_softmax``, ``GraphAttentionParams``, ``GraphAttentionLayer``).
A graph-transformer attention layer over a sparse adjacency: the scores
``e_ij = (x_i W_q) . (x_j W_k) / sqrt(d)`` are an SDDMM at the edges (the
port's ``HybridSDDMM``: tile kernel and gather-dot on the card), then a
softmax over each node's neighbours and an SpMM aggregation of the value
projections (``ops.spmm.csr_spmm_torch``: the SpMM kernel on the card).

The JAX layer runs softmax and aggregation in the packed layout, with the
padding slots routed into a dropped sentinel segment (row ``m``) and a
zero V row (column ``n``).  Here they run in CSR order: the scores are
gathered through ``inv_idx`` (``run_padded(order="csr")``), so only real
edges remain, and the aggregation walks the adjacency's ``row_ptr``.  On
the real slots this is the same arithmetic; only the order of the sums
differs.  A node with no edges outputs exact zeros.

The forward has no backward pass yet: under grad mode with a parameter or
input that requires grad it raises ``NotImplementedError`` (see
``ops.hybrid.check_no_grad``).  Serve under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_no_grad
from sddmm_tpu_torch.ops.spmm import csr_spmm_plain, csr_spmm_torch, spmm_plan
from sddmm_tpu_torch.ops.tile_dot import full_fp32_matmul


class GraphAttentionParams(NamedTuple):
    w_q: torch.Tensor  # (F, D)
    w_k: torch.Tensor  # (F, D)
    w_v: torch.Tensor  # (F, D)


def segment_softmax(scores: torch.Tensor, rows: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """Numerically stable softmax over per-row segments of edge scores:
    scores and rows (nnz,), row ids in ``[0, num_rows)`` in any order."""
    rows = rows.long()
    row_max = torch.full((num_rows,), -torch.inf, dtype=scores.dtype,
                         device=scores.device)
    row_max = row_max.scatter_reduce(0, rows, scores, "amax")
    exp = torch.exp(scores - row_max[rows])
    denom = torch.zeros((num_rows,), dtype=scores.dtype,
                        device=scores.device).index_add_(0, rows, exp)
    return exp / denom.clamp_min(1e-30)[rows]


def packing_row_order(packed) -> np.ndarray:
    """The rows in a packing's clustered order (its A-row slots, first
    occurrence), then any row it leaves out: rows that share columns come
    together, which is what the SpMM plan's row groups want."""
    slots = np.asarray(packed.a_row_gather, dtype=np.int64)
    slots = slots[slots < packed.m]
    _, first = np.unique(slots, return_index=True)
    slots = slots[np.sort(first)]
    return np.concatenate([slots, np.setdiff1d(np.arange(packed.m), slots)])


class CSRAggregation:
    """The CSR index of a pattern on one device, for a softmax and an SpMM
    in CSR entry order: row ids, row pointers, column ids and the SpMM
    kernel's plan (``spmm_plan``, built once here, its row groups taken in
    ``row_order``)."""

    def __init__(self, csr: CSR, device, row_order=None):
        self.num_rows = csr.m
        self.rows = torch.as_tensor(csr.row_indices(), dtype=torch.int64,
                                    device=device)
        self.row_ptr = torch.as_tensor(csr.row_ptr, dtype=torch.int64,
                                       device=device)
        self.cols = torch.as_tensor(csr.col_idx, dtype=torch.int32,
                                    device=device)
        self.plan = spmm_plan(csr.row_ptr, csr.col_idx,
                              row_order).to(device)

    def softmax_spmm(self, scores: torch.Tensor, v: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
        """Row softmax of the CSR-order ``scores``, then ``attn @ v``
        (``plain``: the SpMM's plain version on any device)."""
        attn = segment_softmax(scores, self.rows, self.num_rows)
        if plain:
            return csr_spmm_plain(attn, self.rows, self.cols, v,
                                  self.num_rows)
        return csr_spmm_torch(attn, self.rows, self.cols, v, self.num_rows,
                              row_ptr=self.row_ptr, plan=self.plan)


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
        self._agg = CSRAggregation(adj, self.device,
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
        reference the kernels are held to on the card)."""
        check_no_grad("GraphAttentionLayer.forward", x, self.w_q, self.w_k,
                      self.w_v)
        with full_fp32_matmul():
            q = x @ self.w_q                    # (N, D)
            k = x @ self.w_k
            v = x @ self.w_v
        zero = q.new_zeros((1, q.shape[1]))
        q_pad = torch.cat([q, zero])
        k_pad = torch.cat([k, zero])
        # a 2-D k_pad is the identity layout's B^T, as in the JAX layer
        scores = self.runner.run_padded(q_pad, k_pad, order="csr",
                                        plain=plain)
        scores = scores / np.sqrt(self.head_dim)
        return self._agg.softmax_spmm(scores, v, plain=plain)
