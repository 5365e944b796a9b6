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
zero V row (column ``n``).  Here they run in CSR order: the segment
softmax kernel (``ops.softmax.segment_softmax_torch``) reads the packed
scores through ``inv_idx``, so only real edges remain, and the aggregation
walks the adjacency's ``row_ptr``.  On the real slots this is the same
arithmetic; only the order of the sums differs.  A node with no edges
outputs exact zeros.

The forward is differentiable: the projections through torch autograd
(cuBLAS), the SDDMM, the softmax and the SpMM through their autograd ops,
each backward on the hand kernels (``CSRAggregation`` keeps the pattern's
backward state, built at the first backward).  Serving runs under
``torch.inference_mode()`` and pays nothing for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, packing_row_order
from sddmm_tpu_torch.ops.softmax import (segment_softmax,
                                         segment_softmax_torch, softmax_plan)
from sddmm_tpu_torch.ops.spmm import (GradPattern, csr_spmm_plain,
                                      csr_spmm_torch, spmm_plan)
from sddmm_tpu_torch.ops.tile_dot import full_fp32_matmul
from sddmm_tpu_torch.utils import profiling

__all__ = ["CSRAggregation", "GraphAttentionLayer", "GraphAttentionParams",
           "packing_row_order", "segment_softmax", "stacked"]


class GraphAttentionParams(NamedTuple):
    w_q: torch.Tensor  # (F, D)
    w_k: torch.Tensor  # (F, D)
    w_v: torch.Tensor  # (F, D)


def stacked(csr: CSR, heads: int) -> CSR:
    """H copies of the (m, n) pattern on the diagonal of an (H*m, H*n) CSR:
    head h's entries are rows ``h*m + ...`` and columns ``h*n + ...``, in
    head order."""
    m, n, nnz = csr.m, csr.n, csr.nnz
    offs = np.arange(heads, dtype=np.int64)
    row_ptr = np.concatenate([(offs[:, None] * nnz
                               + csr.row_ptr[None, :-1]).ravel(),
                              [heads * nnz]])
    cols = (offs[:, None] * n + csr.col_idx[None, :]).ravel()
    return CSR((heads * m, heads * n), row_ptr, cols,
               np.ones(heads * nnz, dtype=np.float32))


class CSRAggregation:
    """A pattern's CSR index on one device, for H heads' row softmax and
    SpMM in CSR entry order.  The softmax kernel reads the pattern's row
    pointers (``head_row_ptr``) and its plan of rows by length
    (``softmax_plan``) for all heads at once;
    the SpMM runs over the block-diagonal CSR of H copies of the pattern
    (``stacked``: row ids, row pointers, column ids) with its kernel's plan
    (``spmm_plan``, built once here, its row groups taken in ``row_order``
    when H = 1).  The plan carries the pattern's backward state
    (``plan.grads``, the ``spmm.GradPattern`` of one head's pattern: the
    gather-dot's plan for the attention's cotangent and the transpose's
    SpMM for V's, all heads in one launch each), built at the first
    backward."""

    def __init__(self, csr: CSR, device, row_order=None, heads: int = 1):
        self.heads = heads
        self.head_row_ptr = torch.as_tensor(csr.row_ptr, dtype=torch.int64,
                                            device=device)
        self.softmax_plan = softmax_plan(csr.row_ptr, device)
        agg = stacked(csr, heads) if heads > 1 else csr
        self.num_rows = agg.m
        self.rows = torch.as_tensor(agg.row_indices(), dtype=torch.int64,
                                    device=device)
        self.row_ptr = torch.as_tensor(agg.row_ptr, dtype=torch.int64,
                                       device=device)
        self.cols = torch.as_tensor(agg.col_idx, dtype=torch.int32,
                                    device=device)
        self.plan = spmm_plan(agg.row_ptr, agg.col_idx,
                              row_order if heads == 1 else None).to(device)
        self.plan.grads = GradPattern(csr.row_indices(), csr.col_idx,
                                      csr.shape, device, row_order)

    def softmax_spmm(self, flat: torch.Tensor, v: torch.Tensor,
                     scale: float, inv_idx: torch.Tensor) -> torch.Tensor:
        """The kernel path: the segment softmax of ``scale`` times the
        runner's packed scores ``flat`` (H, F), read through ``inv_idx``
        (nnz,) int32, then ``attn @ v`` (v (H*m, D)): one softmax launch,
        one SpMM launch (a backward: one launch of the softmax's backward,
        one gather-dot, one SpMM)."""
        with profiling.span("attention.softmax"):
            attn = segment_softmax_torch(flat, self.head_row_ptr, scale,
                                         inv_idx, self.softmax_plan)
        with profiling.span("attention.spmm"):
            return csr_spmm_torch(attn.reshape(-1), self.rows, self.cols, v,
                                  self.num_rows, row_ptr=self.row_ptr,
                                  plan=self.plan)

    def softmax_spmm_plain(self, scores: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
        """The plain path: ``segment_softmax`` (torch ops) of the scaled
        CSR-order scores (H*nnz,), then the SpMM's plain version."""
        attn = segment_softmax(scores, self.rows, self.num_rows)
        return csr_spmm_plain(attn, self.rows, self.cols, v, self.num_rows)


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
        reference the kernels are held to on the card; its backward runs
        the plain versions too)."""
        with full_fp32_matmul():
            q = x @ self.w_q                    # (N, D)
            k = x @ self.w_k
            v = x @ self.w_v
        zero = q.new_zeros((1, q.shape[1]))
        q_pad = torch.cat([q, zero])
        k_pad = torch.cat([k, zero])
        # JAX divides by sqrt(D); both paths here multiply by 1/sqrt(D), at
        # most one ulp of a score apart
        scale = 1.0 / np.sqrt(self.head_dim)
        # a 2-D k_pad is the identity layout's B^T, as in the JAX layer
        if plain:
            scores = self.runner.run_padded(q_pad, k_pad, order="csr",
                                            plain=True)
            return self._agg.softmax_spmm_plain(scores * scale, v)
        flat = self.runner.run_padded(q_pad, k_pad, order="packed")
        return self._agg.softmax_spmm(flat[None], v, scale,
                                      self.runner.inv_idx32)
