"""Block-sparse transformer attention over structured masks, the serving
path.

Counterpart of ``sddmm_tpu/models/block_sparse_attention.py``
(``make_attention_mask``, ``BlockSparseAttentionParams``,
``BlockSparseAttention``, ``dense_reference_attention``): multi-head
dot-product attention where only a structured subset of the (L, L) score
matrix exists, a sliding window plus optional global tokens (the
Longformer/BigBird pattern class).  The mask is packed once (BSMR + hybrid
packing) and every head reuses the packing: the window packs into banded
tiles, the global columns and rows into dense tiles or the residual.

Forward pass: the heads' packed scores ``SDDMM(Q_h, K_h)`` through
``BatchedHybridSDDMM`` (one tile-kernel launch and one gather-dot launch
for all heads); one segment softmax launch over all heads' rows, which
reads the packed scores through ``inv_idx`` and scales them by 1/sqrt(D)
in its loads; one SpMM launch that aggregates every head's V (a
block-diagonal CSR of H copies of the mask); then the output
projection.  The projections run in "float32" on the projection GEMM
(``ops.project``: Q, K and V in one launch from x, written straight into
the padded layouts the SDDMM and the aggregation read; the output
projection reading the heads in place).  The JAX model does softmax and aggregation in
the packed layout with sentinel segments; on the real slots this is the
same arithmetic, summed in another order.

The forward is differentiable (the counterpart of ``jax.grad`` of the
JAX model's loss): the projections through their autograd ops, whose
backward is launches of the projection GEMM; the SDDMM, the softmax and the aggregation through their
autograd ops, whose backward is one softmax-backward launch, one
gather-dot launch (the attention's cotangent), one SpMM launch (V's) and
the SDDMM's dQ and dK (``HybridSDDMM.vjp``: the tile-grad kernel and its
reduction, and two SpMM launches for the residual), each for all heads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch.data.sparse import COO, CSR
from sddmm_tpu_torch.models.graph_attention import CSRAggregation
from sddmm_tpu_torch.ops.batch import BatchedHybridSDDMM
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
from sddmm_tpu_torch.ops.project import out_project, qkv_project
from sddmm_tpu_torch.utils import profiling


def make_attention_mask(seq_len: int, window: int = 64,
                        num_global: int = 0,
                        causal: bool = False) -> CSR:
    """Sliding-window (+ global-token) attention mask as a CSR pattern.

    Row i attends to columns within ``window`` of i (one-sided when
    ``causal``), to the first ``num_global`` columns, and the first
    ``num_global`` rows attend to every column.
    """
    rows_l = []
    cols_l = []
    i = np.arange(seq_len, dtype=np.int64)
    lo = np.maximum(i - window, 0)
    hi = i + 1 if causal else np.minimum(i + window + 1, seq_len)
    counts = np.maximum(hi - lo, 0)
    rows_w = np.repeat(i, counts)
    cols_w = (np.arange(int(counts.sum()), dtype=np.int64)
              - np.repeat(np.cumsum(counts) - counts, counts)
              + np.repeat(lo, counts))
    rows_l.append(rows_w)
    cols_l.append(cols_w)
    if num_global:
        g = np.arange(num_global, dtype=np.int64)
        # every row -> global columns (clipped to the past when causal)
        rg = np.repeat(i, num_global)
        cg = np.tile(g, seq_len)
        if causal:
            keep = cg <= rg
            rg, cg = rg[keep], cg[keep]
        rows_l.append(rg)
        cols_l.append(cg)
        # global rows -> every (non-future) column
        for gi in range(num_global):
            reach = gi + 1 if causal else seq_len
            rows_l.append(np.full(reach, gi, dtype=np.int64))
            cols_l.append(np.arange(reach, dtype=np.int64))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keys = np.unique(rows * seq_len + cols)
    rows = keys // seq_len
    cols = keys % seq_len
    return COO((seq_len, seq_len), rows, cols,
               np.ones(len(rows), dtype=np.float32)).to_csr()


class BlockSparseAttentionParams(NamedTuple):
    w_q: torch.Tensor   # (H, F, D)
    w_k: torch.Tensor   # (H, F, D)
    w_v: torch.Tensor   # (H, F, D)
    w_o: torch.Tensor   # (H * D, F)


class BlockSparseAttention(nn.Module):
    """Multi-head block-sparse self-attention over a fixed mask, on one
    device (the card unless the caller asks for ``"cpu"``; the packing's
    index arrays live there).

    The mask is packed once; every head reuses the packed layout."""

    def __init__(self, mask: CSR, feature_dim: int, num_heads: int,
                 head_dim: int, alpha: float = 0.3, delta: float = 0.3,
                 compute_dtype: str = "float32", a_layout: str = "rows",
                 device="cuda"):
        super().__init__()
        self.mask = mask
        self.feature_dim = feature_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.runner = HybridSDDMM.from_csr(mask, alpha, delta,
                                           compute_dtype=compute_dtype,
                                           device=device)
        if a_layout != "rows":
            self.runner = HybridSDDMM(self.runner.packed,
                                      compute_dtype=compute_dtype,
                                      a_layout=a_layout, device=device)
        self.device = self.runner.device
        self.batched = BatchedHybridSDDMM(self.runner)
        self._len = mask.m
        self._agg = CSRAggregation(mask, self.device, heads=num_heads)
        shape = (num_heads, feature_dim, head_dim)
        self.w_q = nn.Parameter(torch.zeros(shape, device=self.device))
        self.w_k = nn.Parameter(torch.zeros(shape, device=self.device))
        self.w_v = nn.Parameter(torch.zeros(shape, device=self.device))
        self.w_o = nn.Parameter(torch.zeros(
            (num_heads * head_dim, feature_dim), device=self.device))

    def _weights(self):
        return (self.w_q, self.w_k, self.w_v, self.w_o)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> BlockSparseAttentionParams:
        """Fill the weights with normal draws from the CPU ``generator``,
        scaled as the JAX package's ``init`` (not its numbers: carry those
        across with ``interop.block_sparse_params_from_reference``)."""
        s_in = 1.0 / np.sqrt(self.feature_dim)
        s_out = 1.0 / np.sqrt(self.num_heads * self.head_dim)
        for w, s in zip(self._weights(), (s_in, s_in, s_in, s_out)):
            w.copy_(torch.randn(w.shape, generator=generator) * s)
        return self.params()

    def params(self) -> BlockSparseAttentionParams:
        return BlockSparseAttentionParams(*(w.detach()
                                            for w in self._weights()))

    @torch.no_grad()
    def load_params(self, params: BlockSparseAttentionParams) -> None:
        for w, p in zip(self._weights(), params):
            w.copy_(torch.as_tensor(p, dtype=torch.float32))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (L, F) on the module's device -> (L, F).  ``plain=True`` runs
        every kernel's plain PyTorch version (and its backward the plain
        versions' too)."""
        with profiling.span("attention.forward"):
            H, L, D = self.num_heads, self._len, self.head_dim
            with profiling.span("attention.project"):
                # q_pad, k_pad (H, L+1, D) with a zero sentinel row; v (H*L, D)
                q_pad, k_pad, v = qkv_project(x, self.w_q, self.w_k,
                                              self.w_v, plain=plain)
            scale = 1.0 / np.sqrt(D)
            if plain:
                scores = self.batched.run_padded(q_pad, k_pad, order="csr",
                                                 plain=True)   # (H, nnz)
                heads = self._agg.softmax_spmm_plain(
                    (scores * scale).reshape(-1), v)
            else:
                flat = self.batched.run_padded(q_pad, k_pad)   # (H, F)
                heads = self._agg.softmax_spmm(flat, v, scale,
                                               self.runner.inv_idx32)
            with profiling.span("attention.out"):
                return out_project(heads.view(H, L, D), self.w_o,
                                   plain=plain)    # (L, F)


def dense_reference_attention(params: BlockSparseAttentionParams, x,
                              mask: CSR) -> torch.Tensor:
    """O(L^2) golden model in fp64 on x's device (torch tensor or numpy):
    full QK^T with -inf outside the mask, one head at a time."""
    x = torch.as_tensor(x).to(torch.float64)
    dev = x.device
    L = mask.m
    dense_mask = torch.zeros((L, L), dtype=torch.bool, device=dev)
    dense_mask[torch.as_tensor(mask.row_indices(), device=dev),
               torch.as_tensor(mask.col_idx, device=dev)] = True
    w_q, w_k, w_v, w_o = (torch.as_tensor(w).to(device=dev,
                                                dtype=torch.float64)
                          for w in params)
    heads = []
    for h in range(w_q.shape[0]):
        q, k, v = x @ w_q[h], x @ w_k[h], x @ w_v[h]
        s = (q @ k.T) / np.sqrt(q.shape[1])
        s = s.masked_fill(~dense_mask, -torch.inf)
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        p = e / e.sum(dim=1, keepdim=True).clamp_min(1e-30)
        heads.append(p @ v)
        del s, e, p
    return torch.cat(heads, dim=1) @ w_o
