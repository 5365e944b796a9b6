"""The port's attention core, which its three attention layers share, and
the hybrid sliding-window and full attention stack with grouped-query
heads of MiMo-V2-Flash (and of models that mix the two kinds of layer).

``AttentionCore`` is a mask packed once (BSMR and the hybrid packing) and
what every layer over it shares: the runner and its batched form, the
softmax's plan, the aggregation's index (``HeadAggregation``) and, where
the layers rotate q and k, the RoPE table.  ``attend`` runs a layer's
chain on a core: ``qkv_project`` (one projection-GEMM launch: Q, K and V
of their own head counts and widths, V times s_v in the epilogue), RoPE on
q_pad and k_pad in place (``ops.rope``, one launch), the scores of every
query head against key head h >> log2(G) read in place
(``BatchedHybridSDDMM``: one tile-kernel launch, one gather-dot launch for
the residual), the row softmax with the sink or without one
(``segment_softmax_sink``, one launch), the aggregation against V of the
group (``head_spmm``, one SpMM launch with a head stride over the one
copy of the mask), and ``out_project``.  No K or V is copied out to the
query heads: every kernel takes the group as a head shift.  The backward
is the same kernels' backward entries; K's, V's and the sinks' gradients
sum a group's query heads, or a head's rows, in a fixed order.
``plain=True`` runs every op's plain PyTorch version (their backward
too).  ``BlockSparseAttention`` runs ``attend`` with G = 1, no RoPE, no
sink and s_v = 1; ``GraphAttentionLayer`` runs the core's scores, softmax
and aggregation (``AttentionCore.mix``) on its own projections.

A layer of kind ``full`` or ``window`` (``AttentionKind``), on x (L, F), with
H query heads over Hkv key/value heads (G = H / Hkv, a power of two), q/k
heads of D, v heads of Dv, RoPE on the first R dims at base theta, and, in
a kind that has one, a learned sink logit per head:

    q_h = x W_q[h]          k_g = x W_k[g]          v_g = s_v * x W_v[g]
    q_h, k_g <- RoPE_theta on dims [0, R) at position i ("rotate half")
    s_hij = q_hi . k_{h//G, j} / sqrt(D),   j in M(i): full j <= i;
                                            window i - W < j <= i
    p_hij = exp(s_hij - m_hi)
            / (sum_j exp(s_hij - m_hi) + [sink] exp(b_h - m_hi))
    o_hi  = sum_j p_hij v_{h//G, j}        layer(x) = concat_h(o_h) W_o

The stack (``HybridAttentionStack``) takes the layer-type list, packs each
distinct kind's mask once into a core (the causal lower triangle for
``full``, the causal band for ``window``) and runs ``x + layer(x)`` layer
by layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch.data.sparse import COO, CSR
from sddmm_tpu_torch.ops.batch import BatchedHybridSDDMM
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, packing_row_order
from sddmm_tpu_torch.ops.project import out_project, qkv_project
from sddmm_tpu_torch.ops.rope import apply_rope, rope_table
from sddmm_tpu_torch.ops.softmax import segment_softmax_sink, softmax_plan
from sddmm_tpu_torch.ops.spmm import HeadAggregation, head_spmm
from sddmm_tpu_torch.ops.tile_dot import head_shift
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


@dataclasses.dataclass(frozen=True)
class AttentionKind:
    """A kind of layer: its name (``full``, ``window``), key/value heads,
    RoPE base, whether it has a sink, and its window W (the keys i - W < j
    <= i; None: every j <= i)."""
    name: str
    kv_heads: int
    rope_theta: float
    sink: bool
    window: Optional[int] = None


def causal_mask(seq_len: int, window: Optional[int] = None):
    """The causal mask as a CSR pattern: row i holds j <= i, and with a
    ``window`` W only i - W < j."""
    return make_attention_mask(seq_len, window=seq_len if window is None
                               else window - 1, causal=True)


class AttentionCore:
    """A mask packed once, and what every layer that attends over it
    shares: ``runner`` (the ``HybridSDDMM`` of the mask) and ``batched``,
    the softmax's ``row_ptr`` and ``softmax_plan``, the aggregation ``agg``
    (``HeadAggregation``: the mask's CSR on the device once for all heads,
    its SpMM plan's rows grouped in ``row_order``) and the RoPE ``table``
    (None: the layers rotate nothing).  ``kind``: the ``AttentionKind`` of
    a stack's layers over it, or None."""

    def __init__(self, mask: CSR, runner: HybridSDDMM, row_order=None,
                 table: Optional[torch.Tensor] = None,
                 kind: Optional[AttentionKind] = None):
        self.kind = kind
        self.nnz = mask.nnz
        self.runner = runner
        self.device = runner.device
        self.batched = BatchedHybridSDDMM(runner)
        self.agg = HeadAggregation(mask, self.device, row_order)
        self.row_ptr = self.agg.row_ptr
        self.softmax_plan = softmax_plan(mask.row_ptr, self.device)
        self.table = table

    def mix(self, q_pad: torch.Tensor, k_pad: torch.Tensor,
            v: torch.Tensor, sink: Optional[torch.Tensor] = None,
            plain: bool = False) -> torch.Tensor:
        """q_pad (H, L+1, D), k_pad (Hkv, L+1, D) with their zero
        sentinel rows, v (Hkv, L, Dv) and the sinks (H,) or None -> the
        heads (H, L, Dv): the scores scaled by 1/sqrt(D), their row softmax
        and its aggregation of V."""
        if plain:
            scores = self.batched.run_padded(q_pad, k_pad, order="csr",
                                             plain=True)       # (H, nnz)
            inv_idx = None
        else:
            scores = self.batched.run_padded(q_pad, k_pad,
                                             order="packed")   # (H, F)
            inv_idx = self.runner.inv_idx32
        with profiling.span("attention.softmax"):
            p = segment_softmax_sink(scores, sink, self.row_ptr,
                                     1.0 / np.sqrt(q_pad.shape[2]), inv_idx,
                                     self.softmax_plan, plain)
        with profiling.span("attention.spmm"):
            return head_spmm(p, v, self.agg, plain)


def attend(core: AttentionCore, x: torch.Tensor, w_q: torch.Tensor,
           w_k: torch.Tensor, w_v: torch.Tensor, w_o: torch.Tensor,
           sink: Optional[torch.Tensor] = None, value_scale: float = 1.0,
           plain: bool = False) -> torch.Tensor:
    """One attention layer's forward on ``core``: x (L, F), ``w_q`` (H, F,
    D), ``w_k`` (Hkv, F, D), ``w_v`` (Hkv, F, Dv), ``w_o`` (H*Dv, F) and the
    sinks (H,) or None -> (L, F), without the residual: the projections
    (V times ``value_scale``), RoPE where the core has a table, the core's
    ``mix`` and the output projection."""
    L, H, Dv = x.shape[0], w_q.shape[0], w_v.shape[2]
    with profiling.span("attention.project"):
        q_pad, k_pad, v = qkv_project(x, w_q, w_k, w_v, plain=plain,
                                      v_scale=value_scale)
    if core.table is not None:
        with profiling.span("attention.rope"):
            q_pad, k_pad = apply_rope(q_pad, k_pad, core.table, plain)
    heads = core.mix(q_pad, k_pad, v.view(-1, L, Dv), sink, plain)
    with profiling.span("attention.out"):
        return out_project(heads.view(H, L, Dv), w_o, plain=plain)


def _kind_core(kind: AttentionKind, seq_len: int, rotary: int, alpha: float,
               delta: float, compute_dtype: str, device) -> AttentionCore:
    """The core of a kind's causal mask at ``seq_len`` positions."""
    mask = causal_mask(seq_len, kind.window)
    runner = HybridSDDMM.from_csr(mask, alpha, delta,
                                  compute_dtype=compute_dtype, device=device)
    return AttentionCore(mask, runner, packing_row_order(runner.packed),
                         rope_table(seq_len, rotary, kind.rope_theta,
                                    runner.device), kind)


class HybridAttentionLayer(nn.Module):
    """One attention layer of a kind, on its kind's shared core; its own
    weights: ``w_q`` (H, F, D), ``w_k`` (Hkv, F, D), ``w_v`` (Hkv, F, Dv),
    ``w_o`` (H*Dv, F) and, where the kind has one, ``sink`` (H,)."""

    def __init__(self, core: AttentionCore, feature_dim: int, num_heads: int,
                 head_dim: int, v_head_dim: int, value_scale: float):
        super().__init__()
        self._core = core
        kv = core.kind.kv_heads
        head_shift(num_heads, kv)
        self.kind = core.kind.name
        self.num_heads, self.head_dim = num_heads, head_dim
        self.v_head_dim, self.value_scale = v_head_dim, value_scale
        dev = core.device

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        self.w_q = zeros(num_heads, feature_dim, head_dim)
        self.w_k = zeros(kv, feature_dim, head_dim)
        self.w_v = zeros(kv, feature_dim, v_head_dim)
        self.w_o = zeros(num_heads * v_head_dim, feature_dim)
        self.sink = zeros(num_heads) if core.kind.sink else None

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (L, F) on the layer's device -> the attention's output (L, F)
        (without the residual)."""
        with profiling.span(f"attention.{self.kind}"):
            return attend(self._core, x, self.w_q, self.w_k, self.w_v,
                          self.w_o, self.sink, self.value_scale, plain)


class HybridAttentionStack(nn.Module):
    """A stack of attention layers with residuals, ``x + layer(x)`` in the
    order of ``layer_types`` (names of ``kinds``), on one device (the card
    unless the caller asks for ``"cpu"``).  Each distinct kind's mask is
    packed once, at ``seq_len`` positions, and shared by its layers."""

    def __init__(self, seq_len: int, layer_types: Sequence[str],
                 kinds: Sequence[AttentionKind], feature_dim: int,
                 num_heads: int, head_dim: int, v_head_dim: int,
                 rotary_dim: int, value_scale: float = 1.0,
                 alpha: float = 0.3, delta: float = 0.3,
                 compute_dtype: str = "float32", device="cuda"):
        super().__init__()
        by_name = {k.name: k for k in kinds}
        missing = sorted(set(layer_types) - set(by_name))
        if missing:
            raise ValueError(f"layer types {missing} have no AttentionKind")
        self.seq_len, self.layer_types = seq_len, list(layer_types)
        self.feature_dim = feature_dim
        self.cores = {name: _kind_core(by_name[name], seq_len, rotary_dim,
                                       alpha, delta, compute_dtype, device)
                      for name in dict.fromkeys(layer_types)}
        self.layers = nn.ModuleList(
            HybridAttentionLayer(self.cores[name], feature_dim, num_heads,
                                 head_dim, v_head_dim, value_scale)
            for name in layer_types)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Normal weights scaled by 1/sqrt(fan-in), sinks N(0, 1), drawn
        from ``generator`` (on the device or the CPU) layer by layer."""
        for layer in self.layers:
            for name, w in layer.named_parameters():
                s = (1.0 if name == "sink" else 1.0 / np.sqrt(
                    w.shape[0] if name == "w_o" else w.shape[1]))
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=generator.device) * s)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x, plain=plain)
        return x
