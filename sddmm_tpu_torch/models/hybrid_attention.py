"""Hybrid sliding-window and full attention with grouped-query heads: the
attention stack of MiMo-V2-Flash (and of models that mix the two kinds of
layer), on the port's kernels.

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
distinct kind's mask once (BSMR and the hybrid packing, as
``BlockSparseAttention``: the causal lower triangle for ``full``, the
causal band for ``window``), shares that packing, its plans and its RoPE
table among the kind's layers, and runs ``x + layer(x)`` layer by layer.

The path, per layer: ``qkv_project`` (one projection-GEMM launch: Q, K and
V of their own head counts and widths, V times s_v in the epilogue), RoPE
on q_pad and k_pad in place (``ops.rope``, one launch), the scores of every
query head against key head h >> log2(G) read in place
(``BatchedHybridSDDMM``: one tile-kernel launch, one gather-dot launch for
the residual), the row softmax with the sink (``segment_softmax_sink``, one
launch), the aggregation against V of the group (``head_spmm``, one SpMM
launch), and ``out_project``.  No K or V is copied out to the query heads:
every kernel takes the group as a head shift.  The backward is the same
kernels' backward entries; K's, V's and the sinks' gradients sum a group's
query heads, or a head's rows, in a fixed order.  ``plain=True`` runs every
op's plain PyTorch version (their backward too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch.models.block_sparse_attention import make_attention_mask
from sddmm_tpu_torch.ops.batch import BatchedHybridSDDMM
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, packing_row_order
from sddmm_tpu_torch.ops.project import out_project, qkv_project
from sddmm_tpu_torch.ops.rope import apply_rope, rope_table
from sddmm_tpu_torch.ops.softmax import segment_softmax_sink, softmax_plan
from sddmm_tpu_torch.ops.spmm import HeadAggregation, head_spmm
from sddmm_tpu_torch.ops.tile_dot import head_shift
from sddmm_tpu_torch.utils import profiling


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


class _KindCore:
    """What the layers of one kind share: the mask packed once (the runner
    and its batched form), the softmax's plan, the aggregation's index and
    the RoPE table."""

    def __init__(self, kind: AttentionKind, seq_len: int, rotary: int,
                 alpha: float, delta: float, compute_dtype: str, device):
        self.kind = kind
        mask = causal_mask(seq_len, kind.window)
        self.nnz = mask.nnz
        self.runner = HybridSDDMM.from_csr(mask, alpha, delta,
                                           compute_dtype=compute_dtype,
                                           device=device)
        self.device = self.runner.device
        self.batched = BatchedHybridSDDMM(self.runner)
        self.row_ptr = torch.as_tensor(mask.row_ptr, dtype=torch.int64,
                                       device=self.device)
        self.softmax_plan = softmax_plan(mask.row_ptr, self.device)
        self.agg = HeadAggregation(mask, self.device,
                                   packing_row_order(self.runner.packed))
        self.table = rope_table(seq_len, rotary, kind.rope_theta,
                                self.device)


class HybridAttentionLayer(nn.Module):
    """One attention layer of a kind, on its kind's shared core; its own
    weights: ``w_q`` (H, F, D), ``w_k`` (Hkv, F, D), ``w_v`` (Hkv, F, Dv),
    ``w_o`` (H*Dv, F) and, where the kind has one, ``sink`` (H,)."""

    def __init__(self, core: _KindCore, feature_dim: int, num_heads: int,
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
        core = self._core
        H, D, Dv = self.num_heads, self.head_dim, self.v_head_dim
        L = x.shape[0]
        with profiling.span(f"attention.{self.kind}"):
            with profiling.span("attention.project"):
                q_pad, k_pad, v = qkv_project(x, self.w_q, self.w_k,
                                              self.w_v, plain=plain,
                                              v_scale=self.value_scale)
            with profiling.span("attention.rope"):
                q_pad, k_pad = apply_rope(q_pad, k_pad, core.table, plain)
            scale = 1.0 / np.sqrt(D)
            if plain:
                scores = core.batched.run_padded(q_pad, k_pad, order="csr",
                                                 plain=True)    # (H, nnz)
                inv_idx = None
            else:
                scores = core.batched.run_padded(q_pad, k_pad,
                                                 order="packed")  # (H, F)
                inv_idx = core.runner.inv_idx32
            with profiling.span("attention.softmax"):
                p = segment_softmax_sink(scores, self.sink, core.row_ptr,
                                         scale, inv_idx, core.softmax_plan,
                                         plain)
            with profiling.span("attention.spmm"):
                heads = head_spmm(p, v.view(-1, L, Dv), core.agg, plain)
            with profiling.span("attention.out"):
                return out_project(heads.view(H, L, Dv), self.w_o,
                                   plain=plain)


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
        self.cores = {name: _KindCore(by_name[name], seq_len, rotary_dim,
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
