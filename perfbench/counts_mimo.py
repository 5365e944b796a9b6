"""The operations and bytes of a MiMo-V2-Flash training step, counted from
the configuration's shapes and masks alone (``perfbench/counts.py``'s
rules: each input read once, each output written once, fp32 values, int32
indices; useful multiply-adds, two operations each).

Grouped-query heads: H query heads over Hkv key/value heads, so the keys
and values are read (and their gradients written) once a key/value head,
not once a query head.  The masks: the full layers' causal triangle,
L(L+1)/2 entries a head, and the window layers' band of W keys a row.
"""

from __future__ import annotations

from perfbench.counts import (F32, Op, matmul_op, pattern_bytes,
                              residual_op)

#: the attention core's kernels in a device trace, by a part of their name:
#: the scores (tile kernel, residual gather-dot, and the gather-dot for the
#: aggregation's backward), the softmax and its backward, the aggregation
#: (SpMM) and its backward, the scores' backward (tile-grad and its
#: reduction)
CORE_KERNELS = ("tile_table_kernel", "gather_dot", "segment_softmax",
                "csr_spmm_kernel", "tile_grad")
#: the RoPE kernel's name in a device trace
ROPE_KERNEL = "rope_kernel"


def mask_nnz(L: int, window) -> int:
    """Entries a head of the causal mask (window None) or of its band of
    ``window`` keys a row."""
    if window is None:
        return L * (L + 1) // 2
    w = min(window, L)
    return w * L - w * (w - 1) // 2


def gqa_sddmm(L: int, k: int, nnz: int, H: int, Hkv: int, name: str) -> Op:
    """out[h, e] = A[h][row e] . B[h // G][col e]: A of H heads, B of Hkv."""
    return Op(name, 2.0 * H * nnz * k,
              (H * L * k + Hkv * L * k + H * nnz) * F32
              + pattern_bytes(L, nnz))


def gqa_spmm(L: int, k: int, nnz: int, H: int, Hkv: int, name: str,
             out_heads: int = None) -> Op:
    """out = S(values) . V for H value sets over ``Hkv`` dense operands,
    written to ``out_heads`` outputs (H, or Hkv for a group's sum)."""
    out_heads = H if out_heads is None else out_heads
    return Op(name, 2.0 * H * nnz * k,
              (H * nnz + Hkv * L * k + out_heads * L * k) * F32
              + pattern_bytes(L, nnz))


def core_forward(L, H, Hkv, D, Dv, nnz, sink: bool) -> list:
    """The attention core of one layer and sequence: scores, softmax (with
    the sink's probabilities written), aggregation."""
    return [gqa_sddmm(L, D, nnz, H, Hkv, "scores"),
            Op("softmax", 0.0, 2 * H * nnz * F32 + pattern_bytes(L, nnz)
               + (H * L * F32 if sink else 0)),
            gqa_spmm(L, Dv, nnz, H, Hkv, "aggregate")]


def core_backward(L, H, Hkv, D, Dv, nnz, sink: bool) -> list:
    """The core's backward: d values of the aggregation (scores of the
    cotangent against V), V's gradient (the transpose, a group summed),
    the softmax's backward (and the sinks' row shares), dQ and dK (a
    group summed)."""
    return [gqa_sddmm(L, Dv, nnz, H, Hkv, "aggregate_bwd_p"),
            gqa_spmm(L, Dv, nnz, H, H, "aggregate_bwd_v", out_heads=Hkv),
            Op("softmax_bwd", 0.0, 3 * H * nnz * F32 + pattern_bytes(L, nnz)
               + (2 * H * L * F32 if sink else 0)),
            gqa_spmm(L, D, nnz, H, Hkv, "scores_bwd_q"),
            gqa_spmm(L, D, nnz, H, H, "scores_bwd_k", out_heads=Hkv)]


def rope_ops(L, H, Hkv, R) -> list:
    """RoPE of one layer and sequence, forward and backward: the rotated
    dims read and written once, with the table.  The other dims are the
    identity, so the function needs none of their bytes (the kernel's
    backward, into new tensors, also copies them: its own cost)."""
    table = L * R // 2 * 2 * F32
    rotated = 2 * (H + Hkv) * L * R * F32 + table
    return [Op("rope", 0.0, rotated), Op("rope_bwd", 0.0, rotated)]


def projections(L, F, H, Hkv, D, Dv, input_grad: bool) -> tuple:
    """(forward, backward) ops of a layer's projections: Q, K, V from x
    and the output projection; the backward's two products each, the
    input products only where x needs a gradient."""
    fwd = [matmul_op(L, F, H * D, "q_proj"),
           matmul_op(L, F, Hkv * D, "k_proj"),
           matmul_op(L, F, Hkv * Dv, "v_proj"),
           matmul_op(L, H * Dv, F, "out_proj")]
    bwd = [matmul_op(L, H * Dv, F, "out_proj_bwd", count=2),
           matmul_op(L, F, H * D, "q_proj_bwd", count=1 + input_grad),
           matmul_op(L, F, Hkv * D, "k_proj_bwd", count=1 + input_grad),
           matmul_op(L, F, Hkv * Dv, "v_proj_bwd", count=1 + input_grad)]
    return fwd, bwd


def _times(op: Op, n: int) -> Op:
    return Op(op.name, op.flops * n, op.bytes * n)


def layer_kinds(d: dict) -> list:
    """(kind dict) of every layer, in order."""
    return [d["kinds"][t] for t in d["layer_types"]]


def train_ops(d: dict, L: int, batch: int, params: int) -> list:
    """One training step of the stack ``d`` (``systems/mimo_stack.dims``)
    over ``batch`` sequences of ``L``: every layer's forward and residual,
    the loss, every layer's backward, one Adam update of ``params``."""
    F, H, D, Dv = d["hidden"], d["heads"], d["head_dim"], d["v_head_dim"]
    R = d["rotary_dim"]
    per_seq = []
    backward = []
    for i, k in enumerate(layer_kinds(d)):
        nnz, Hkv = mask_nnz(L, k["window"]), k["kv_heads"]
        fwd, bwd = projections(L, F, H, Hkv, D, Dv, input_grad=i > 0)
        rope = rope_ops(L, H, Hkv, R)
        per_seq += fwd[:3] + rope[:1] \
            + core_forward(L, H, Hkv, D, Dv, nnz, k["sink"]) \
            + fwd[3:] + [residual_op(L, F)]
        backward = ([bwd[0]] + core_backward(L, H, Hkv, D, Dv, nnz,
                                             k["sink"])
                    + rope[1:] + bwd[1:]
                    + ([residual_op(L, F, "residual_bwd")] if i else [])
                    + backward)
    per_seq += [Op("loss", 0.0, 3 * L * F * F32)] + backward
    return [_times(op, batch) for op in per_seq] \
        + [Op("adam", 0.0, 7 * params * F32)]


def core_ops(d: dict, L: int, batch: int) -> list:
    """The attention core's ops (scores, softmax, aggregation and their
    backward) of one training step, both kinds of layer."""
    F, H, D, Dv = d["hidden"], d["heads"], d["head_dim"], d["v_head_dim"]
    out = []
    for k in layer_kinds(d):
        nnz, Hkv = mask_nnz(L, k["window"]), k["kv_heads"]
        out += core_forward(L, H, Hkv, D, Dv, nnz, k["sink"]) \
            + core_backward(L, H, Hkv, D, Dv, nnz, k["sink"])
    return [_times(op, batch) for op in out]


def rope_step_ops(d: dict, L: int, batch: int) -> list:
    """RoPE's ops, forward and backward, of one training step."""
    H, R = d["heads"], d["rotary_dim"]
    return [_times(op, batch) for k in layer_kinds(d)
            for op in rope_ops(L, H, k["kv_heads"], R)]


def kernel_share(records, names, least_s: float):
    """% of the device time a call of the kernels whose names hold one of
    ``names`` (the device-only sub-window's intervals) that ``least_s``
    would take; None where the records hold none of them."""
    if not records.kernels or not records.calls:
        return None
    busy = sum(e - s for n, s, e in records.kernels
               if any(k in n for k in names))
    if busy <= 0:
        return None
    return 100.0 * least_s / (busy / records.calls)
