"""The yardstick: the chip's peaks, and the operations and bytes of each
op of a call or step, counted from shapes and the pattern alone.

Bytes count each input read once and each output written once (fp32
values, int32 indices: a pattern is its ``col_idx`` and ``row_ptr``),
whatever the implementation gathers again or packs; operations are the
useful multiply-adds, two each.  Nothing here depends on how the program
packs a pattern.
"""

from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
#: bf16 products the tensor cores make for one useful product, by compute
#: mode: "tf32" is the port's 3-pass bf16 split, "float32" its 6-product
#: split (fp32-exact to rounding); a mode's peak is the bf16 peak over this
MODE_PRODUCTS = {"bfloat16": 1, "float16": 1, "mixed": 2, "tf32": 3,
                 "float32": 6}
F32 = 4
I32 = 4


def peak_flops(mode: str) -> float:
    """FLOP/s of the chip's peak for useful products in ``mode``."""
    return BF16_PEAK_FLOPS / MODE_PRODUCTS[mode]


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bytes: float

    def least_s(self, mode: str) -> float:
        """The least time the chip could take: the larger of operations
        over the mode's peak and bytes over HBM bandwidth."""
        return max(self.flops / peak_flops(mode),
                   self.bytes / HBM_BYTES_PER_S)


def pattern_bytes(m: int, nnz: int) -> int:
    return nnz * I32 + (m + 1) * I32


def sddmm_op(m: int, n: int, k: int, nnz: int, heads: int = 1,
             name: str = "sddmm") -> Op:
    """out[e] = A[row e] . B[:, col e] for ``heads`` (A, B) pairs on one
    pattern: A (m, k), B (k, n) read, nnz outputs written per head."""
    return Op(name, 2.0 * heads * nnz * k,
              heads * (m * k + k * n + nnz) * F32 + pattern_bytes(m, nnz))


def spmm_op(m: int, n: int, k: int, nnz: int, heads: int = 1,
            name: str = "spmm") -> Op:
    """out (m, k) = S (m, n, nnz values) @ V (n, k) for ``heads``."""
    return Op(name, 2.0 * heads * nnz * k,
              heads * (nnz + n * k + m * k) * F32 + pattern_bytes(m, nnz))


def matmul_op(m: int, k: int, n: int, name: str, count: int = 1) -> Op:
    """``count`` products (m, k) @ (k, n), each operand read once."""
    return Op(name, 2.0 * count * m * k * n,
              count * (m * k + k * n + m * n) * F32)


def softmax_op(m: int, nnz: int, heads: int, name: str = "softmax",
               reads: int = 1) -> Op:
    """Row softmax over the pattern's entries: ``reads`` value arrays in,
    one out, per head.  Its exponentials are not counted as operations."""
    return Op(name, 0.0, heads * (reads + 1) * nnz * F32
              + pattern_bytes(m, nnz))


def attention_forward_ops(seq: int, hidden: int, heads: int,
                          head_dim: int, nnz: int) -> list:
    """One sequence through block-sparse self-attention: the Q, K, V
    projections, the scores (SDDMM), the softmax, the aggregation (SpMM)
    and the output projection.  ``nnz`` is the mask's, one head's."""
    hd = heads * head_dim
    return [matmul_op(seq, hidden, hd, "qkv_proj", count=3),
            sddmm_op(seq, seq, head_dim, nnz, heads, "scores"),
            softmax_op(seq, nnz, heads),
            spmm_op(seq, seq, head_dim, nnz, heads, "aggregate"),
            matmul_op(seq, hd, hidden, "out_proj")]


def residual_op(seq: int, hidden: int, name: str = "residual") -> Op:
    """x + f(x) (or the sum of its two gradients): two (L, F) arrays in,
    one out; additions are not counted as operations."""
    return Op(name, 0.0, 3 * seq * hidden * F32)


def attention_backward_ops(seq: int, hidden: int, heads: int,
                           head_dim: int, nnz: int,
                           input_grad: bool) -> list:
    """The backward of one layer and its residual connection: two products
    for each product of the forward, but the Q, K, V projections' three
    input products only where the layer's input needs a gradient (not in
    the first layer, whose input is data)."""
    hd = heads * head_dim
    return [
        matmul_op(seq, hd, hidden, "out_proj_bwd", count=2),
        sddmm_op(seq, seq, head_dim, nnz, heads, "aggregate_bwd_p"),
        spmm_op(seq, seq, head_dim, nnz, heads, "aggregate_bwd_v"),
        softmax_op(seq, nnz, heads, "softmax_bwd", reads=2),
        spmm_op(seq, seq, head_dim, nnz, heads, "scores_bwd_q"),
        spmm_op(seq, seq, head_dim, nnz, heads, "scores_bwd_k"),
        matmul_op(seq, hidden, hd, "qkv_proj_bwd",
                  count=6 if input_grad else 3),
    ] + ([residual_op(seq, hidden, "residual_bwd")] if input_grad else [])


def _times(op: Op, n: int) -> Op:
    return Op(op.name, op.flops * n, op.bytes * n)


def attention_train_ops(seq: int, hidden: int, heads: int, head_dim: int,
                        nnz: int, params: int, layers: int = 1,
                        batch: int = 1) -> list:
    """One training step over ``batch`` sequences through ``layers``
    layers, each x + attention(x): every layer's forward, the loss
    mean((out - y)^2), every layer's backward, and one Adam update of
    ``params`` weights (param, grad and two moments read, three written)."""
    forward = attention_forward_ops(seq, hidden, heads, head_dim, nnz) \
        + [residual_op(seq, hidden)]
    per_seq = forward * layers + [Op("loss", 0.0, 3 * seq * hidden * F32)]
    for layer in reversed(range(layers)):
        per_seq += attention_backward_ops(seq, hidden, heads, head_dim, nnz,
                                          input_grad=layer > 0)
    return [_times(op, batch) for op in per_seq] \
        + [Op("adam", 0.0, 7 * params * F32)]


def useful_flops(ops: list) -> float:
    return sum(op.flops for op in ops)


def least_s(ops: list, mode: str) -> float:
    return sum(op.least_s(mode) for op in ops)
