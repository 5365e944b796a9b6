"""Rotary position embedding (RoPE) of the query and key heads, the position
encoding of MiMo-V2-Flash's attention layers: the first R dimensions of
each head, in the "rotate half" pairing (d, d + R/2), rotated by the angle
``i * theta^(-2d/R)`` at position i; the other dimensions unchanged.

``rope_table`` builds the (cos, sin) table of a sequence once, in float64,
rounded to fp32 (fp32 angles near position 4096 would err by 2.4e-4).
``apply_rope(q_pad, k_pad, table)`` rotates the padded layouts the hybrid
SDDMM reads, (H, L+1, D) with the zero sentinel row L left as it is, in
place: one launch of ``csrc/rope.cu`` for both on the card.  It is an
autograd op whose backward is the inverse rotation, one more launch, into
new tensors.  CPU tensors, and ``plain=True``, take ``rope_plain``: the
same products and sums in torch ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sddmm_tpu_torch import _kernels


@functools.lru_cache(maxsize=8)
def _table_host(rows: int, rotary: int, theta: float) -> np.ndarray:
    half = rotary // 2
    inv = theta ** (-2.0 * np.arange(half, dtype=np.float64) / rotary)
    ang = np.arange(rows, dtype=np.float64)[:, None] * inv[None]
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def rope_table(rows: int, rotary: int, theta: float,
               device) -> torch.Tensor:
    """(rows, R/2, 2) fp32 (cos, sin) of position i and pair d, computed in
    float64 and rounded once."""
    if rotary % 2 or rotary < 2:
        raise ValueError(f"rope: want an even rotary width, got {rotary}")
    return torch.as_tensor(_table_host(rows, rotary, float(theta)),
                           device=device)


def rope_plain(x: torch.Tensor, table: torch.Tensor,
               inverse: bool = False) -> torch.Tensor:
    """x (H, rows_pad, D) -> a new tensor, its first ``table.shape[0]`` rows
    rotated on dims [0, R) (``inverse``: by the opposite angle), the rest
    copied; each product and the sum rounded apart, as the kernel's."""
    rows, half = table.shape[:2]
    out = x.clone()
    a, b = x[:, :rows, :half], x[:, :rows, half:2 * half]
    c, s = table[None, :, :, 0], table[None, :, :, 1]
    if inverse:
        out[:, :rows, :half] = a * c + b * s
        out[:, :rows, half:2 * half] = b * c - a * s
    else:
        out[:, :rows, :half] = a * c - b * s
        out[:, :rows, half:2 * half] = b * c + a * s
    return out


def _check(name, x, table):
    if (x.dim() != 3 or x.dtype != torch.float32 or x.stride(2) != 1
            or x.device != table.device or table.dtype != torch.float32
            or table.dim() != 3 or table.shape[2] != 2
            or 2 * table.shape[1] > x.shape[2]
            or table.shape[0] > x.shape[1] or not table.is_contiguous()):
        raise ValueError(f"rope: {name} {tuple(x.shape)} {x.dtype} on "
                         f"{x.device} does not fit the table "
                         f"{tuple(table.shape)} {table.dtype} on "
                         f"{table.device}")


def _launch(ins, outs, table, inverse):
    """One launch for q and k: ``outs[i]`` gets ``ins[i]`` rotated (the same
    tensors: in place)."""
    (q, k), (qo, ko) = ins, outs
    rows, half = table.shape[:2]
    with torch.cuda.device(q.device):
        _kernels.launch(_kernels.ROPE_ENTRY, q.data_ptr(), qo.data_ptr(),
                        q.stride(0), q.stride(1), q.shape[0], k.data_ptr(),
                        ko.data_ptr(), k.stride(0), k.stride(1), k.shape[0],
                        table.data_ptr(), rows, q.shape[1], q.shape[2],
                        2 * half, int(inverse),
                        torch.cuda.current_stream().cuda_stream)


def _same_layout(a, b):
    return a.shape == b.shape and a.stride() == b.stride()


class _RopeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, table, plain):
        ctx.save_for_backward(table)
        ctx.plain = plain
        if plain or q.device.type == "cpu":
            return rope_plain(q, table), rope_plain(k, table)
        _launch((q, k), (q, k), table, False)
        ctx.mark_dirty(q, k)
        return q, k

    @staticmethod
    def backward(ctx, gq, gk):
        (table,) = ctx.saved_tensors
        gq = gq if gq.stride(-1) == 1 else gq.contiguous()
        gk = gk if gk.stride(-1) == 1 else gk.contiguous()
        if ctx.plain or gq.device.type == "cpu":
            return (rope_plain(gq, table, True), rope_plain(gk, table, True),
                    None, None)
        dq, dk = torch.empty_like(gq), torch.empty_like(gk)
        if not (_same_layout(gq, dq) and _same_layout(gk, dk)):
            gq, gk = gq.contiguous(), gk.contiguous()
            dq, dk = torch.empty_like(gq), torch.empty_like(gk)
        _launch((gq, gk), (dq, dk), table, True)
        return dq, dk, None, None


def apply_rope(q_pad: torch.Tensor, k_pad: torch.Tensor,
               table: torch.Tensor, plain: bool = False):
    """RoPE on q_pad (H, L+1, D) and k_pad (Hkv, L+1, D): rows 0..L-1 at
    positions 0..L-1 (``table`` (L, R/2, 2), ``rope_table``), the sentinel
    row as it is.  On the card one launch, in place (the inputs are the
    outputs); on the CPU or with ``plain``, new tensors."""
    _check("q", q_pad, table)
    _check("k", k_pad, table)
    if q_pad.shape[1:] != k_pad.shape[1:]:
        raise ValueError(f"rope: q {tuple(q_pad.shape)} and k "
                         f"{tuple(k_pad.shape)} differ in rows or width")
    return _RopeFn.apply(q_pad, k_pad, table, plain)
