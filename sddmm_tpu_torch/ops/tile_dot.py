"""Batched tile dot at tf32 class: the port of the Pallas tile-dot kernel.

Counterpart of ``sddmm_tpu/ops/pallas_tiles.py`` (``_tile_dot_kernel``,
``tile_dot_tf32``, ``tile_dot_padded``): ``(nT, R, K) x (nT, L, K) ->
(nT, R, L)`` fp32, computed as the 3-pass bfloat16 product ``ah.bh^T +
ah.bl^T + al.bh^T`` on the hi/lo split of both operands, with fp32
accumulation — about 16 mantissa bits, far more than NVIDIA TF32's 10.

- ``tile_dot_bf16x3`` launches the hand-written CUDA kernel
  (``csrc/tile_dot.cu``) for CUDA tensors, and takes the plain version for
  CPU tensors.  It needs no padding of nT: the kernel's grid covers the
  tiles directly.
- ``tile_dot_bf16x3_plain`` is the same math in PyTorch ops, the CPU path
  and the kernel's reference on the card.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from sddmm_tpu_torch import _kernels


def split_hi_lo(x: torch.Tensor):
    """fp32 -> (hi, lo) bfloat16 with round-to-nearest-even, as
    ``pallas_tiles._split_hi_lo``."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


@contextlib.contextmanager
def full_fp32_matmul():
    """Run matmuls in full fp32: TF32 (10-bit) would spoil a reference on
    the card.  Restores the caller's settings on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def tile_dot_bf16x3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the hi/lo split in torch, the three products
    on exact fp32 upcasts (a bf16 x bf16 product is exact in fp32)."""
    ah, al = split_hi_lo(a)
    bh, bl = split_hi_lo(b)

    def d(x, y):
        return torch.bmm(x.to(torch.float32),
                         y.to(torch.float32).transpose(1, 2))

    with full_fp32_matmul():
        return d(ah, bh) + d(ah, bl) + d(al, bh)


def _check(a: torch.Tensor, b: torch.Tensor, out):
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"tile_dot: want 3-D a and b, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    nT, R, K = a.shape
    if b.shape[0] != nT or b.shape[2] != K:
        raise ValueError(f"tile_dot: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree on nT or K")
    L = b.shape[1]
    if R % 16 or L % 16 or K % 16:
        raise ValueError(f"tile_dot: R={R}, L={L}, K={K} must all be "
                         "multiples of 16")
    for name, t in (("a", a), ("b", b)) + ((("out", out),) if out is not None
                                            else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"tile_dot: {name} is {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"tile_dot: {name} is not contiguous")
        if t.device != a.device:
            raise ValueError(f"tile_dot: {name} is on {t.device}, a on "
                             f"{a.device}")
    if out is not None and tuple(out.shape) != (nT, R, L):
        raise ValueError(f"tile_dot: out {tuple(out.shape)} != "
                         f"{(nT, R, L)}")
    return nT, R, L, K


def tile_dot_bf16x3(a: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor = None) -> torch.Tensor:
    """Batched tile dot ``(nT, R, K) x (nT, L, K) -> (nT, R, L)`` fp32 at
    tf32 class.  R, L, K multiples of 16; float32, contiguous, one device.
    ``out`` (optional) is written in place, e.g. a view of a larger
    buffer.  CUDA tensors go through the kernel (or raise); CPU tensors
    through ``tile_dot_bf16x3_plain``."""
    nT, R, L, K = _check(a, b, out)
    if a.device.type == "cpu":
        res = tile_dot_bf16x3_plain(a, b)
        if out is None:
            return res
        out.copy_(res)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"tile_dot: unsupported device {a.device}")
    if out is None:
        out = torch.empty((nT, R, L), dtype=torch.float32, device=a.device)
    for name, t in (("a", a), ("b", b), ("out", out)):
        if t.data_ptr() % 32:
            raise ValueError(f"tile_dot: {name} is not 32-byte aligned")
    if nT == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sddmm_tile_dot_bf16x3(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), nT, R, L, K,
            ctypes.c_void_p(stream))
    _kernels.check(rc, "tile_dot_bf16x3")
    tile_dot_bf16x3.launches += 1
    return out


#: kernel launches made by ``tile_dot_bf16x3`` (CUDA path only)
tile_dot_bf16x3.launches = 0
