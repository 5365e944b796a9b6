"""Batched tile dot in the five compute modes: the port of the Pallas tile-dot
kernel, and of the XLA dots around it.

Counterpart of ``sddmm_tpu/ops/pallas_tiles.py`` (``_tile_dot_kernel``,
``tile_dot_tf32``, ``tile_dot_padded``) and of the dot products of
``sddmm_tpu/ops/hybrid.py`` (``_dot3``, the ``"mixed"`` branch,
``Precision.HIGH``/``HIGHEST``) and ``sddmm_tpu/ops/dense.py``:
``(nT, R, K) x (nT, L, K) -> (nT, R, L)``, accumulated in fp32.  Each mode
stores its operands in the JAX package's storage types (``STORAGE``) and
splits each value into bfloat16 planes (``split_bf16``) before the bf16
products (``MODES``):

- ``"tf32"``: fp32, ``ah.bh + ah.bl + al.bh`` on the hi/lo split of both
  operands, about 16 mantissa bits (XLA's ``Precision.HIGH``), far more
  than NVIDIA TF32's 10;
- ``"mixed"``: fp32 A split hi/lo times bf16 B, two products;
- ``"float16"``: fp16 storage, upcast exactly, then as ``"tf32"``;
- ``"bfloat16"``: one native bf16 product;
- ``"float32"``: the six products of a hi/mid/lo split of both operands
  (those whose plane orders sum to at most 2), the scheme of XLA's
  ``Precision.HIGHEST`` on the TPU: within about one fp32 rounding of the
  exact product, on the same tensor-core kernel as the other modes.

``tile_dot`` launches the hand-written CUDA kernel (``csrc/tile_dot.cu``,
one instance per mode) for CUDA tensors, and takes ``tile_dot_plain`` for
CPU tensors.  It takes strided operands: A and B rows at any 16-byte row
stride (so a K chunk is a column view, and C chunks are C calls with
``accumulate``), and an output view with any strides, e.g. a slab of a flat
vector.  It takes any K: the kernel steps K by 16, so for K not a multiple
of 16 ``tile_dot`` zero-pads a copy of A and of B along K first (zero
planes add exact zeros, and the copies' rows are 16-byte aligned).
``tile_dot_plain`` is the same math in PyTorch ops on the unpadded
operands, the CPU path and the kernels' reference on the card.
"""

from __future__ import annotations

import contextlib

import torch

from sddmm_tpu_torch import _kernels

_HL = ((0, 0), (0, 1), (1, 0))
#: mode -> (A storage, B storage, A planes, B planes, (A plane, B plane)
#: of each product, in the kernel's order)
MODES = {
    "tf32": (torch.float32, torch.float32, 2, 2, _HL),
    "mixed": (torch.float32, torch.bfloat16, 2, 1, ((0, 0), (1, 0))),
    "float16": (torch.float16, torch.float16, 2, 2, _HL),
    "bfloat16": (torch.bfloat16, torch.bfloat16, 1, 1, ((0, 0),)),
    "float32": (torch.float32, torch.float32, 3, 3,
                ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))),
}
#: mode -> (A storage dtype, B storage dtype), as the JAX package's _STORAGE
STORAGE = {mode: spec[:2] for mode, spec in MODES.items()}
_ALIGN = 16  # bytes: the kernel stages A and B rows with 16-byte loads
K_STEP = 16  # the kernel's k step: K is padded up to a multiple of it
_MAX_GRID_YZ = 65535 * 64  # rows (R) or columns (L) the grid can cover


def split_bf16(x: torch.Tensor, planes: int) -> list:
    """x -> ``planes`` bfloat16 planes (round to nearest even) whose fp32
    sum carries x: hi, then hi/lo (``pallas_tiles._split_hi_lo``), then
    hi/mid/lo.  fp16 and bf16 inputs upcast exactly first."""
    rest = x.to(torch.float32)
    out = []
    for i in range(planes):
        p = rest.to(torch.bfloat16)
        out.append(p)
        if i + 1 < planes:
            rest = rest - p.to(torch.float32)
    return out


def split_probe(rng, shape) -> torch.Tensor:
    """fp32 values ``s * (1 + 2^-9 + 2^-18)``, s in [1, 2) with 4 fraction
    bits: exact in fp32, with hi/mid/lo bf16 planes exactly s, s*2^-9 and
    s*2^-18.  On a product of two of them the "tf32" split drops the mid x
    mid and both hi x lo products, 3*2^-18 (1.1e-5) of it, while "float32"
    keeps them and drops only about 2^-26: operands that tell the two
    instances apart, where U[0,2) data leaves them within a few 1e-6."""
    s = 1.0 + rng.integers(0, 16, shape) / 16.0
    return torch.tensor(s * (1.0 + 2.0 ** -9 + 2.0 ** -18),
                        dtype=torch.float32)


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


def tile_dot_plain(a: torch.Tensor, b: torch.Tensor,
                   mode: str = "tf32") -> torch.Tensor:
    """Plain PyTorch version of ``mode``'s instance: the planes split in
    torch, each product on exact fp32 upcasts (a bf16 x bf16 product is
    exact in fp32) with TF32 off, summed in the kernel's order."""
    _, _, pa, pb, products = MODES[mode]
    ap, bp = split_bf16(a, pa), split_bf16(b, pb)
    out = None
    with full_fp32_matmul():
        for i, j in products:
            d = torch.bmm(ap[i].to(torch.float32),
                          bp[j].to(torch.float32).transpose(1, 2))
            out = d if out is None else out + d
    return out


def _check(a, b, mode, out, accumulate):
    if mode not in MODES:
        raise ValueError(f"tile_dot: unknown mode {mode!r}")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"tile_dot: want 3-D a and b, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    nT, R, K = a.shape
    if b.shape[0] != nT or b.shape[2] != K:
        raise ValueError(f"tile_dot: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree on nT or K")
    L = b.shape[1]
    if R < 1 or L < 1 or K < 1:
        raise ValueError(f"tile_dot: R={R}, L={L} and K={K} must be >= 1")
    if R > _MAX_GRID_YZ or L > _MAX_GRID_YZ:
        raise ValueError(f"tile_dot: R={R} or L={L} exceeds the grid's "
                         f"{_MAX_GRID_YZ}")
    adt, bdt = STORAGE[mode]
    tensors = [("a", a, adt), ("b", b, bdt)]
    if out is not None:
        tensors.append(("out", out, torch.float32))
        if tuple(out.shape) != (nT, R, L):
            raise ValueError(f"tile_dot: out {tuple(out.shape)} != "
                             f"{(nT, R, L)}")
    elif accumulate:
        raise ValueError("tile_dot: accumulate needs out")
    for name, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"tile_dot[{mode}]: {name} is {t.dtype}, want "
                            f"{dt}")
        if t.device != a.device:
            raise ValueError(f"tile_dot: {name} is on {t.device}, a on "
                             f"{a.device}")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"tile_dot: {name}'s last dimension is not "
                             "contiguous")
    # operands of a K that is not a multiple of K_STEP are copied (padded)
    # before a launch, so only the others must have aligned rows
    for name, t in (("a", a), ("b", b)) if K % K_STEP == 0 else ():
        size = t.element_size()
        if (t.data_ptr() % _ALIGN
                or (t.shape[1] > 1 and t.stride(1) * size % _ALIGN)
                or (t.shape[0] > 1 and t.stride(0) * size % _ALIGN)):
            raise ValueError(f"tile_dot: {name}'s rows are not "
                             f"{_ALIGN}-byte aligned (strides "
                             f"{t.stride()})")
    return nT, R, L, K


def pad_k(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x (.., K) zero-padded along K up to the next
    multiple of ``K_STEP``: the kernel's operand for a K off its step."""
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % K_STEP))


def tile_dot(a: torch.Tensor, b: torch.Tensor, mode: str = "tf32",
             out: torch.Tensor = None, accumulate: bool = False,
             plain: bool = False) -> torch.Tensor:
    """Batched tile dot ``(nT, R, K) x (nT, L, K) -> (nT, R, L)`` fp32 in
    compute mode ``mode``; a and b in the mode's ``STORAGE`` dtypes, on one
    device, last dimension contiguous; R, L, K >= 1, and rows 16-byte
    aligned where K is a multiple of 16 (other K are zero-padded to one,
    into aligned copies, before the launch).  ``out`` (optional, any
    strides with a contiguous last dimension) is written in place, or
    added to with ``accumulate``.
    CUDA tensors go through the mode's kernel instance (or raise); CPU
    tensors, or any with ``plain=True`` (only ever chosen explicitly, as
    the reference a kernel is timed against), through
    ``tile_dot_plain``."""
    nT, R, L, K = _check(a, b, mode, out, accumulate)
    if plain or a.device.type == "cpu":
        res = tile_dot_plain(a, b, mode)
        if out is None:
            return res
        if accumulate:
            return out.add_(res)
        return out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"tile_dot: unsupported device {a.device}")
    if out is None:
        out = torch.empty((nT, R, L), dtype=torch.float32, device=a.device)
    if nT == 0:
        return out
    if K % K_STEP:
        a, b = pad_k(a), pad_k(b)
        K = a.shape[2]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(f"sddmm_tile_dot_{mode}",
                        a.data_ptr(), a.stride(0), a.stride(1),
                        b.data_ptr(), b.stride(0), b.stride(1),
                        out.data_ptr(), out.stride(0), out.stride(1),
                        nT, R, L, K, int(accumulate), stream)
    return out
