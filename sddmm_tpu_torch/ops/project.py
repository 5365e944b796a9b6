"""The attention layer's projections in the port's "float32" arithmetic:
the Q, K, V projection and the output projection of
``models.BlockSparseAttention``, forward and backward, on one hand-written
Hopper GEMM (``csrc/proj_gemm.cu``).

Every product here is ``C = A . B^T`` with A (M, K) and B (N, K), each fp32
value split into hi/mid/lo bfloat16 planes (``tile_dot.split_bf16``) and
the six products of ``MODES["float32"]`` summed in their order: XLA
HIGHEST's arithmetic, the tile kernel's "float32", within about one fp32
rounding of the exact product.  On the card a product is one launch of
``sddmm_proj_split`` (the planes of its operands, transposed where the
product reads an operand M- or N-major) and one of ``sddmm_proj_gemm``;
a weight gradient (K = the sequence length, few output tiles) splits K over
more CTAs, whose partial sums the tile's last CTA adds in a fixed order.
The GEMM's epilogue writes the layouts the layer
reads, so no copy surrounds it:

- ``qkv_project(x, w_q, w_k, w_v)`` -> ``q_pad`` (H, L+1, D), ``k_pad``
  (Hkv, L+1, D), each with a zero sentinel row L (what
  ``BatchedHybridSDDMM.run_padded`` reads), and ``v`` (Hkv*L, Dv) (what
  ``head_spmm`` reads), times ``v_scale``: x (L, F) is
  read once, the weights (H, F, D), (Hkv, F, D) and (Hkv, F, Dv) through
  their own pointers (Hkv = H and Dv = D but for grouped-query layers such
  as MiMo-V2-Flash's);
- ``out_project(heads, w_o)``: heads (H, L, D), the aggregation's output,
  read head by head as the (L, H*D) matrix it stands for, times w_o
  (H*D, F) -> (L, F).

Each is a ``torch.autograd.Function`` whose backward is launches of the
same kernels: dX = dY . W^T (skipped where ``needs_input_grad`` says so,
as for the first layer's input) and dW = X^T . dY, reading the
cotangents of ``q_pad`` and ``k_pad`` through their strides, without the
sentinel row.  The forward saves its fp32 inputs, not their planes.

CPU tensors, and ``plain=True``, take the plain PyTorch version
(``gemm_plain``: the same planes and six products on exact fp32 upcasts,
summed in the kernel's order); a CUDA tensor takes the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch
from torch.nn import functional as tnf

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.ops.tile_dot import MODES, full_fp32_matmul, split_bf16

#: (A plane, B plane) of the six products, in the kernel's order
PRODUCTS = MODES["float32"][4]
#: the kernel's tile (``csrc/proj_gemm.cu``): C rows and columns of a CTA,
#: and the k slice of a stage (the planes' k chunk: K and each head's width
#: along K are padded to it)
BM, BN, BK = 128, 192, 32
#: the split kernel's most sources a launch
MAX_SPLIT_JOBS = 8
#: the cost model of a split of K (``splits``), fitted to the weight
#: gradients' times on the H100 at 1 to 8 splits: one k slice of a CTA's
#: tile (about 1.35 us) costs as much as this many bytes of partial sums
#: written and read back by the tile's last CTA (about 2.5 us a MB)
SLICE_BYTES = 5.4e5


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) . b (N, K)^T`` in the kernel's arithmetic: both split into
    hi/mid/lo bf16 planes, the six products on exact fp32 upcasts (a bf16
    product is exact in fp32) with TF32 off, summed smallest first.

    The kernel departs from it in one way: the tensor cores truncate each
    32-deep stage's sum toward zero, shrinking it by about 4.5e-8 of itself
    on an H100, and the kernel scales three stages in eight by 1 + 2^-23
    to cancel that on average (``csrc/proj_gemm.cu``, Arithmetic).  This
    version rounds to nearest and has neither the shrink nor the
    correction."""
    ap, bp = split_bf16(a, 3), split_bf16(b, 3)
    out = None
    with full_fp32_matmul():
        for i, j in PRODUCTS:
            d = ap[i].to(torch.float32) @ bp[j].to(torch.float32).T
            out = d if out is None else out + d
    return out


# -- the plain version, layer by layer ---------------------------------------

def _w_rows(ws) -> torch.Tensor:
    """The (Hp, F, Dp) weights as one (sum Hp*Dp, F) matrix, rows
    (which, h, d)."""
    return torch.cat([w.transpose(1, 2).reshape(-1, w.shape[1]) for w in ws])


def _widths(ws):
    """(heads, width) of each weight, and C's column where each starts."""
    shapes = [(w.shape[0], w.shape[2]) for w in ws]
    starts = [0]
    for h, d in shapes:
        starts.append(starts[-1] + h * d)
    return shapes, starts


def _qkv_plain(x, ws, v_scale):
    (shapes, starts), L = _widths(ws), x.shape[0]
    y = gemm_plain(x, _w_rows(ws))
    outs = [y[:, a:b].reshape(L, h, d).permute(1, 0, 2)
            for (h, d), a, b in zip(shapes, starts, starts[1:])]
    pad = (0, 0, 0, 1)
    v = outs[2] if v_scale == 1.0 else outs[2] * v_scale
    return (tnf.pad(outs[0], pad), tnf.pad(outs[1], pad),
            v.reshape(-1, shapes[2][1]).contiguous())


def _qkv_grads_plain(x, ws, gy, need_x, need_w):
    """gy (L, sum Hp*Dp), columns (which, h, d), V's already times the
    value scale."""
    shapes, starts = _widths(ws)
    F = ws[0].shape[1]
    dx = gemm_plain(gy, _w_rows(ws).T) if need_x else None
    dws = (None,) * 3
    if need_w:
        dw = gemm_plain(x.T, gy.T)
        dws = tuple(dw[:, a:b].reshape(F, h, d).permute(1, 0, 2).contiguous()
                    for (h, d), a, b in zip(shapes, starts, starts[1:]))
    return dx, dws


def _out_plain(heads, w_o):
    H, L, D = heads.shape
    return gemm_plain(heads.permute(1, 0, 2).reshape(L, H * D), w_o.T)


def _out_grads_plain(heads, w_o, g, need_h, need_w):
    H, L, D = heads.shape
    dh = (gemm_plain(g, w_o).reshape(L, H, D).permute(1, 0, 2)
          .reshape(H * L, D) if need_h else None)
    dw = (gemm_plain(heads.permute(0, 2, 1).reshape(H * D, L), g.T)
          if need_w else None)
    return dh, dw


# -- the kernel path ----------------------------------------------------------

def _pad(n: int) -> int:
    return -(-n // BK) * BK


def _card(device):
    """The launches' card made current (their C calls launch there)."""
    return torch.cuda.device(device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    """SMs of card ``index`` (None: the current card)."""
    if index is None:
        index = torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(M: int, N: int, nkb: int, sms: int) -> int:
    """How many parts a product splits its ``nkb`` k slices into: 1 where
    its tiles fill the card's ``sms`` SMs, else the count that least costs
    waves x slices a part, plus writing and reading back the parts'
    partial sums (``SLICE_BYTES``)."""
    tiles = -(-M // BM) * -(-N // BN)
    if tiles >= sms or N % 4:   # the partial sums are added float4-wise
        return 1
    best, best_cost = 1, math.inf
    for s in range(1, 17):
        per = -(-nkb // s)
        if s > 1 and per < 4:
            break
        cost = (-(-tiles * s // sms) * per * SLICE_BYTES
                + (s > 1) * s * M * N * 4)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def _planes(n: int, device, zero: bool) -> torch.Tensor:
    """Three bf16 planes of ``n`` elements each, zero where a padded chunk
    leaves lanes the split does not write."""
    make = torch.zeros if zero else torch.empty
    return make(3 * n, dtype=torch.bfloat16, device=device)


def _ptr(t: torch.Tensor, offset: int = 0) -> int:
    return t.data_ptr() + offset * t.element_size()


def _dst(planes, R: int, K: int, trans: bool, row0=0, k0=0, row_b=0,
         k_b=0):
    """A destination of a split job: the planes of an operand of ``R`` rows
    and ``K`` columns (a multiple of BK), laid out in BK-deep k chunks,
    ``(row, k)`` at ``((k // BK) * R + row) * BK + k % BK``, so that each
    TMA box of the GEMM is one contiguous block.  Source element (b, r, c)
    goes to row ``row0 + b*row_b + r`` and k ``k0 + b*k_b + c``, or
    ``trans``-posed to row ``row0 + b*row_b + c`` and k ``k0 + b*k_b + r``."""
    return [_ptr(planes), R, row0, k0, row_b, k_b, int(trans), R * K]


@functools.lru_cache(maxsize=None)
def _float_word(x: float) -> int:
    """A float's fp32 bits, as the kernels read a scale from a word."""
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _job(src, nb, nr, nc, sb, sr, *dsts, scale=1.0):
    """One source of a split launch, (nb, nr, nc) fp32 at ``src + b*sb +
    r*sr + c``, times ``scale``, into one or two destinations (``_dst``)."""
    words = [_ptr(src), nb, nr, nc, sb, sr]
    for d in dsts:
        words += d
    return words + [0] * (6 + 8 * 2 - len(words)) + [
        _ONE if scale == 1.0 else _float_word(scale)]


def _split(jobs, device) -> None:
    if not jobs:
        return
    words = [w for job in jobs for w in job]
    arr = (ctypes.c_longlong * len(words))(*words)
    _kernels.launch(_kernels.PROJ_SPLIT_ENTRY, ctypes.addressof(arr),
                    len(jobs), _stream(device))


def _out(parts, sentinel_row=-1, sentinel_mask=0):
    """C's layout from up to three column parts ``(base, s_h, s_r, cols,
    chunk, scale)``, in column order: part p's column n (from the part's
    first) in chunk h = n // chunk, at d = n % chunk; (m, n) holds scale *
    C[m, n] at ``base + h*s_h + m*s_r + d``; row ``sentinel_row`` of the
    parts in ``sentinel_mask`` written 0."""
    words = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, _ONE, _ONE, _ONE,
             sentinel_row, sentinel_mask]
    n = 0
    for i, (base, s_h, s_r, cols, chunk, scale) in enumerate(parts):
        n += cols
        words[i], words[3 + i], words[6 + i] = _ptr(base), s_h, s_r
        words[12 + i], words[15 + i] = chunk, _float_word(scale)
        words[9 + i] = n
    for i in range(len(parts), 3):
        words[9 + i] = n
    return words


_ONE = _float_word(1.0)


def _one(base, cols, s_r):
    """C as one row-major part: ``cols`` columns, rows ``s_r`` apart."""
    return _out([(base, 0, s_r, cols, cols, 1.0)])


_counters: dict = {}


def _tile_counters(device, tiles: int) -> torch.Tensor:
    """A zero int32 a tile for a split product's last-CTA count, kept per
    card: the kernel leaves each counter zero again, so launches in stream
    order share them."""
    have = _counters.get(device)
    if have is None or have.numel() < tiles:
        have = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                           device=device)
        _counters[device] = have
    return have


#: the word of ``_out``'s list that holds the sentinel row (-1: none)
_SENTINEL_WORD = 18


def _gemm(M, N, K, a, b, out, device) -> None:
    """One product: C (M, N) = A . B^T over K (a multiple of BK) from the
    operands' planes ``a`` and ``b`` (each (planes, rows), laid out as
    ``_dst`` says), into the layout ``out``; K split over more CTAs, with
    a workspace for their partial sums, where the tiles leave SMs idle and
    C has no sentinel row (only the unsplit epilogue writes one)."""
    s = (1 if out[_SENTINEL_WORD] >= 0
         else splits(M, N, K // BK, _sms(device.index)))
    ws = counters = None
    if s > 1:
        ws = torch.empty((s, M, N), dtype=torch.float32, device=device)
        counters = _tile_counters(device, -(-M // BM) * -(-N // BN))
    desc = ([M, N, K, s, _ptr(a[0]), a[1], K, _ptr(b[0]), b[1], K] + out
            + [0 if ws is None else _ptr(ws),
               0 if counters is None else _ptr(counters)])
    arr = (ctypes.c_longlong * len(desc))(*desc)
    _kernels.launch(_kernels.PROJ_GEMM_ENTRY, ctypes.addressof(arr),
                    _stream(device))


def _rows_contiguous(name, t, dims):
    if t.dtype != torch.float32 or t.dim() != dims or t.stride(-1) != 1:
        raise ValueError(f"project: {name} must be fp32 with {dims} "
                         f"dimensions and a contiguous last one, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _qkv_kernel(x, ws, v_scale):
    L, F = x.shape
    (shapes, starts), Fp = _widths(ws), _pad(F)
    N = starts[-1]
    dev = x.device
    xs = _planes(L * Fp, dev, Fp != F)
    wt = _planes(N * Fp, dev, Fp != F)
    jobs = [_job(x, 1, L, F, 0, x.stride(0), _dst(xs, L, Fp, False))]
    for w, (h, d), row0 in zip(ws, shapes, starts):  # rows (which, h, d)
        jobs.append(_job(w, h, F, d, w.stride(0), w.stride(1),
                         _dst(wt, N, Fp, True, row0=row0, row_b=d)))
    _split(jobs, dev)
    (H, D), (Hk, _), (_, Dv) = shapes
    q_pad = torch.empty((H, L + 1, D), dtype=torch.float32, device=dev)
    k_pad = torch.empty((Hk, L + 1, D), dtype=torch.float32, device=dev)
    v = torch.empty((Hk * L, Dv), dtype=torch.float32, device=dev)
    _gemm(L, N, Fp, (xs, L), (wt, N),
          _out([(q_pad, (L + 1) * D, D, H * D, D, 1.0),
                (k_pad, (L + 1) * D, D, Hk * D, D, 1.0),
                (v, L * Dv, Dv, Hk * Dv, Dv, v_scale)],
               sentinel_row=L, sentinel_mask=3), dev)
    return q_pad, k_pad, v


def _qkv_grads_kernel(x, ws, gs, need_x, need_w, v_scale):
    """gs: the cotangents as (Hp, L, Dp) views (q's and k's without the
    sentinel row); V's is split times the value scale."""
    L, F = x.shape
    (shapes, starts), Lp = _widths(ws), _pad(L)
    N = starts[-1]
    # dX's K: (which, h, d), each head padded to the k step
    koff = [0]
    for h, d in shapes:
        koff.append(koff[-1] + h * _pad(d))
    KX = koff[-1]
    dev = x.device
    jobs = []
    pads = any(_pad(d) != d for _, d in shapes)
    if need_x:
        g_same = _planes(L * KX, dev, pads)
        w_same = _planes(F * KX, dev, pads)
    if need_w:
        g_t = _planes(N * Lp, dev, Lp != L)
        x_t = _planes(F * Lp, dev, Lp != L)
        jobs.append(_job(x, 1, L, F, 0, x.stride(0),
                         _dst(x_t, F, Lp, True)))
    for i, (g, (h, d)) in enumerate(zip(gs, shapes)):
        dsts = []
        if need_x:
            dsts.append(_dst(g_same, L, KX, False, k0=koff[i], k_b=_pad(d)))
        if need_w:
            dsts.append(_dst(g_t, N, Lp, True, row0=starts[i], row_b=d))
        jobs.append(_job(g, h, L, d, g.stride(0), g.stride(1), *dsts,
                         scale=v_scale if i == 2 else 1.0))
    if need_x:
        for i, (w, (h, d)) in enumerate(zip(ws, shapes)):
            jobs.append(_job(w, h, F, d, w.stride(0), w.stride(1),
                             _dst(w_same, F, KX, False, k0=koff[i],
                                  k_b=_pad(d))))
    _split(jobs, dev)
    dx, dws = None, (None,) * 3
    if need_x:
        dx = torch.empty((L, F), dtype=torch.float32, device=dev)
        _gemm(L, F, KX, (g_same, L), (w_same, F), _one(dx, F, F), dev)
    if need_w:
        dws = tuple(torch.empty((h, F, d), dtype=torch.float32, device=dev)
                    for h, d in shapes)
        _gemm(F, N, Lp, (x_t, F), (g_t, N),
              _out([(dw, F * d, d, h * d, d, 1.0)
                    for dw, (h, d) in zip(dws, shapes)]), dev)
    return dx, dws


def _out_kernel(heads, w_o):
    H, L, D = heads.shape
    F = w_o.shape[1]
    Dp = _pad(D)
    K = H * Dp        # (h, d), each head padded to Dp
    dev = heads.device
    hs = _planes(L * K, dev, Dp != D)
    wt = _planes(F * K, dev, Dp != D)
    _split([_job(heads, H, L, D, heads.stride(0), heads.stride(1),
                 _dst(hs, L, K, False, k_b=Dp)),
            # w_o as (h, d, f): rows f, k (h, d)
            _job(w_o, H, D, F, D * w_o.stride(0), w_o.stride(0),
                 _dst(wt, F, K, True, k_b=Dp))], dev)
    out = torch.empty((L, F), dtype=torch.float32, device=dev)
    _gemm(L, F, K, (hs, L), (wt, F), _one(out, F, F), dev)
    return out


def _out_grads_kernel(heads, w_o, g, need_h, need_w):
    H, L, D = heads.shape
    F = w_o.shape[1]
    HD, Fp, Lp = H * D, _pad(F), _pad(L)
    dev = heads.device
    jobs, dsts = [], []
    if need_h:
        g_same = _planes(L * Fp, dev, Fp != F)
        w_same = _planes(HD * Fp, dev, Fp != F)
        dsts.append(_dst(g_same, L, Fp, False))
        jobs.append(_job(w_o, 1, HD, F, 0, w_o.stride(0),
                         _dst(w_same, HD, Fp, False)))
    if need_w:
        g_t = _planes(F * Lp, dev, Lp != L)
        h_t = _planes(HD * Lp, dev, Lp != L)
        dsts.append(_dst(g_t, F, Lp, True))
        jobs.append(_job(heads, H, L, D, heads.stride(0), heads.stride(1),
                         _dst(h_t, HD, Lp, True, row_b=D)))
    if dsts:
        jobs.append(_job(g, 1, L, F, 0, g.stride(0), *dsts))
    _split(jobs, dev)
    dh = dw = None
    if need_h:
        dh = torch.empty((H * L, D), dtype=torch.float32, device=dev)
        _gemm(L, HD, Fp, (g_same, L), (w_same, HD),
              _out([(dh, L * D, D, HD, D, 1.0)]), dev)
    if need_w:
        dw = torch.empty((HD, F), dtype=torch.float32, device=dev)
        _gemm(HD, F, Lp, (h_t, HD), (g_t, F), _one(dw, F, F), dev)
    return dh, dw


# -- the autograd ops ---------------------------------------------------------

def _kernel_path(t: torch.Tensor, plain: bool) -> bool:
    if plain or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"project: unsupported device {t.device}")
    return True


class _QKVFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_k, w_v, plain, v_scale):
        ws = (w_q, w_k, w_v)
        ctx.save_for_backward(x, *ws)
        ctx.plain, ctx.v_scale = plain, v_scale
        if _kernel_path(x, plain):
            with _card(x.device):
                return _qkv_kernel(x, ws, v_scale)
        return _qkv_plain(x, ws, v_scale)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, *ws = ctx.saved_tensors
        (H, D), (Hk, _), (_, Dv) = _widths(ws)[0]
        L = x.shape[0]
        need_x = ctx.needs_input_grad[0]
        need_w = any(ctx.needs_input_grad[1:4])
        zero = functools.partial(torch.zeros, dtype=torch.float32,
                                 device=x.device)
        gq = zero((H, L + 1, D)) if gq is None else gq
        gk = zero((Hk, L + 1, D)) if gk is None else gk
        gv = zero((Hk * L, Dv)) if gv is None else gv
        gs = tuple(g if g.stride(-1) == 1 else g.contiguous()
                   for g in (gq[:, :L], gk[:, :L], gv.view(Hk, L, Dv)))
        if _kernel_path(x, ctx.plain):
            with _card(x.device):
                dx, dws = _qkv_grads_kernel(x, ws, gs, need_x, need_w,
                                            ctx.v_scale)
        else:
            gv = gs[2] if ctx.v_scale == 1.0 else gs[2] * ctx.v_scale
            gy = torch.cat([g.permute(1, 0, 2).reshape(L, -1)
                            for g in (gs[0], gs[1], gv)], dim=1)
            dx, dws = _qkv_grads_plain(x, ws, gy, need_x, need_w)
        return (dx, *(dw if need else None
                      for dw, need in zip(dws, ctx.needs_input_grad[1:4])),
                None, None)


class _OutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, w_o, plain):
        ctx.save_for_backward(heads, w_o)
        ctx.plain = plain
        if _kernel_path(heads, plain):
            with _card(heads.device):
                return _out_kernel(heads, w_o)
        return _out_plain(heads, w_o)

    @staticmethod
    def backward(ctx, g):
        heads, w_o = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        if g.stride(-1) != 1:
            g = g.contiguous()
        if _kernel_path(heads, ctx.plain):
            with _card(heads.device):
                dh, dw = _out_grads_kernel(heads, w_o, g, need_h, need_w)
        else:
            dh, dw = _out_grads_plain(heads, w_o, g, need_h, need_w)
        if dh is not None:
            dh = dh.view(heads.shape)
        return dh, dw, None


def qkv_project(x: torch.Tensor, w_q: torch.Tensor, w_k: torch.Tensor,
                w_v: torch.Tensor, plain: bool = False,
                v_scale: float = 1.0):
    """x (L, F) times the weights w_q (H, F, D), w_k (Hkv, F, D) and w_v
    (Hkv, F, Dv) -> (q_pad, k_pad, v): q_pad (H, L+1, D) and k_pad (Hkv,
    L+1, D) with row L zero, v (Hkv*L, Dv) times ``v_scale``."""
    _rows_contiguous("x", x, 2)
    H, F, D = w_q.shape
    Hk, Dv = w_k.shape[0], w_v.shape[2]
    for name, w, shape in (("w_q", w_q, (H, F, D)), ("w_k", w_k, (Hk, F, D)),
                           ("w_v", w_v, (Hk, F, Dv))):
        _rows_contiguous(name, w, 3)
        if w.shape != shape or w.shape[1] != x.shape[1]:
            raise ValueError(f"qkv_project: {name} {tuple(w.shape)} does "
                             f"not fit x {tuple(x.shape)} and w_q "
                             f"{tuple(w_q.shape)}")
        if w.device != x.device:
            raise ValueError(f"qkv_project: {name} is on {w.device}, x on "
                             f"{x.device}")
    return _QKVFn.apply(x, w_q, w_k, w_v, plain, float(v_scale))


def out_project(heads: torch.Tensor, w_o: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """heads (H, L, D), the rows of (L, H*D) head by head, times w_o
    (H*D, F) -> (L, F)."""
    _rows_contiguous("heads", heads, 3)
    _rows_contiguous("w_o", w_o, 2)
    H, _, D = heads.shape
    if w_o.shape[0] != H * D:
        raise ValueError(f"out_project: w_o {tuple(w_o.shape)} does not fit "
                         f"heads {tuple(heads.shape)}")
    if w_o.device != heads.device:
        raise ValueError(f"out_project: w_o is on {w_o.device}, heads on "
                         f"{heads.device}")
    return _OutFn.apply(heads, w_o, plain)
