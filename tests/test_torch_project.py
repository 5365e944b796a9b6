"""The attention layer's projections (``sddmm_tpu_torch.ops.project``) on
the CPU: the plain version's six-product arithmetic against fp64, both
autograd ops' gradients against fp64 autograd, the fused layouts, the first
layer's skipped input gradient, and the kernel path's launches (split jobs,
tensor-map words, C's layouts, the split K) run by an emulator of the two
C entry points of ``csrc/proj_gemm.cu`` that reads and writes the host
memory the words point at, with the kernel's arithmetic."""

from __future__ import annotations

import collections
import contextlib
import ctypes
import struct

import numpy as np
import pytest
import torch

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.ops import project as pj
from sddmm_tpu_torch.ops import tile_dot as td

#: the plain version against the fp64 product, max |err| / max |exact|
PLAIN_FP64 = 2e-7
#: a gradient (a sum over positions of terms of both signs) against fp64
#: autograd, max |err| / max |exact|: a few fp32 roundings of its terms
GRAD_FP64 = 2e-6


def _fp32(rng, shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


# -- the plain version's arithmetic --------------------------------------------

def _three_products(a, b):
    """The "tf32" split (hi/lo, three products): what fewer planes give."""
    ap, bp = td.split_bf16(a, 2), td.split_bf16(b, 2)
    with td.full_fp32_matmul():
        return sum(ap[i].float() @ bp[j].float().T for i, j in td._HL)


@pytest.mark.parametrize("M,N,K", [(16, 24, 32), (40, 8, 96)])
@pytest.mark.parametrize("probe", [False, True], ids=["normal",
                                                      "split_probe"])
def test_gemm_plain_within_fp32_of_fp64(M, N, K, probe):
    """The six products carry the product to fp32's order; on split_probe
    operands (planes s, s*2^-9, s*2^-18) three products miss 3*2^-18 of
    each term, so an arithmetic with fewer planes or products fails here."""
    rng = np.random.default_rng(M + K)
    if probe:
        a, b = td.split_probe(rng, (M, K)), td.split_probe(rng, (N, K))
    else:
        a, b = _fp32(rng, (M, K)), _fp32(rng, (N, K))
    exact = a.double() @ b.double().T
    assert _rel(pj.gemm_plain(a, b), exact) <= PLAIN_FP64
    if probe:
        assert _rel(_three_products(a, b), exact) > 10 * PLAIN_FP64


# -- the autograd ops on the plain path ---------------------------------------

def _layer(rng, L, F, H, D):
    ws = [_fp32(rng, (H, F, D)).requires_grad_() for _ in range(3)]
    w_o = _fp32(rng, (H * D, F)).requires_grad_()
    return ws, w_o


def _qkv_fp64(x, ws):
    H, _, D = ws[0].shape
    L = x.shape[0]
    q, k, v = (torch.einsum("lf,hfd->hld", x, w) for w in ws)
    pad = (0, 0, 0, 1)
    return (torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
            v.reshape(H * L, D))


@pytest.mark.parametrize("need_x", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("op", ["qkv", "out"])
def test_grads_match_fp64_autograd(op, need_x):
    """Every gradient of a weighted sum of the op's outputs against fp64
    autograd of the same function; with the input's gradient not needed
    (the first layer's input is data), the weights' are still right."""
    rng = np.random.default_rng(3)
    L, F, H, D = 37, 24, 2, 16
    ws, w_o = _layer(rng, L, F, H, D)
    if op == "qkv":
        x = _fp32(rng, (L, F)).requires_grad_(need_x)
        params = [x, *ws] if need_x else ws
        outs = pj.qkv_project(x, *ws)
        gs = [_fp32(rng, o.shape) for o in outs]
        torch.autograd.backward(outs, gs)
        x64 = x.detach().double().requires_grad_(need_x)
        w64 = [w.detach().double().requires_grad_() for w in ws]
        want = _qkv_fp64(x64, w64)
        torch.autograd.backward(want, [g.double() for g in gs])
        ref = [x64, *w64] if need_x else w64
    else:
        heads = _fp32(rng, (H, L, D)).requires_grad_(need_x)
        params = [heads, w_o] if need_x else [w_o]
        out = pj.out_project(heads, w_o)
        g = _fp32(rng, out.shape)
        out.backward(g)
        h64 = heads.detach().double().requires_grad_(need_x)
        wo64 = w_o.detach().double().requires_grad_()
        want = h64.permute(1, 0, 2).reshape(L, H * D) @ wo64
        want.backward(g.double())
        ref = [h64, wo64] if need_x else [wo64]
    if not need_x:
        assert (x if op == "qkv" else heads).grad is None
    for p, r in zip(params, ref):
        assert p.grad.shape == r.grad.shape
        assert _rel(p.grad, r.grad) <= GRAD_FP64


def test_fused_layouts():
    """q_pad and k_pad are (H, L+1, D) with row L exactly 0, v is (H*L, D);
    the output projection reads heads (H, L, D) as the (L, H*D) matrix of
    its rows head by head, with no copy handed in."""
    rng = np.random.default_rng(4)
    L, F, H, D = 33, 16, 3, 8
    ws, w_o = _layer(rng, L, F, H, D)
    x = _fp32(rng, (L, F))
    q_pad, k_pad, v = pj.qkv_project(x, *ws)
    assert q_pad.shape == k_pad.shape == (H, L + 1, D)
    assert v.shape == (H * L, D) and v.is_contiguous()
    assert torch.equal(q_pad[:, L], torch.zeros(H, D))
    assert torch.equal(k_pad[:, L], torch.zeros(H, D))
    for got, want in zip((q_pad, k_pad, v), _qkv_fp64(x.double(),
                                                      [w.double()
                                                       for w in ws])):
        assert _rel(got, want) <= PLAIN_FP64
    heads = _fp32(rng, (H * L, D))
    out = pj.out_project(heads.view(H, L, D), w_o)
    want = (heads.double().view(H, L, D).transpose(0, 1).reshape(L, H * D)
            @ w_o.double())
    assert out.shape == (L, F)
    assert _rel(out, want) <= PLAIN_FP64


# -- the kernel path, emulated -------------------------------------------------

def _mem(ptr, n, dtype):
    """n elements of ``dtype`` at host address ``ptr``, shared."""
    ctype = ctypes.c_float if dtype == torch.float32 else ctypes.c_int16
    buf = (ctype * n).from_address(ptr)
    t = torch.frombuffer(buf, dtype=torch.float32 if dtype == torch.float32
                         else torch.int16)
    return t if dtype == torch.float32 else t.view(torch.bfloat16)


def _view(ptr, dtype, shape, strides):
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    return _mem(ptr, extent, dtype).as_strided(shape, strides)


def _operand(ptr, rows, K):
    """An operand's planes, in BK-deep k chunks, as 3 (rows, K) bf16."""
    v = _view(ptr, torch.bfloat16, (3, K // pj.BK, rows, pj.BK),
              (rows * K, rows * pj.BK, pj.BK, 1))
    return [v[p].permute(1, 0, 2).reshape(rows, K) for p in range(3)]


def _word_float(w):
    return struct.unpack("<f", struct.pack("<I", w & 0xffffffff))[0]


def _write(out, c):
    """C (M, N) into the layout ``out`` (20 words: per part its base,
    head stride, row stride, end column, chunk and scale, then the
    sentinel row and mask)."""
    bases, s_h, s_r = out[0:3], out[3:6], out[6:9]
    ends, chunks = out[9:12], out[12:15]
    scales = [_word_float(w) for w in out[15:18]]
    sent_row, sent_mask = out[18:20]
    M, N = c.shape
    n = torch.arange(N)
    p = torch.bucketize(n, torch.tensor(ends), right=True)
    start = torch.tensor([0] + ends[:2])[p]
    nn = n - start
    chunk = torch.tensor(chunks)[p]
    col = (nn // chunk) * torch.tensor(s_h)[p] + nn % chunk
    for part in range(3):
        cols = (p == part).nonzero().flatten()
        if cols.numel() == 0:
            continue
        vals = c[:, cols] * scales[part] if scales[part] != 1.0 else \
            c[:, cols]
        rows = [(torch.arange(M), vals)]
        if sent_row >= 0 and sent_mask >> part & 1:
            rows.append((torch.tensor([sent_row]), torch.zeros(1, len(cols))))
        for r, v in rows:
            off = r[:, None] * s_r[part] + col[cols][None]
            mem = _mem(bases[part], int(off.max()) + 1, torch.float32)
            mem[off.flatten()] = v.flatten()


class Emulator:
    """The two C entry points of ``csrc/proj_gemm.cu`` on host memory."""

    def __init__(self):
        self.launches = collections.Counter()
        self.splits = []

    def __call__(self, name, *args):
        self.launches[name] += 1
        getattr(self, name.removeprefix("sddmm_proj_"))(*args)

    @staticmethod
    def _words(ptr, n):
        return [int(w) for w in (ctypes.c_longlong * n).from_address(ptr)]

    def split(self, ptr, njobs, stream):
        assert 0 < njobs <= pj.MAX_SPLIT_JOBS
        for j in range(njobs):
            w = self._words(ptr + 8 * 23 * j, 23)
            nb, nr, nc = w[1:4]
            src = _view(w[0], torch.float32, (nb, nr, nc), (w[4], w[5], 1))
            scale = _word_float(w[22])
            if scale != 1.0:
                src = src * scale
            planes = torch.stack(td.split_bf16(src, 3))
            b, r, c = torch.meshgrid(torch.arange(nb), torch.arange(nr),
                                     torch.arange(nc), indexing="ij")
            dsts = [w[6:14], w[14:22]]
            assert dsts[0][0] != 0
            for dst, R, row0, k0, row_b, k_b, trans, plane in dsts:
                if dst == 0:
                    continue
                assert k0 % 4 == 0 and k_b % 4 == 0
                row = row0 + b * row_b + (c if trans else r)
                k = k0 + b * k_b + (r if trans else c)
                off = ((k // pj.BK) * R + row) * pj.BK + k % pj.BK
                mem = _mem(dst, 3 * plane, torch.bfloat16)
                assert int(off.max()) < plane
                for q in range(3):
                    mem[q * plane + off.flatten()] = planes[q].flatten()

    def gemm(self, ptr, stream):
        desc = self._words(ptr, 32)
        M, N, K, S = desc[:4]
        assert desc[6] == desc[9] == K and K % pj.BK == 0
        a, b = _operand(*desc[4:7]), _operand(*desc[7:10])
        out = desc[10:30]
        assert (S > 1) == (desc[30] != 0) == (desc[31] != 0)
        assert S == 1 or (N % 4 == 0 and desc[28] < 0)
        self.splits.append(S)
        nkb = K // pj.BK
        c = None
        for s in range(S):   # each split's partial, added in split order
            k0, k1 = s * nkb // S * pj.BK, (s + 1) * nkb // S * pj.BK
            part = None
            with td.full_fp32_matmul():
                for i, j in pj.PRODUCTS:
                    d = (a[i][:M, k0:k1].float()
                         @ b[j][:N, k0:k1].float().T)
                    part = d if part is None else part + d
            c = part if c is None else c + part
        _write(out, c)


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors take the kernel path, its launches run by the Emulator
    (as on a card of 132 SMs)."""
    emu = Emulator()
    monkeypatch.setattr(_kernels, "launch", emu)
    monkeypatch.setattr(pj, "_kernel_path", lambda t, plain: not plain)
    monkeypatch.setattr(pj, "_card", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(pj, "_stream", lambda device: 0)
    monkeypatch.setattr(pj, "_sms", lambda index: 132)
    return emu


def _run(op, inputs, plain, grads):
    """The op's outputs and its inputs' gradients under the cotangents."""
    leaves = [t.detach().clone().requires_grad_(t.requires_grad)
              for t in inputs]
    fn = pj.qkv_project if op == "qkv" else pj.out_project
    outs = fn(*leaves, plain=plain)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, grads)
    return [o.detach() for o in outs], [t.grad for t in leaves]


# (L, F, H, D): off the kernel's 32-wide k step (padded, zeroed planes); on
# it with a split K (few tiles, L deep); and short sequences of wide layers
# (12 heads of 64, 4 heads of 64), whose Q, K, V product the cost model
# would split (test_split_k_choice) but which only the unsplit epilogue
# gives its sentinel rows
SHAPES = [(37, 24, 2, 16), (40, 20, 3, 8), (256, 64, 2, 32),
          (256, 768, 12, 64), (128, 256, 4, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("op", ["qkv", "out"])
def test_kernel_path_matches_plain(op, shape, emulated):
    """The kernel path's launches (emulated) give the plain version's
    outputs and gradients: the split jobs, the operands' tensor-map words,
    the padded chunks, C's layouts with the sentinel rows, and a split K
    with its workspace and counters all land where the plain version puts
    them; the forward's Q, K, V product, which writes the sentinel rows,
    runs unsplit."""
    L, F, H, D = shape
    rng = np.random.default_rng(L)
    ws, w_o = _layer(rng, L, F, H, D)
    if op == "qkv":
        inputs = [_fp32(rng, (L, F)).requires_grad_(), *ws]
        shapes = [(H, L + 1, D), (H, L + 1, D), (H * L, D)]
    else:
        inputs = [_fp32(rng, (H, L, D)).requires_grad_(), w_o]
        shapes = [(L, F)]
    grads = [_fp32(rng, s) for s in shapes]
    if op == "qkv":   # autograd hands the sentinel row whatever flowed there
        grads[0][:, L] = 5.0
    want = _run(op, inputs, True, grads)
    assert not emulated.launches
    got = _run(op, inputs, False, grads)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.shape == w.shape
        assert torch.allclose(g, w, rtol=1e-6, atol=1e-6 * float(
            w.abs().max())), _rel(g, w.double())
    if op == "qkv":
        assert torch.equal(got[0][0][:, L], torch.zeros(H, D))
    split = emulated.launches[_kernels.PROJ_SPLIT_ENTRY]
    gemm = emulated.launches[_kernels.PROJ_GEMM_ENTRY]
    assert (split, gemm) == (2, 3)   # forward 1 + 1, backward 1 + 2
    if op == "qkv":
        assert emulated.splits[0] == 1
    if shape == (256, 64, 2, 32):   # one tile over 8 k slices: the weights'
        assert 2 in emulated.splits  # K split in two


def test_first_layer_launches_no_input_gradient(emulated):
    """An input that needs no gradient (the first layer's data): the
    backward splits no cotangent in the dX layout and launches only the
    weights' product."""
    rng = np.random.default_rng(9)
    L, F, H, D = 64, 32, 2, 32
    ws, _ = _layer(rng, L, F, H, D)
    x = _fp32(rng, (L, F))
    outs = pj.qkv_project(x, *ws)
    before = emulated.launches[_kernels.PROJ_GEMM_ENTRY]
    torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
    assert emulated.launches[_kernels.PROJ_GEMM_ENTRY] - before == 1
    assert all(w.grad is not None for w in ws)


@pytest.mark.parametrize("M,N,nkb,want", [
    (4096, 2304, 24, 1),      # Q, K, V: 384 tiles
    (4096, 768, 72, 1),       # dX of Q, K, V: 128 tiles, 0.97 wave
    (768, 2304, 128, 3),      # dW of Q, K, V: 72 tiles over K = 4096
    (768, 768, 128, 5),       # dW of the output projection: 24 tiles
    (64, 64, 2, 1),           # too shallow to split
    (256, 2304, 24, 2),       # Q, K, V of 256 tokens, 12 heads of 64: 24
    (128, 768, 8, 2),         # and 4 tiles (run unsplit: sentinel rows)
])
def test_split_k_choice(M, N, nkb, want):
    """The split of K the cost model picks at the layer's shapes on the
    H100's 132 SMs."""
    assert pj.splits(M, N, nkb, 132) == want
