"""The plain reference: what each cell's program must compute, in plain
PyTorch, from the inputs the benchmark made and nothing the program made.

``precision`` picks the arithmetic: ``"exact"`` is float64 throughout,
the reference proper; ``"tf32"`` and ``"bfloat16"`` round every product's
operands to that format and add in float32 (the tensor cores' arithmetic,
emulated so that it reads the same on any device and never depends on
``allow_tf32``): the controls, which a sound limit must fail.  TF32 stays
off for every float32 matmul here.
"""

from __future__ import annotations

import torch

from perfbench.patterns import Pattern

#: entries of the SDDMM reference per block (two (block, K) gathers live)
SDDMM_BLOCK = 1 << 18


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "exact":
        return x.double()
    x = x.float()
    if precision == "tf32":
        return round_tf32(x)
    if precision == "bfloat16":
        return x.bfloat16().float()
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatMul(torch.autograd.Function):
    """a @ b with both operands rounded, and the backward's two products
    rounded alike."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _rounded(a, precision) @ _rounded(b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        g = _rounded(g, p)
        return (g @ _rounded(b, p).transpose(-1, -2),
                _rounded(a, p).transpose(-1, -2) @ g, None)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "exact":
        return a.double() @ b.double()
    return _RoundedMatMul.apply(a, b, precision)


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "exact" else torch.float32


def sddmm(pattern: Pattern, a: torch.Tensor, bt: torch.Tensor,
          precision: str = "exact") -> torch.Tensor:
    """(nnz,) values A[row e] . B^T[col e] in CSR entry order, for A (m, K)
    and B^T (n, K) on any device, in blocks of entries."""
    dev = a.device
    rows = torch.as_tensor(pattern.row_idx(), device=dev)
    cols = torch.as_tensor(pattern.col_idx, device=dev).long()
    a, bt = _rounded(a[:pattern.m], precision), \
        _rounded(bt[:pattern.n], precision)
    out = torch.empty(pattern.nnz, dtype=dtype_of(precision), device=dev)
    for s in range(0, pattern.nnz, SDDMM_BLOCK):
        e = slice(s, s + SDDMM_BLOCK)
        out[e] = (a[rows[e]] * bt[cols[e]]).sum(-1)
    return out


def dense_mask(pattern: Pattern, device) -> torch.Tensor:
    mask = torch.zeros((pattern.m, pattern.n), dtype=torch.bool,
                       device=device)
    mask[torch.as_tensor(pattern.row_idx(), device=device),
         torch.as_tensor(pattern.col_idx, device=device).long()] = True
    return mask


def attention(weights, x: torch.Tensor, mask: torch.Tensor,
              precision: str = "exact") -> torch.Tensor:
    """Multi-head self-attention restricted to ``mask`` (L, L), one head at
    a time: weights ``(w_q, w_k, w_v, w_o)`` of shapes (H, F, D) x 3 and
    (H*D, F), x (L, F) -> (L, F).  Differentiable in every input."""
    w_q, w_k, w_v, w_o = weights
    dt = dtype_of(precision)
    x = x.to(dt)
    scale = w_q.shape[-1] ** -0.5
    heads = []
    for h in range(w_q.shape[0]):
        q = matmul(x, w_q[h].to(dt), precision)
        k = matmul(x, w_k[h].to(dt), precision)
        v = matmul(x, w_v[h].to(dt), precision)
        s = matmul(q, k.T, precision) * scale
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=1)
        heads.append(matmul(p, v, precision))
    return matmul(torch.cat(heads, dim=1), w_o.to(dt), precision)


def stack(weights, x: torch.Tensor, mask: torch.Tensor,
          precision: str = "exact") -> torch.Tensor:
    """Layers of ``attention`` with residual connections: x + attention(x)
    for each layer's ``(w_q, w_k, w_v, w_o)`` in ``weights``."""
    x = x.to(dtype_of(precision))
    for ws in weights:
        x = x + attention(ws, x, mask, precision)
    return x


def mse(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((out - y.to(out.dtype)) ** 2).mean()


def _batch_grads(params, batch, mask, precision):
    """The mean over ``batch`` [(x, y), ...] of mse(stack(x), y), and its
    gradient in every weight.  Each sequence's layer inputs are kept from
    a forward without autograd; the backward recomputes one layer at a
    time from its input, so that one layer's graph is alive at once."""
    dt = dtype_of(precision)
    grads = [[torch.zeros_like(w) for w in ws] for ws in params]
    loss = 0.0
    for x, y in batch:
        with torch.no_grad():
            xs = [x.to(dt)]
            for ws in params:
                xs.append(xs[-1] + attention(ws, xs[-1], mask, precision))
            out = xs[-1]
            loss += float(mse(out, y))
            g = 2 * (out - y.to(dt)) / (out.numel() * len(batch))
        for layer in reversed(range(len(params))):
            ws = params[layer]
            x_in = xs[layer].requires_grad_(layer > 0)
            out = x_in + attention(ws, x_in, mask, precision)
            wanted = [x_in, *ws] if layer > 0 else list(ws)
            got = torch.autograd.grad(out, wanted, g)
            if layer > 0:
                g, got = got[0], got[1:]
            for acc, gw in zip(grads[layer], got):
                acc.add_(gw)
            xs[layer + 1] = None
    return loss / len(batch), grads


def train(weights, batches, mask: torch.Tensor, lr: float,
          betas=(0.9, 0.999), eps: float = 1e-8,
          precision: str = "exact"):
    """Adam steps of the mean mse(stack(x), y) over each batch of
    ``batches`` [[(x, y), ...], ...] from ``weights`` (one ``(w_q, w_k,
    w_v, w_o)`` a layer): (losses, the first step's gradients, the weights
    after the last step), each weight list flat, layer by layer, in the
    reference's dtype."""
    dt = dtype_of(precision)
    params = [[w.detach().to(dt).clone().requires_grad_(True) for w in ws]
              for ws in weights]
    flat = [w for ws in params for w in ws]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    b1, b2 = betas
    losses, first_grads = [], None
    for t, batch in enumerate(batches, start=1):
        loss, grads = _batch_grads(params, batch, mask, precision)
        grads = [g for gs in grads for g in gs]
        losses.append(loss)
        if first_grads is None:
            first_grads = [g.clone() for g in grads]
        with torch.no_grad():
            for p, g, mi, vi in zip(flat, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = mi / (1 - b1 ** t)
                v_hat = vi / (1 - b2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
    return losses, first_grads, [p.detach() for p in flat]
