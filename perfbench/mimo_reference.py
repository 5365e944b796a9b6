"""The plain reference of the MiMo-V2-Flash cells: the stack of attention
layers with residuals, in plain PyTorch, from the weights and sequences the
benchmark made and nothing the program made (the benchmark's own copy of
``sddmm_tpu_torch/models/mimo_reference.py``, which a CPU test holds it
equal to).

For H query heads over Hkv key/value heads (G = H / Hkv), on x (L, F):

    q_h = x W_q[h]          k_g = x W_k[g]          v_g = s_v * x W_v[g]
    q_h, k_g <- RoPE_theta on dims [0, R), pairs (d, d + R/2), angle
                i * theta^(-2d/R) at position i
    s_hij = q_hi . k_{h//G, j} / sqrt(D),   j <= i (and i - W < j)
    p_hij = exp(s_hij - m_hi)
            / (sum_j exp(s_hij - m_hi) + [sink] exp(b_h - m_hi))
    out   = x + concat_h(p_h v_{h//G}) W_o

``precision`` picks the products' arithmetic as ``perfbench.reference``
does: ``"exact"`` float64, the reference proper; ``"tf32"`` and
``"bfloat16"`` the controls.  The training reference keeps each layer's
input from a forward without autograd and recomputes one head at a time
in the backward (a head's part of a layer's output is linear in the
upstream gradient), so that one head's dense (L, L) scores are alive at
once.
"""

from __future__ import annotations

import torch

from perfbench.reference import dtype_of, matmul

#: the weights of a layer, in the program's order (``sink`` in layers of a
#: kind that has one)
NAMES = ("w_q", "w_k", "w_v", "w_o", "sink")


def rope(x: torch.Tensor, rotary: int, theta: float) -> torch.Tensor:
    """x (L, D) with dims [0, rotary) rotated at positions 0..L-1; the
    angles in float64."""
    L, half = x.shape[0], rotary // 2
    inv = theta ** (-2.0 * torch.arange(half, dtype=torch.float64,
                                        device=x.device) / rotary)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv
    c, s = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    a, b = x[:, :half], x[:, half:rotary]
    return torch.cat([a * c - b * s, b * c + a * s, x[:, rotary:]], dim=1)


def causal(L: int, window, device) -> torch.Tensor:
    """(L, L) bool: j <= i, and i - j < window unless window is None."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    keep = j <= i
    if window is not None:
        keep &= (i - j) < window
    return keep


def head(x, w, kind, cfg, mask, h, precision):
    """Head h's part of the layer's output, (L, F)."""
    dt = dtype_of(precision)
    H, _, D = w["w_q"].shape
    g = h // (H // kind["kv_heads"])
    Dv = w["w_v"].shape[2]
    R, theta = cfg["rotary_dim"], kind["rope_theta"]
    q = rope(matmul(x, w["w_q"][h].to(dt), precision), R, theta)
    k = rope(matmul(x, w["w_k"][g].to(dt), precision), R, theta)
    v = cfg["value_scale"] * matmul(x, w["w_v"][g].to(dt), precision)
    s = matmul(q, k.T, precision) * D ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    m = s.max(dim=1, keepdim=True).values
    if kind["sink"]:
        b = w["sink"][h].to(dt)
        m = torch.maximum(m, b.detach())
        e = torch.exp(s - m)
        p = e / (e.sum(dim=1, keepdim=True) + torch.exp(b - m))
    else:
        e = torch.exp(s - m)
        p = e / e.sum(dim=1, keepdim=True)
    o = matmul(p, v, precision)
    return matmul(o, w["w_o"][h * Dv:(h + 1) * Dv].to(dt), precision)


def layer(x, w, kind, cfg, mask, precision="exact"):
    """x + the layer's attention, x (L, F) in the precision's dtype."""
    out = x
    for h in range(w["w_q"].shape[0]):
        out = out + head(x, w, kind, cfg, mask, h, precision)
    return out


def stack(layers, kinds, cfg, x, precision="exact"):
    """The stack's output for x (L, F): ``layers[i]`` the weights (a dict)
    of a layer of kind ``kinds[i]`` (a dict: kv_heads, rope_theta, window,
    sink); ``cfg``: rotary_dim, value_scale."""
    x = x.to(dtype_of(precision))
    masks = {}
    for w, kind in zip(layers, kinds):
        key = kind["window"]
        if key not in masks:
            masks[key] = causal(x.shape[0], key, x.device)
        x = layer(x, w, kind, cfg, masks[key], precision)
    return x


def _batch_grads(params, kinds, cfg, batch, precision):
    """The mean over ``batch`` [(x, y), ...] of mean((stack(x) - y)^2) and
    its gradient in every weight (a dict a layer)."""
    dt = dtype_of(precision)
    grads = [{n: torch.zeros_like(t) for n, t in w.items()} for w in params]
    masks = {}
    loss = 0.0
    for x, y in batch:
        L = x.shape[0]
        for kind in kinds:
            if kind["window"] not in masks:
                masks[kind["window"]] = causal(L, kind["window"], x.device)
        with torch.no_grad():
            xs = [x.to(dt)]
            for w, kind in zip(params, kinds):
                xs.append(layer(xs[-1], w, kind, cfg, masks[kind["window"]],
                                precision))
            out = xs[-1]
            loss += float(((out - y.to(dt)) ** 2).mean())
            g = 2 * (out - y.to(dt)) / (out.numel() * len(batch))
        for i in reversed(range(len(params))):
            w, kind = params[i], kinds[i]
            mask = masks[kind["window"]]
            x_in = xs[i].detach().requires_grad_(i > 0)
            g_in = g.clone() if i > 0 else None
            names = list(w)
            for h in range(w["w_q"].shape[0]):
                out = head(x_in, w, kind, cfg, mask, h, precision)
                wanted = ([x_in] if i > 0 else []) + [w[n] for n in names]
                got = torch.autograd.grad(out, wanted, g, allow_unused=True)
                if i > 0:
                    g_in.add_(got[0])
                    got = got[1:]
                for n, gw in zip(names, got):
                    if gw is not None:
                        grads[i][n].add_(gw)
            g = g_in
            xs[i + 1] = None
    return loss / len(batch), grads


def train(weights, kinds, cfg, batches, lr: float, betas=(0.9, 0.999),
          eps: float = 1e-8, precision: str = "exact"):
    """Adam steps of the batch's mean loss from ``weights`` (a dict a
    layer): (losses, the first step's gradients, the weights after the
    last step), the weight lists flat, layer by layer in ``NAMES`` order."""
    dt = dtype_of(precision)
    params = [{n: w[n].detach().to(dt).clone().requires_grad_(True)
               for n in NAMES if n in w} for w in weights]
    flat = [w[n] for w in params for n in NAMES if n in w]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    b1, b2 = betas
    losses, first_grads = [], None
    for t, batch in enumerate(batches, start=1):
        loss, grads = _batch_grads(params, kinds, cfg, batch, precision)
        grads = [g[n] for g in grads for n in NAMES if n in g]
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
