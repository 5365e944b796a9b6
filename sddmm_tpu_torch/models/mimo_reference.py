"""A plain reference of MiMo-V2-Flash's attention stack, in float64: dense
masks, one head at a time, loss and gradients by autograd.  It imports only
torch and numpy (no kernel of the port, no JAX), so that the port's
``HybridAttentionStack`` is held to something written apart from it.

The layer (MiMo-V2-Flash's ``config.json``,
https://huggingface.co/XiaomiMiMo/MiMo-V2-Flash/blob/main/config.json), for
H query heads over Hkv key/value heads (G = H / Hkv), on x (L, F):

    q_h = x W_q[h]          k_g = x W_k[g]          v_g = s_v * x W_v[g]
    q_h, k_g <- RoPE_theta on dims [0, R): pairs (d, d + R/2), angle
                i * theta^(-2d/R) at position i; dims [R, D) unchanged
    s_hij = q_hi . k_{h//G, j} / sqrt(D),   j <= i, and i - W < j in a
                                            sliding-window layer
    p_hij = exp(s_hij - m_hi)
            / (sum_j exp(s_hij - m_hi) + [sink] exp(b_h - m_hi))
    o_hi  = sum_j p_hij v_{h//G, j}        out = x + concat_h(o_h) W_o

Departures from the published model, and readings of it:
- attention layers with their residuals only: the MoE and dense MLPs, the
  RMSNorms, the embeddings and the MTP heads are left out;
- float64 arithmetic (the published model trains in bf16 and FP8);
- the window is i - j < W; query head h reads key/value head h // G; the
  rotary dims are the first R, in the "rotate half" order;
  ``attention_value_scale`` multiplies V (linear, so the same as scaling
  the heads' output before the output projection);
- ``attention_chunk_size`` is not read.
"""

from __future__ import annotations

import numpy as np
import torch


def rope(x: torch.Tensor, rotary: int, theta: float) -> torch.Tensor:
    """x (L, D) with dims [0, rotary) rotated at positions 0..L-1."""
    L = x.shape[0]
    half = rotary // 2
    inv = theta ** (-2.0 * torch.arange(half, dtype=torch.float64,
                                        device=x.device) / rotary)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv
    c, s = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    a, b = x[:, :half], x[:, half:rotary]
    return torch.cat([a * c - b * s, b * c + a * s, x[:, rotary:]], dim=1)


def dense_mask(L: int, window, device) -> torch.Tensor:
    """(L, L) bool: j <= i, and i - j < window unless window is None."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    keep = j <= i
    if window is not None:
        keep &= (i - j) < window
    return keep


def attention(x: torch.Tensor, w: dict, kind: dict, cfg: dict) -> torch.Tensor:
    """One layer's attention output (L, F), without the residual.  ``w``:
    w_q (H, F, D), w_k (Hkv, F, D), w_v (Hkv, F, Dv), w_o (H*Dv, F), sink
    (H,) or absent; ``kind``: kv_heads, rope_theta, window, sink;
    ``cfg``: rotary_dim, value_scale."""
    H, _, D = w["w_q"].shape
    G = H // kind["kv_heads"]
    L = x.shape[0]
    mask = dense_mask(L, kind["window"], x.device)
    R, theta = cfg["rotary_dim"], kind["rope_theta"]
    ks = [rope(x @ w["w_k"][g], R, theta) for g in range(kind["kv_heads"])]
    vs = [cfg["value_scale"] * (x @ w["w_v"][g])
          for g in range(kind["kv_heads"])]
    heads = []
    for h in range(H):
        q = rope(x @ w["w_q"][h], R, theta)
        s = (q @ ks[h // G].T) / np.sqrt(D)
        s = s.masked_fill(~mask, -torch.inf)
        m = s.max(dim=1, keepdim=True).values
        if kind["sink"]:
            b = w["sink"][h]
            m = torch.maximum(m, b.detach())
            e = torch.exp(s - m)
            z = e.sum(dim=1, keepdim=True) + torch.exp(b - m)
        else:
            e = torch.exp(s - m)
            z = e.sum(dim=1, keepdim=True)
        heads.append((e / z) @ vs[h // G])
    return torch.cat(heads, dim=1) @ w["w_o"]


def forward(x: torch.Tensor, layers: list, kinds: list,
            cfg: dict) -> torch.Tensor:
    """The stack: x + attention(x), layer by layer (``layers[i]`` the
    weights of a layer of kind ``kinds[i]``)."""
    for w, kind in zip(layers, kinds):
        x = x + attention(x, w, kind, cfg)
    return x


def loss_and_grads(xs, ys, layers: list, kinds: list, cfg: dict):
    """The mean over the batch of mean((out - y)^2) in float64 and the
    gradients of every weight (a list of dicts, as ``layers``) and of every
    x, by autograd."""
    ws = [{k: v.detach().to(torch.float64).requires_grad_()
           for k, v in w.items()} for w in layers]
    xs = [x.detach().to(torch.float64).requires_grad_() for x in xs]
    loss = sum(((forward(x, ws, kinds, cfg) - y.to(torch.float64)) ** 2)
               .mean() for x, y in zip(xs, ys)) / len(xs)
    loss.backward()
    return (loss.detach(), [{k: v.grad for k, v in w.items()} for w in ws],
            [x.grad for x in xs])
