"""Widths, weights and sequences of the attention cells; the weights and
sequences are made on the device from the run's seed in one draw each."""

from __future__ import annotations

import torch


def dims(config: dict) -> dict:
    """The stack's widths and depth from a model configuration."""
    heads = config["num_attention_heads"]
    return {"hidden": config["hidden_size"], "heads": heads,
            "head_dim": config["hidden_size"] // heads,
            "layers": config["num_hidden_layers"]}


def weights(dims: dict, gen: torch.Generator, device) -> list:
    """One ``(w_q, w_k, w_v, w_o)`` a layer, normal draws scaled by
    1/sqrt(fan-in): (H, F, D) x 3 and (H*D, F)."""
    f, h, d = dims["hidden"], dims["heads"], dims["head_dim"]
    flat = torch.randn(dims["layers"] * 4 * f * h * d, generator=gen,
                       device=device)
    s_in, s_out = f ** -0.5, (h * d) ** -0.5
    out = []
    for layer in flat.split(4 * f * h * d):
        w_q, w_k, w_v, w_o = layer.split(f * h * d)
        out.append((w_q.view(h, f, d) * s_in, w_k.view(h, f, d) * s_in,
                    w_v.view(h, f, d) * s_in, w_o.view(h * d, f) * s_out))
    return out


def sequences(pool: int, seq_len: int, hidden: int, gen: torch.Generator,
              device) -> torch.Tensor:
    """(pool, L, F) standard normal rows."""
    return torch.randn((pool, seq_len, hidden), generator=gen,
                       device=device)
