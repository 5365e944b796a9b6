"""The program under test for MiMo-V2-Flash cells: the port's
``models.HybridAttentionStack`` over the configuration's layer pattern
(``hybrid_layer_pattern``: 0 a full-attention layer, 1 a sliding-window
layer), at the published widths, in the configuration's compute mode.
Nothing here computes: the stack packs each kind's mask once and runs
every layer, x + attention(x), on the port's kernels.

``pattern`` is the full layers' causal mask (the larger of the two), which
the loop reads the sequence length from."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import patterns

#: a layer's weights, in ``parameters()``' order (``sink`` only where the
#: layer's kind has one)
NAMES = ("w_q", "w_k", "w_v", "w_o", "sink")


def dims(config: dict) -> dict:
    """The stack's widths, depth and kinds of layer from a configuration."""
    pattern = config["hybrid_layer_pattern"][:config["num_hidden_layers"]]
    window = int(config["sliding_window"])
    kinds = {
        "full": {"kv_heads": config["num_key_value_heads"],
                 "rope_theta": float(config["rope_theta"]),
                 "sink": bool(config["add_full_attention_sink_bias"]),
                 "window": None},
        "window": {"kv_heads": config["swa_num_key_value_heads"],
                   "rope_theta": float(config["swa_rope_theta"]),
                   "sink": bool(config["add_swa_attention_sink_bias"]),
                   "window": window}}
    return {"hidden": config["hidden_size"],
            "heads": config["num_attention_heads"],
            "head_dim": config["head_dim"],
            "v_head_dim": config["v_head_dim"],
            "rotary_dim": int(config["partial_rotary_factor"]
                              * config["head_dim"]),
            "value_scale": float(config["attention_value_scale"]),
            "layers": len(pattern),
            "layer_types": ["window" if t else "full" for t in pattern],
            "kinds": kinds}


def pattern(config: dict, traffic: dict) -> patterns.Pattern:
    """The causal mask of ``seq_len`` positions (row i: columns 0..i)."""
    L = int(traffic["seq_len"])
    counts = np.arange(1, L + 1, dtype=np.int64)
    row_ptr = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    cols = (np.arange(row_ptr[-1], dtype=np.int64)
            - np.repeat(row_ptr[:-1], counts)).astype(np.int32)
    return patterns.Pattern(L, L, row_ptr, cols)


class System:
    def __init__(self, model, info: dict):
        self.model = model
        self.info = info
        self.mode = next(iter(model.cores.values())).runner.compute_dtype

    def load_weights(self, weights) -> None:
        """One dict a layer, ``NAMES`` -> tensor, in the layer's shapes."""
        with torch.no_grad():
            for layer, ws in zip(self.model.layers, weights):
                for name, w in ws.items():
                    getattr(layer, name).copy_(w)

    def parameters(self):
        """The trained weights, layer by layer in ``NAMES`` order."""
        return [getattr(layer, n) for layer in self.model.layers
                for n in NAMES if getattr(layer, n, None) is not None]

    def forward(self, x):
        return self.model(x)


def build(config: dict, traffic: dict, pat: patterns.Pattern,
          device) -> System:
    from sddmm_tpu_torch.models import AttentionKind, HybridAttentionStack

    d = dims(config)
    kinds = [AttentionKind(name, k["kv_heads"], k["rope_theta"], k["sink"],
                           k["window"]) for name, k in d["kinds"].items()]
    model = HybridAttentionStack(
        pat.m, d["layer_types"], kinds, d["hidden"], d["heads"],
        d["head_dim"], d["v_head_dim"], d["rotary_dim"], d["value_scale"],
        alpha=config["port"]["alpha"], delta=config["port"]["delta"],
        compute_dtype=config["compute_mode"], device=device)
    info = {"layers": d["layer_types"]}
    for name, core in model.cores.items():
        p = core.runner.packed
        info[name] = {"mask_nnz": core.nnz,
                      "packed_slots": int(p.packed_size),
                      "residual": int(p.nnz_res)}
    return System(model, info)
