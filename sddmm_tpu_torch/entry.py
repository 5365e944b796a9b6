"""The port's flagship entry point, counterpart of ``__graft_entry__.entry``:
the forward of dot-product graph attention, whose score computation is the
hybrid BSMR SDDMM.

    from sddmm_tpu_torch.entry import entry
    fn, args = entry("cuda")
    out = fn(*args)            # (128, 32), under torch.inference_mode()

``fn.layer`` is the ``GraphAttentionLayer`` it runs.
"""

from __future__ import annotations

import torch

from sddmm_tpu_torch.data import generate
from sddmm_tpu_torch.models.graph_attention import GraphAttentionLayer


def entry(device="cuda"):
    """(fn, args): the serving forward of graph attention on the entry
    graph (``block_clustered(8, 8, 0.25, seed=5)``, 128 nodes, F = D = 32),
    weights drawn from ``torch.Generator`` seed 0, x = ``make_dense(128, 32,
    seed=1)``; all on ``device``."""
    adj = generate.block_clustered(8, 8, block_prob=0.25, seed=5)
    layer = GraphAttentionLayer(adj, feature_dim=32, head_dim=32,
                                device=device)
    layer.init(torch.Generator().manual_seed(0))
    x = torch.as_tensor(generate.make_dense(adj.m, 32, seed=1),
                        device=layer.device)

    def fn(x):
        with torch.inference_mode():
            return layer(x)

    fn.layer = layer
    return fn, (x,)
