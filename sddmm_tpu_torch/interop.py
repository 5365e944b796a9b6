"""Carry state across from the JAX package.

The SDDMM's state is the ``PackedMatrix`` and the dense operands; the
attention models add their weights, the factorization model its factors.  With these helpers a test packs once
in ``sddmm_tpu`` (or initialises a JAX model) and runs both packages on the
identical layout, weights and inputs.  Nothing here imports ``sddmm_tpu``
(that would load jax): the JAX package's objects are read by duck typing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sddmm_tpu_torch.reorder.pack import PackedMatrix


def packed_from_reference(p) -> PackedMatrix:
    """The JAX package's ``PackedMatrix`` -> the port's, field by field.

    numpy fields are copied; tuples (the bucket lists) and scalars are
    taken as they are.  A field the port's class lacks, or one it has that
    ``p`` lacks, raises: the two dataclasses must stay in step."""
    names = [f.name for f in dataclasses.fields(PackedMatrix)]
    theirs = set(vars(p))
    if set(names) != theirs:
        raise ValueError("PackedMatrix fields differ: only in the port "
                         f"{sorted(set(names) - theirs)}, only in the "
                         f"reference {sorted(theirs - set(names))}")
    kw = {}
    for name in names:
        v = getattr(p, name)
        kw[name] = np.array(v, copy=True) if isinstance(v, np.ndarray) else v
    return PackedMatrix(**kw)


def operands_from_numpy(runner, a, b):
    """numpy A (M, K) and B (K, N) -> ``runner``'s operands on its device,
    as ``runner.run_padded`` takes them (see ``prepare_operands``)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want A (M, K) and B (K, N), got {a.shape} and "
                         f"{b.shape}")
    if (a.shape[0], b.shape[1]) != (runner.packed.m, runner.packed.n):
        raise ValueError(f"A x B is {(a.shape[0], b.shape[1])}, the packing "
                         f"is {(runner.packed.m, runner.packed.n)}")
    return runner.prepare_operands(a, b)


def _load_weights(p, module, params_cls):
    """Copy the fields of ``params_cls`` (``w_q``, ...) from the JAX
    package's NamedTuple ``p``, read as fp32 numpy, into ``module``; a
    missing field or a shape that differs from the module's raises."""
    names = params_cls._fields
    missing = [n for n in names if not hasattr(p, n)]
    if missing:
        raise ValueError(f"{type(p).__name__} has no weight {missing}")
    ws = [np.array(getattr(p, n), dtype=np.float32) for n in names]
    for name, w, mine in zip(names, ws, module.params()):
        if w.shape != tuple(mine.shape):
            raise ValueError(f"weight {name} {w.shape} != the module's "
                             f"{tuple(mine.shape)}")
    module.load_params(params_cls(*map(torch.from_numpy, ws)))
    return module


def graph_attention_params_from_reference(p, layer):
    """Load the JAX package's ``GraphAttentionParams`` (w_q, w_k, w_v, each
    (F, D)) into the port's ``GraphAttentionLayer`` ``layer``; returns it."""
    from sddmm_tpu_torch.models.graph_attention import GraphAttentionParams
    return _load_weights(p, layer, GraphAttentionParams)


def block_sparse_params_from_reference(p, model):
    """Load the JAX package's ``BlockSparseAttentionParams`` (w_q, w_k, w_v
    (H, F, D) and w_o (H*D, F)) into the port's ``BlockSparseAttention``
    ``model``; returns it."""
    from sddmm_tpu_torch.models.block_sparse_attention import (
        BlockSparseAttentionParams)
    return _load_weights(p, model, BlockSparseAttentionParams)


def factorization_params_from_reference(p, model):
    """Load the JAX package's ``FactorizationParams`` (a (M, K), bt (N,
    K)) into the port's ``SparseFactorizationModel`` ``model`` (which
    starts a fresh optimizer state); returns it.  torch cannot draw
    ``jax.random``'s numbers, so a parity test starts both models from the
    JAX factors."""
    from sddmm_tpu_torch.models.factorization import FactorizationParams
    return _load_weights(p, model, FactorizationParams)
