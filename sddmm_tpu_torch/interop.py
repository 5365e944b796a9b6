"""Carry state across from the JAX package.

This system has no weights: its state is the ``PackedMatrix`` and the dense
operands.  With these helpers a test packs once in ``sddmm_tpu`` and runs
both packages' runners on the identical layout and inputs.  Nothing here
imports ``sddmm_tpu`` (that would load jax): the JAX package's objects
are read by duck typing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
