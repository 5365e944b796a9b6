"""A ('rows', 'feat') device mesh over ``torch.distributed``.

Counterpart of ``sddmm_tpu/parallel/mesh.py`` (``make_mesh``).  JAX's mesh
is one program over many devices; here every rank is a process (started by
``launch.spawn``) that builds the same ``Mesh`` and keeps its own
coordinates and one process group per axis.  Rank ``r`` sits at the
row-major coordinates of ``r`` in the mesh's shape, so with axes (rows,
feat) the ranks ``r*F .. r*F+F-1`` share row block r.

The backend is the caller's explicit choice: ``"nccl"`` where each rank
has a card of its own, ``"gloo"`` for CPU tensors, and ``"gloo"`` over CUDA
tensors where several ranks share one card (gloo reduces CUDA tensors
through the host).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: ``shape`` and ``coords`` by axis name,
    ``groups`` (the process group along each axis through this rank), the
    ``backend`` and the rank's ``device``."""
    shape: dict
    coords: dict
    groups: dict
    rank: int
    backend: str
    device: torch.device

    def __str__(self) -> str:
        dims = " x ".join(f"{k} {v}" for k, v in self.shape.items())
        return (f"mesh {dims} over {self.backend} ({self.device.type} "
                f"tensors), rank {self.rank} at {self.coords} on "
                f"{self.device}")


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("rows", "feat"), *,
              backend: str, device="cuda") -> Mesh:
    """This rank's ``Mesh`` over the initialised default process group
    (all ranks call it alike: it creates every axis group in one order).

    Default layout: every rank on 'rows', the other axes of size 1, as in
    the JAX package.  ``backend`` must be the default group's (it is the
    groups' too).  ``device`` "cuda" means card ``rank % device_count``
    (made the current device); "cpu" only when asked for."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(run the ranks with parallel.launch.spawn)")
    if dist.get_backend() != backend:
        raise ValueError(f"make_mesh: backend {backend!r}, but the process "
                         f"group runs {dist.get_backend()!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(names) - 1)
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) != len(names) or int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {sizes} over {names} does not cover "
                         f"{world} ranks")
    from sddmm_tpu_torch.ops.hybrid import check_device
    dev = check_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    grid = np.arange(world).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups = {}
    for i, name in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                groups[name] = group
    return Mesh(dict(zip(names, sizes)), coords, groups, rank, backend, dev)
