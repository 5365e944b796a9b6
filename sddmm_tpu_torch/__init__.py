"""sddmm_tpu_torch — the PyTorch/CUDA port of sddmm_tpu for NVIDIA Hopper.

The JAX package ``sddmm_tpu`` stays unchanged beside this one and is the
reference.  This package imports torch and numpy and never jax.  Its module
names follow the JAX package's, so each module's counterpart is easy to
find:

- ``data``, ``native``, ``reorder``, ``config``, ``utils.check`` and
  ``ops.reference`` are copies of the JAX package's host layers (numpy plus
  one C++ file), so that both packages build the identical packing.
- ``ops.tile_dot`` is the port of the Pallas tile-dot kernel
  (``csrc/tile_dot.cu``, one instance per compute mode); ``ops.hybrid``
  holds ``HybridSDDMM`` and the residual gather-dot kernel
  (``csrc/gather_dot.cu``); ``ops.dense`` the dense class
  (``DenseSDDMM``) on the tile kernel; ``ops.csr_sddmm`` the CSR baseline
  on the gather-dot kernel; ``ops.spmm`` the CSR SpMM (``csrc/spmm.cu``);
  ``ops.batch`` the batched SDDMM over the runners.
- ``models`` holds the two attention models (``GraphAttentionLayer``,
  ``BlockSparseAttention``) and the factorization trainer
  (``SparseFactorizationModel``, checkpointed by ``utils.checkpoint``);
  ``entry`` the flagship forward, as ``__graft_entry__.entry``.
- ``_kernels`` builds ``csrc/*.cu`` with nvcc for ``sm_90a`` at first use
  and binds them with ctypes.
- ``interop`` carries a ``PackedMatrix``, the operands and the models'
  weights across from the JAX package, for the parity tests.
- The user's entry points: ``bench`` (``python -m sddmm_tpu_torch.bench``,
  the suite's JSON line), ``cli`` (``python -m sddmm_tpu_torch.cli``, the
  reference executable's flags and logs), ``reorder.autotune`` (the layout
  model's search and the shoot-out timed on the card), and
  ``utils.timing`` (CUDA-event timers, the runners' ``measure_kernel_ms``),
  ``utils.logger`` (the ``[key : value]`` run log), ``utils.profiling``
  (``torch.profiler`` traces; the program's spans and the hand kernels'
  launch counter, on exactly while a capture of the host runs, recorded
  into an in-memory table that ``summary()`` reads) and ``utils.util``.
- ``reorder.device_cluster`` clusters rows on the card
  (``csrc/cluster_round.cu``, ``method="device"``); ``parallel`` shards the
  hybrid SDDMM, the dense class and (``models``) the factorization trainer
  over a rows×feat mesh of ``torch.distributed`` ranks (``make_mesh``,
  ``parallel.launch.spawn``, ``parallel.dryrun.dryrun_multichip``).

Every committed ``results/tuned_configs.json`` configuration runs (any G
and C, hub and hot-row slabs, the five compute modes, the dense class, any
K).  Every op the JAX package differentiates is an autograd op here
(the hybrid runners, the dense class, the CSR SDDMM and SpMM, the segment
softmax), each backward on the hand kernels, so the models train.  See
ROADMAP.md for what comes next.
"""

from sddmm_tpu_torch import config as config
from sddmm_tpu_torch.data.sparse import CSR, COO
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import PackedMatrix, pack
from sddmm_tpu_torch.ops.hybrid import sddmm_hybrid, HybridSDDMM
from sddmm_tpu_torch.parallel import (DistributedDenseSDDMM,
                                      DistributedHybridSDDMM, make_mesh)

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "COO",
    "BSMR",
    "PackedMatrix",
    "pack",
    "sddmm_reference",
    "csr_sddmm",
    "sddmm_hybrid",
    "HybridSDDMM",
    "DistributedHybridSDDMM",
    "DistributedDenseSDDMM",
    "make_mesh",
    "config",
    "__version__",
]
