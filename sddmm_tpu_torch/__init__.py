"""sddmm_tpu_torch — the PyTorch/CUDA port of sddmm_tpu for NVIDIA Hopper.

The JAX package ``sddmm_tpu`` stays unchanged beside this one and is the
reference.  This package imports torch and numpy and never jax.  Its module
names follow the JAX package's, so each module's counterpart is easy to
find:

- ``data``, ``native``, ``reorder``, ``config``, ``utils.check`` and
  ``ops.reference`` are copies of the JAX package's host layers (numpy plus
  one C++ file), so that both packages build the identical packing.
- ``ops.tile_dot`` is the port of the Pallas tile-dot kernel
  (``csrc/tile_dot.cu``); ``ops.hybrid`` holds ``HybridSDDMM`` and the
  residual gather-dot kernel (``csrc/gather_dot.cu``).
- ``_kernels`` builds ``csrc/*.cu`` with nvcc for ``sm_90a`` at first use
  and binds them with ctypes.
- ``interop`` carries a ``PackedMatrix`` and the operands across from the
  JAX package, for the parity tests.

The hybrid path runs the G=1 / C=1 / no-slab class of configurations; see
ROADMAP.md for what comes next.
"""

from sddmm_tpu_torch import config as config
from sddmm_tpu_torch.data.sparse import CSR, COO
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import PackedMatrix, pack
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "COO",
    "BSMR",
    "PackedMatrix",
    "pack",
    "sddmm_reference",
    "HybridSDDMM",
    "config",
    "__version__",
]
