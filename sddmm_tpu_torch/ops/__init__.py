from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.ops.tile_dot import MODES, tile_dot_plain
from sddmm_tpu_torch.ops.hybrid import (HybridSDDMM, residual_gather_dot,
                                        residual_gather_dot_plain,
                                        sddmm_hybrid)
from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm, csr_sddmm_torch
from sddmm_tpu_torch.ops.dense import DenseSDDMM, dense_masked_sddmm

__all__ = [
    "sddmm_reference",
    "MODES",
    "tile_dot_plain",
    "HybridSDDMM",
    "residual_gather_dot",
    "residual_gather_dot_plain",
    "sddmm_hybrid",
    "csr_sddmm",
    "csr_sddmm_torch",
    "DenseSDDMM",
    "dense_masked_sddmm",
]
