from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.ops.tile_dot import MODES, tile_dot_plain
from sddmm_tpu_torch.ops.hybrid import (HybridSDDMM, residual_gather_dot,
                                        residual_gather_dot_plain,
                                        sddmm_hybrid)
from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm, csr_sddmm_torch
from sddmm_tpu_torch.ops.dense import DenseSDDMM, dense_masked_sddmm
from sddmm_tpu_torch.ops.spmm import csr_spmm, csr_spmm_torch
from sddmm_tpu_torch.ops.softmax import csr_softmax, segment_softmax_torch
from sddmm_tpu_torch.ops.batch import (BatchedHybridSDDMM, batched_csr_sddmm,
                                       batched_transpose)

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
    "csr_spmm",
    "csr_spmm_torch",
    "csr_softmax",
    "segment_softmax_torch",
    "BatchedHybridSDDMM",
    "batched_csr_sddmm",
    "batched_transpose",
]
