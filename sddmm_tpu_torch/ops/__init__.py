from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.ops.tile_dot import (tile_dot_bf16x3,
                                          tile_dot_bf16x3_plain)
from sddmm_tpu_torch.ops.hybrid import (HybridSDDMM, residual_gather_dot,
                                        residual_gather_dot_plain)

__all__ = [
    "sddmm_reference",
    "tile_dot_bf16x3",
    "tile_dot_bf16x3_plain",
    "HybridSDDMM",
    "residual_gather_dot",
    "residual_gather_dot_plain",
]
