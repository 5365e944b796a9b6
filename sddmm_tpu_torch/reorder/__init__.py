from sddmm_tpu_torch.reorder.rows import row_reordering, RowReorderResult
from sddmm_tpu_torch.reorder.cols import col_reordering, ColReorderResult
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import PackedMatrix, pack

__all__ = [
    "row_reordering",
    "RowReorderResult",
    "col_reordering",
    "ColReorderResult",
    "BSMR",
    "PackedMatrix",
    "pack",
]
