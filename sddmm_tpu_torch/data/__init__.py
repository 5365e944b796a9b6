from sddmm_tpu_torch.data.sparse import CSR, COO
from sddmm_tpu_torch.data import io as io
from sddmm_tpu_torch.data import generate as generate

__all__ = ["CSR", "COO", "io", "generate"]
