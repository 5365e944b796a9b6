from sddmm_tpu_torch.utils.check import check_values, CheckResult
from sddmm_tpu_torch.utils.checkpoint import Checkpointer
from sddmm_tpu_torch.utils.timing import cuda_time_ms

__all__ = ["check_values", "CheckResult", "Checkpointer", "cuda_time_ms"]
