from sddmm_tpu_torch.utils.check import check_values, CheckResult
from sddmm_tpu_torch.utils.checkpoint import Checkpointer
from sddmm_tpu_torch.utils.logger import RunLog
from sddmm_tpu_torch.utils.timing import Timer, cuda_time_ms, time_fn

__all__ = ["check_values", "CheckResult", "Checkpointer", "cuda_time_ms",
           "Timer", "time_fn", "RunLog"]
