"""launch_us.mimo: mean host time (us) of one hand-kernel launch call
(``_kernels.launch``) in the MiMo-V2-Flash stack's training steps, from the
program's launch counter (``sddmm_tpu_torch.utils.profiling.summary``),
which counts only while a capture that traces the host runs: the second
profiled sub-window of ``perfbench/trace.py``.  Host time the step pays
once the host's lead over the device is used up; blind to torch's own
launches.  Moves train_step_ms."""


def read(records):
    if records.kind != "train_stack" or not records.kernels:
        return None
    try:
        from sddmm_tpu_torch.utils.profiling import summary
    except ImportError:     # a program without the launch counter
        return None
    launch = summary()["launch"]
    if not launch["count"]:
        return None
    return launch["host_ms"] * 1e3 / launch["count"]
