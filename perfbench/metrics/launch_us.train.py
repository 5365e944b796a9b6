"""launch_us.train: mean host time (us) of one hand-kernel launch call
(``_kernels.launch``), from the program's launch counter
(``sddmm_tpu_torch.utils.profiling.summary``), which counts only while a
capture that traces the host runs: the second profiled sub-window of
``perfbench/trace.py``.  The step's ~2.6k hand launches are host time the
step pays once the host's lead over the device is used up; the counter
does not see torch's own launches, so it cannot show where a full stream
queue blocks those.  Moves train_step_ms."""


def read(records):
    if records.kind != "train" or not records.kernels:
        return None
    try:
        from sddmm_tpu_torch.utils.profiling import summary
    except ImportError:     # a program without the launch counter
        return None
    launch = summary()["launch"]
    if not launch["count"]:
        return None
    return launch["host_ms"] * 1e3 / launch["count"]
