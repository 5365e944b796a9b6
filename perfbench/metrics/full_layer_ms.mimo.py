"""full_layer_ms.mimo: median device time (ms) of one full-attention layer's
forward, the program's ``attention.full`` span (projections, RoPE, scores,
softmax, aggregation, output projection), from its span table
(``sddmm_tpu_torch.utils.profiling.summary``), which records only while a
capture that traces the host runs: the second profiled sub-window of
``perfbench/trace.py``.  Moves train_step_ms."""


def read(records):
    if records.kind != "train_stack" or not records.kernels:
        return None
    try:
        from sddmm_tpu_torch.utils.profiling import summary
    except ImportError:     # a program without the span table
        return None
    span = summary()["spans"].get("attention.full")
    return None if span is None else span["device_ms"]
