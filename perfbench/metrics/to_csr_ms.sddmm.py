"""to_csr_ms.sddmm: median device time (ms) of the runner's
``hybrid.to_csr`` span (the gather into CSR order), from the program's
span table (``sddmm_tpu_torch.utils.profiling.summary``), which records
only while a capture that traces the host runs: the second profiled
sub-window of ``perfbench/trace.py``.  Moves sddmm_gflops."""


def read(records):
    if records.kind != "sddmm" or not records.kernels:
        return None
    try:
        from sddmm_tpu_torch.utils.profiling import summary
    except ImportError:     # a program without the span table
        return None
    span = summary()["spans"].get("hybrid.to_csr")
    return None if span is None else span["device_ms"]
