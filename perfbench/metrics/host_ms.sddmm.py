"""host_ms.sddmm: mean host time (ms) to enqueue one SDDMM call, each after
a synchronize. Moves sddmm_gflops."""

from perfbench import readers


def read(records):
    return readers.host_ms(records, "sddmm")
