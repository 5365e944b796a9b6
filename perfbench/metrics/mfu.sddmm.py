"""mfu.sddmm: useful operations of one SDDMM call over its wall time times
the mode's peak, in %. Moves sddmm_gflops."""

from perfbench import readers


def read(records):
    return readers.mfu(records, "sddmm")
