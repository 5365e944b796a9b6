"""idle_share.sddmm: % of the profiled sub-window of SDDMM calls in which
no device op ran. Moves sddmm_gflops."""

from perfbench import readers


def read(records):
    return readers.idle_share(records, "sddmm")
