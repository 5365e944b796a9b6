"""roofline_share.sddmm: least time for the work of one SDDMM call as a %
of its device-busy time. Moves sddmm_gflops."""

from perfbench import readers


def read(records):
    return readers.roofline_share(records, "sddmm")
