"""roofline_share.rope.mimo: least time of RoPE's work in one training step
of the MiMo-V2-Flash stack (the rotated dims read and written once in the
forward and once in the backward, with the table: bytes over HBM
bandwidth, ``counts_mimo.rope_step_ops``) as a % of the device time a step
of the RoPE kernel (``csrc/rope.cu``) takes, in the device-only
sub-window.  The backward's copy of the unrotated dims is not work the
function needs, so it counts against the share.  Moves train_step_ms."""

from perfbench import cells, counts, counts_mimo

CELL = "mimo.train"


def read(records):
    if records.kind != "train_stack":
        return None
    cell = cells.cell(CELL)
    d = cells.system(cell.config["system"]).dims(cell.config)
    ops = counts_mimo.rope_step_ops(d, int(cell.traffic["seq_len"]),
                                    int(cell.traffic["batch"]))
    return counts_mimo.kernel_share(
        records, (counts_mimo.ROPE_KERNEL,),
        counts.least_s(ops, cell.config["compute_mode"]))
