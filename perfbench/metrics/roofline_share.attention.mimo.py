"""roofline_share.attention.mimo: least time of the attention core's work in
one training step of the MiMo-V2-Flash stack (scores, softmax with the
sink, aggregation, and their backward, both kinds of layer, counted from
the cell's shapes and masks: ``counts_mimo.core_ops``) as a % of the
device time a step of the core's kernels takes (``counts_mimo.
CORE_KERNELS`` by name: not the projection GEMM, its split, RoPE or
torch's own ops), in the device-only sub-window.  Moves train_step_ms."""

from perfbench import cells, counts, counts_mimo

CELL = "mimo.train"


def read(records):
    if records.kind != "train_stack":
        return None
    cell = cells.cell(CELL)
    d = cells.system(cell.config["system"]).dims(cell.config)
    ops = counts_mimo.core_ops(d, int(cell.traffic["seq_len"]),
                               int(cell.traffic["batch"]))
    return counts_mimo.kernel_share(
        records, counts_mimo.CORE_KERNELS,
        counts.least_s(ops, cell.config["compute_mode"]))
