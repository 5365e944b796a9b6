"""The yardstick's operation and byte counts against hand counts."""

import pytest

from perfbench import counts


def test_sddmm_op_hand_count():
    # m=3, n=5, K=4, nnz=6: 2*6*4 flops; A 12, B 20, out 6 floats; col_idx 6
    # and row_ptr 4 int32
    op = counts.sddmm_op(3, 5, 4, 6)
    assert op.flops == 48
    assert op.bytes == (12 + 20 + 6) * 4 + (6 + 4) * 4


def test_spmm_and_matmul_hand_counts():
    op = counts.spmm_op(3, 5, 4, 6, heads=2)
    assert op.flops == 2 * 2 * 6 * 4
    assert op.bytes == 2 * (6 + 20 + 12) * 4 + (6 + 4) * 4
    mm = counts.matmul_op(2, 3, 4, "mm", count=3)
    assert mm.flops == 3 * 2 * 2 * 3 * 4
    assert mm.bytes == 3 * (6 + 12 + 8) * 4


def test_least_time_is_the_larger_bound():
    op = counts.Op("x", flops=counts.peak_flops("tf32"), bytes=1.0)
    assert op.least_s("tf32") == pytest.approx(1.0)
    op = counts.Op("y", flops=0.0, bytes=counts.HBM_BYTES_PER_S * 2)
    assert op.least_s("float32") == pytest.approx(2.0)


def test_mode_peaks():
    assert counts.peak_flops("tf32") == pytest.approx(989e12 / 3)
    assert counts.peak_flops("float32") == pytest.approx(989e12 / 6)


def test_longformer_useful_flops():
    # 4 projections 2*L*768*768 and 2*nnz*64 twice over 12 heads
    nnz = 2_043_134
    fwd = counts.attention_forward_ops(4096, 768, 12, 64, nnz)
    want = 4 * 2 * 4096 * 768 * 768 + 2 * 2 * 12 * nnz * 64
    assert counts.useful_flops(fwd) == want
    assert round(counts.useful_flops(fwd) / 1e9, 1) == 25.6
    # one layer on data: 3x the forward but the Q, K, V projections'
    # products for the input's gradient, which data does not need
    qkv = 3 * 2 * 4096 * 768 * 768
    train = counts.attention_train_ops(4096, 768, 12, 64, nnz, 4 * 768 * 768)
    assert counts.useful_flops(train) == 3 * want - qkv
    assert round(counts.useful_flops(train) / 1e9, 1) == 62.3
    # 12 layers over 8 sequences: the first layer's input alone is data
    deep = counts.attention_train_ops(4096, 768, 12, 64, nnz,
                                      12 * 4 * 768 * 768, layers=12, batch=8)
    assert counts.useful_flops(deep) == 8 * (12 * 3 * want - qkv)


def test_train_ops_by_hand():
    # L=2, F=2, H=1, D=2, nnz=3, 2 layers, batch 2, 32 weights
    ops = counts.attention_train_ops(2, 2, 1, 2, 3, 32, layers=2, batch=2)
    names = [op.name for op in ops]
    assert names.count("qkv_proj") == 2 and names.count("residual") == 2
    assert names.count("residual_bwd") == 1
    bwd = [op for op in ops if op.name == "qkv_proj_bwd"]
    # the last layer's backward first: 6 products, then the first's 3
    assert [op.flops for op in bwd] == [2 * 6 * 2 * 2 * 2 * 2,
                                        2 * 3 * 2 * 2 * 2 * 2]
    assert ops[-1].name == "adam" and ops[-1].bytes == 7 * 32 * 4
    loss = [op for op in ops if op.name == "loss"][0]
    assert loss.bytes == 2 * 3 * 2 * 2 * 4


def test_tiny_attention_bytes_by_hand():
    # L=2, F=2, H=1, D=2, nnz=3
    ops = {op.name: op for op in counts.attention_forward_ops(2, 2, 1, 2, 3)}
    assert ops["qkv_proj"].bytes == 3 * (4 + 4 + 4) * 4
    assert ops["scores"].bytes == (4 + 4 + 3) * 4 + (3 + 3) * 4
    assert ops["softmax"].bytes == 2 * 3 * 4 + (3 + 3) * 4
    assert ops["aggregate"].bytes == (3 + 4 + 4) * 4 + (3 + 3) * 4
    assert ops["out_proj"].flops == 2 * 2 * 2 * 2
