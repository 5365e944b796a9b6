"""The frozen pattern generators are bit-equal to the port's as it stands."""

import numpy as np
import pytest

from perfbench import patterns


def _port_csr(csr):
    return np.asarray(csr.row_ptr, np.int64), np.asarray(csr.col_idx,
                                                         np.int32)


def _same(pat, csr):
    row_ptr, col_idx = _port_csr(csr)
    assert (pat.m, pat.n) == tuple(csr.shape)
    assert np.array_equal(pat.row_ptr, row_ptr)
    assert np.array_equal(pat.col_idx, col_idx)
    assert pat.col_idx.dtype == np.int32 and pat.row_ptr.dtype == np.int64


@pytest.mark.parametrize("args", [
    dict(num_nodes=524288, avg_degree=40, seed=44),
    dict(num_nodes=2048, avg_degree=16, seed=44)])
def test_powerlaw_equals_port(args):
    from sddmm_tpu_torch.data import generate
    _same(patterns.powerlaw(**args), generate.powerlaw_graph(**args))


@pytest.mark.parametrize("seq,window,glob", [(4096, 256, 1), (100, 7, 3),
                                             (64, 4, 0)])
def test_attention_window_equals_port(seq, window, glob):
    from sddmm_tpu_torch.models.block_sparse_attention import (
        make_attention_mask)
    _same(patterns.attention_window(seq, window, glob),
          make_attention_mask(seq, window=window, num_global=glob))


def test_suite_sizes():
    assert patterns.powerlaw(32768, 40, seed=44).nnz == 951_097
    assert patterns.powerlaw(524288, 40, seed=44).nnz == 16_317_444
    assert patterns.attention_window(4096, 256, 1).nnz == 2_043_134
