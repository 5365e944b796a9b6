"""The port's CSR SpMM (``sddmm_tpu_torch.ops.spmm``) against the JAX
package's ``sddmm_tpu.ops.spmm``.  On the CPU ``csr_spmm_torch`` runs its
plain version (``index_add_``); the kernel is held to it on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops.spmm import csr_spmm as j_csr_spmm
from sddmm_tpu.ops.spmm import csr_spmm_jax
from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.ops import csr_spmm
from sddmm_tpu_torch.ops import spmm as sp

# both sides sum fp32 products in fp32, in another order (segment_sum's
# against index_add_'s)
RTOL, ATOL = 1e-5, 1e-6


def _pattern(m, n, nnz, seed, empty_rows=()):
    """Random (rows, cols, values) with some rows left empty, rows sorted."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    rows = rows[~np.isin(rows, empty_rows)]
    rows = np.sort(rows).astype(np.int32)
    cols = rng.integers(0, n, len(rows)).astype(np.int32)
    values = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, values


def _jax(values, rows, cols, dense, num_rows):
    return np.asarray(csr_spmm_jax(jnp.asarray(values), jnp.asarray(rows),
                                   jnp.asarray(cols), jnp.asarray(dense),
                                   num_rows=num_rows))


@pytest.mark.parametrize("K", [1, 8, 24, 64])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_csr_spmm_torch_matches_jax(order, K):
    m, n = 97, 61
    rows, cols, values = _pattern(m, n, 900, seed=K, empty_rows=(0, 5, 96))
    if order == "unsorted":
        perm = np.random.default_rng(1).permutation(len(rows))
        rows, cols, values = rows[perm], cols[perm], values[perm]
    dense = np.random.default_rng(2).standard_normal((n, K)).astype(
        np.float32)
    want = _jax(values, rows, cols, dense, m)
    got = sp.csr_spmm_torch(*map(torch.from_numpy, (values, rows, cols,
                                                    dense)), m)
    assert got.shape == (m, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # an empty row is exact zeros
    assert not got[[0, 5, 96]].any()


def test_csr_spmm_host_wrapper_matches_jax():
    csr = jgen.powerlaw_graph(300, avg_degree=5, seed=8)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    dense = jgen.make_dense(csr.n, 16, seed=3)
    assert (csr.row_nnz() == 0).any()
    for values in (None, np.random.default_rng(4).standard_normal(
            csr.nnz).astype(np.float32)):
        want = j_csr_spmm(csr, dense, values=values)
        got = csr_spmm(tcsr, dense, values=values)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_csr_spmm_drops_rows_out_of_range():
    """Row ids outside [0, num_rows) are dropped, as segment_sum drops
    them, on the plain path and in the kernel's CSR index."""
    rows = np.array([-1, 0, 0, 2, 3, 7], dtype=np.int32)
    cols = np.array([0, 1, 2, 0, 1, 2], dtype=np.int32)
    values = np.arange(1, 7, dtype=np.float32)
    dense = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)
    want = _jax(values, rows, cols, dense, 3)
    t = list(map(torch.from_numpy, (values, rows, cols, dense)))
    np.testing.assert_allclose(sp.csr_spmm_torch(*t, 3).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    row_ptr, _, _ = sp.csr_index(t[0], t[1], t[2], 3)
    assert row_ptr.tolist() == [1, 3, 3, 4]


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_index_sorts_stably(seed):
    """The kernel's CSR (row pointers, then each row's entries) of unsorted
    entries: walking it gives the JAX result, and a row's entries keep
    their order."""
    m, n = 40, 30
    rows, cols, values = _pattern(m, n, 300, seed=seed, empty_rows=(3,))
    perm = np.random.default_rng(seed + 7).permutation(len(rows))
    rows_u, cols_u, values_u = rows[perm], cols[perm], values[perm]
    row_ptr, c, v = sp.csr_index(*map(torch.from_numpy,
                                      (values_u, rows_u, cols_u)), m)
    assert row_ptr.dtype == torch.int64 and row_ptr.shape == (m + 1,)
    walked_rows = torch.repeat_interleave(torch.arange(m),
                                          row_ptr.diff())
    for r in range(m):
        sel = rows_u == r
        assert np.array_equal(c[row_ptr[r]:row_ptr[r + 1]].numpy(),
                              cols_u[sel])
    dense = np.random.default_rng(seed).standard_normal((n, 8)).astype(
        np.float32)
    got = sp.csr_spmm_plain(v, walked_rows, c, torch.from_numpy(dense), m)
    np.testing.assert_allclose(got.numpy(), _jax(values_u, rows_u, cols_u,
                                                  dense, m),
                               rtol=RTOL, atol=ATOL)
    # already sorted: the same row pointers, the entries as they were
    sorted_t = list(map(torch.from_numpy, (values, rows, cols)))
    rp2, c2, v2 = sp.csr_index(*sorted_t, m)
    assert torch.equal(rp2, row_ptr)
    assert c2 is sorted_t[2] and v2 is sorted_t[0]


def test_row_ptr_argument_and_cpu_counts_no_launch():
    csr = jgen.block_clustered(6, 6, block_prob=0.3, seed=2)
    dense = jgen.make_dense(csr.n, 8, seed=1)
    t = [torch.from_numpy(x) for x in (
        csr.values, csr.row_indices().astype(np.int64),
        csr.col_idx.astype(np.int32), dense)]
    before = dict(_kernels.launches)
    a = sp.csr_spmm_torch(*t, csr.m)
    b = sp.csr_spmm_torch(*t, csr.m, row_ptr=torch.from_numpy(csr.row_ptr))
    assert torch.equal(a, b)
    assert dict(_kernels.launches) == before


def test_csr_spmm_rejects():
    v, r, c = torch.ones(4), torch.zeros(4, dtype=torch.int64), torch.zeros(
        4, dtype=torch.int32)
    d = torch.ones(3, 8)
    with pytest.raises(ValueError, match="cols"):
        sp.csr_spmm_torch(v, r, c[:3], d, 2)
    with pytest.raises(ValueError, match="dense"):
        sp.csr_spmm_torch(v, r, c, torch.ones(3), 2)
    with pytest.raises(TypeError, match="rows"):
        sp.csr_spmm_torch(v, r.float(), c, d, 2)
    with pytest.raises(ValueError, match="row_ptr"):
        sp.csr_spmm_torch(v, r, c, d, 2, row_ptr=torch.zeros(2,
                                                             dtype=torch.long))


def test_csr_spmm_gradient_guard():
    """The kernel writes through ctypes, so no gradient could flow: under
    grad mode an operand that requires grad raises, naming the ROADMAP
    item; without grad mode the values come back."""
    v, r, c = torch.ones(4), torch.tensor([0, 0, 1, 1]), torch.tensor(
        [0, 1, 2, 0], dtype=torch.int32)
    d = torch.ones(3, 8, requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match="Autograd for the hybrid op"):
        sp.csr_spmm_torch(v, r, c, d, 2)
    with pytest.raises(NotImplementedError):
        sp.csr_spmm_torch(v.requires_grad_(), r, c, d.detach(), 2)
    with torch.inference_mode():
        out = sp.csr_spmm_torch(v.detach(), r, c, d.detach(), 2)
    assert out.tolist() == [[2.0] * 8, [2.0] * 8]
    with torch.no_grad():
        assert sp.csr_spmm_torch(v, r, c, d, 2).grad_fn is None
