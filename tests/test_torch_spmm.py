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
from torch_native_ready import reference_native_loaded  # noqa: F401

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
        got = csr_spmm(tcsr, dense, values=values, device="cpu")
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
    """Once a guard that raised; now csr_spmm_torch is an autograd op: the
    values' cotangent is dOut[row] . dense[col], dense's is S^T . dOut
    (the same backward with or without a plan, which keeps the pattern's
    GradPattern, or one set for a block-diagonal pattern's head); without
    grad mode nothing is recorded, and a backward over an out-of-range row
    id raises."""
    v, r, c = torch.ones(4), torch.tensor([0, 0, 1, 1]), torch.tensor(
        [0, 1, 2, 0], dtype=torch.int32)
    d = torch.arange(24, dtype=torch.float32).reshape(3, 8).requires_grad_()
    vv = v.clone().requires_grad_()
    out = sp.csr_spmm_torch(vv, r, c, d, 2)
    assert out.grad_fn is not None
    g = torch.ones(2, 8)
    out.backward(g)
    assert torch.equal(vv.grad, (g[r] * d.detach()[c.long()]).sum(1))
    assert d.grad.tolist() == [[2.0] * 8, [1.0] * 8, [1.0] * 8]
    plan = sp.spmm_plan(np.array([0, 2, 4]), c.numpy())
    plan.grads = sp.GradPattern(r.numpy(), c.numpy(), (2, 3), "cpu")
    kept = plan.grads
    d2 = d.detach().clone().requires_grad_()
    sp.csr_spmm_torch(v, r, c, d2, 2, plan=plan).backward(g)
    assert torch.equal(d2.grad, d.grad) and plan.grads is kept
    with torch.inference_mode():
        out = sp.csr_spmm_torch(v.detach(), r, c, d.detach(), 2)
    assert out.tolist() == [[8.0 + 2 * i for i in range(8)],
                            [16.0 + 2 * i for i in range(8)]]
    with torch.no_grad():
        assert sp.csr_spmm_torch(v, r, c, d, 2).grad_fn is None
    bad = sp.csr_spmm_torch(v, torch.tensor([0, 0, 1, 5]), c, d, 2)
    with pytest.raises(ValueError, match="outside"):
        bad.sum().backward()


def _plan_pattern(seed):
    """Rows with sorted columns: 100 sliding-window rows (neighbours share
    most columns), then random rows, a 4096-entry row and empty rows."""
    rng = np.random.default_rng(seed)
    n = 5000
    rows = [np.arange(max(0, r - 30), r + 31) for r in range(100)]
    rows += [np.sort(rng.choice(n, rng.integers(0, 60), replace=False))
             for _ in range(100)]
    rows[3] = np.arange(4096)
    rows[150] = np.arange(sp.SPMM_LONG_ROW + 1)
    for r in (10, 11, 120, 199):
        rows[r] = np.zeros(0, dtype=np.int64)
    row_ptr = np.r_[0, np.cumsum([len(c) for c in rows])]
    return row_ptr, np.concatenate(rows).astype(np.int64), n


@pytest.mark.parametrize("group_rows", [None, 2, 4])
@pytest.mark.parametrize("order", ["natural", "permuted"])
def test_spmm_plan_covers_every_entry_once(order, group_rows):
    """The kernel's plan: every entry is summed exactly once, into its own
    row, and (columns sorted) each row's pieces run through its entries in
    CSR order; long rows are their own tasks; groups share columns."""
    row_ptr, cols, _ = _plan_pattern(0)
    m = len(row_ptr) - 1
    ro = (np.random.default_rng(1).permutation(m) if order == "permuted"
          else None)
    plan = sp.spmm_plan(row_ptr, cols, ro, group_rows)
    assert plan.group_rows in sp.SPMM_GROUPS
    long = plan.tasks[plan.tasks[:, 1] == 0, 0]
    assert sorted(long) == [3, 150]
    per_row = {}
    for row, e in sp.spmm_pieces(plan, row_ptr):
        per_row.setdefault(int(row), []).append(e)
    assert sorted(per_row) == list(range(m))
    for r in range(m):
        assert np.array_equal(np.concatenate(per_row[r]),
                              np.arange(row_ptr[r], row_ptr[r + 1]))
    if order == "natural":
        # the window rows share: their groups read fewer columns than
        # they have entries
        multi = plan.groups[plan.groups[:, 3] >= 0]
        assert len(multi) and len(plan.items) < row_ptr[100]


@pytest.mark.parametrize("group_rows", [None, 2, 4])
def test_spmm_split_matches_jax(group_rows):
    """The plan's order of sums (``csr_spmm_split_plain``) against the JAX
    package's ``csr_spmm_jax`` within 1e-5 of the sum of the terms'
    magnitudes, on a 4096-entry row, a row past ``SPMM_LONG_ROW`` and
    empty rows."""
    row_ptr, cols, n = _plan_pattern(2)
    m = len(row_ptr) - 1
    rng = np.random.default_rng(3)
    values = rng.standard_normal(len(cols)).astype(np.float32)
    dense = rng.standard_normal((n, 16)).astype(np.float32)
    rows = np.repeat(np.arange(m), np.diff(row_ptr)).astype(np.int32)
    plan = sp.spmm_plan(row_ptr, cols, group_rows=group_rows)
    got = sp.csr_spmm_split_plain(torch.from_numpy(values),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(dense), row_ptr, plan)
    want = _jax(values, rows, cols.astype(np.int32), dense, m)
    scale = _jax(np.abs(values), rows, cols.astype(np.int32),
                 np.abs(dense), m)
    assert (np.abs(got.numpy() - want) / np.maximum(scale, 1e-30)).max() \
        <= 1e-5
    assert not got[[10, 11, 120, 199]].any()


def test_spmm_plan_adapts_to_sharing():
    """A sliding window shares almost every column between neighbours: the
    plan takes groups of 4.  Random rows share none: every group is one
    row.  A bad row order or group size raises."""
    from sddmm_tpu_torch.models.block_sparse_attention import \
        make_attention_mask
    mask = make_attention_mask(600, window=30, num_global=1)
    assert sp.spmm_plan(mask.row_ptr, mask.col_idx).group_rows == 4
    rng = np.random.default_rng(4)
    row_ptr = np.arange(0, 301 * 20, 20)
    cols = np.concatenate([np.sort(rng.choice(100000, 20, replace=False))
                           for _ in range(300)])
    plan = sp.spmm_plan(row_ptr, cols)
    assert (plan.groups[:, 3] < 0).all() and len(plan.items) == 0
    with pytest.raises(ValueError, match="permutation"):
        sp.spmm_plan(row_ptr, cols, row_order=np.zeros(300, dtype=int))
    with pytest.raises(ValueError, match="group_rows"):
        sp.spmm_plan(row_ptr, cols, group_rows=3)
