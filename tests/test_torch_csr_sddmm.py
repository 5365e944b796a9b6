"""The port's CSR baseline (``sddmm_tpu_torch.ops.csr_sddmm``) against the
JAX package's ``sddmm_tpu.ops.csr_sddmm``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops.csr_sddmm import csr_sddmm as j_csr_sddmm
from sddmm_tpu.ops.csr_sddmm import csr_sddmm_jax
from sddmm_tpu_torch import csr_sddmm
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.ops import gather_plan as gp
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.utils.check import check_values
from torch_native_ready import reference_native_loaded  # noqa: F401

cs = importlib.import_module("sddmm_tpu_torch.ops.csr_sddmm")

K = 64
# both sides take exact fp32 products and sum them in fp32, in another order
PARITY_REL = 1e-6


@pytest.fixture(scope="module")
def case():
    csr = jgen.random_sparse(200, 160, density=0.05, seed=3)
    a = jgen.make_dense(csr.m, K, seed=1)
    b = jgen.make_dense(K, csr.n, seed=2)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    return csr, tcsr, a, b


@pytest.mark.parametrize("scale_by_values", [False, True])
@pytest.mark.parametrize("max_gathered_mb", [512.0, 0.05],
                         ids=["plain", "blocked"])
def test_csr_sddmm_matches_jax(max_gathered_mb, scale_by_values, case):
    """Unblocked and blocked (0.05 MB: blocks of 97 entries, the last one
    padded), with and without the pattern's values."""
    csr, tcsr, a, b = case
    want = j_csr_sddmm(a, b, csr, scale_by_values=scale_by_values,
                       max_gathered_mb=max_gathered_mb)
    got = csr_sddmm(a, b, tcsr, scale_by_values=scale_by_values,
                    max_gathered_mb=max_gathered_mb, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (csr.nnz,)
    assert got.dtype == want.dtype == np.float32
    assert np.max(np.abs(got - want) / np.abs(want)) <= PARITY_REL
    ref = sddmm_reference(a, b, tcsr, scale_by_values=scale_by_values)
    res = check_values(ref, got)
    assert res.passed and res.num_errors == 0, str(res)


def test_csr_sddmm_torch_matches_csr_sddmm_jax(case):
    csr, _, a, b = case
    rows = csr.row_indices().astype(np.int32)
    cols = csr.col_idx.astype(np.int32)
    bt = np.ascontiguousarray(b.T)
    want = np.asarray(csr_sddmm_jax(jnp.asarray(a), jnp.asarray(bt),
                                    jnp.asarray(rows), jnp.asarray(cols)))
    got = cs.csr_sddmm_torch(*map(torch.from_numpy, (a, bt, rows, cols)))
    assert np.max(np.abs(got.numpy() - want) / np.abs(want)) <= PARITY_REL


@pytest.mark.parametrize("adt,bdt", [("float16", "float32"),
                                     ("bfloat16", "float16"),
                                     ("float32", "float16")])
def test_csr_sddmm_torch_casts_other_storage_pairs(adt, bdt, case):
    """A storage pair the gather-dot has no instance for is cast to fp32
    first, as csr_sddmm_jax's astype(float32): the same values."""
    csr, _, a, b = case
    rows = csr.row_indices().astype(np.int32)
    cols = csr.col_idx.astype(np.int32)
    a_t = torch.from_numpy(a).to(getattr(torch, adt))
    bt_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(getattr(torch, bdt))
    want = np.asarray(csr_sddmm_jax(
        jnp.asarray(a_t.float().numpy()).astype(adt),
        jnp.asarray(bt_t.float().numpy()).astype(bdt),
        jnp.asarray(rows), jnp.asarray(cols)))
    got = cs.csr_sddmm_torch(a_t, bt_t, torch.from_numpy(rows),
                             torch.from_numpy(cols))
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want) / np.abs(want)) <= PARITY_REL
    # the gather-dot itself takes only the modes' pairs
    with pytest.raises(TypeError, match="want one of"):
        cs.residual_gather_dot(a_t, bt_t, torch.from_numpy(rows),
                               torch.from_numpy(cols))


def test_blocked_plain_needs_whole_blocks(case):
    csr, _, a, b = case
    args = [torch.from_numpy(x) for x in (
        a, np.ascontiguousarray(b.T), csr.row_indices().astype(np.int32),
        csr.col_idx.astype(np.int32))]
    n = csr.nnz - csr.nnz % 10
    got = cs.csr_sddmm_blocked_plain(args[0], args[1], args[2][:n],
                                     args[3][:n], block_nnz=10)
    assert torch.equal(got, cs.csr_sddmm_torch(args[0], args[1],
                                               args[2][:n], args[3][:n]))
    with pytest.raises(ValueError, match="block_nnz"):
        cs.csr_sddmm_blocked_plain(*args[:2], args[2][:n - 1],
                                   args[3][:n - 1], block_nnz=10)


def _plan_pattern(name):
    """(JAX CSR) patterns whose rows share columns or do not."""
    if name == "clustered":        # planted 16-row clusters, rows shuffled
        return jgen.block_clustered(64, 64, block_prob=0.08,
                                    block_density=0.7, seed=9)
    if name == "banded":
        return jgen.banded(3000, 3000, bandwidth=20, fill=0.6, seed=2)
    if name == "scattered":        # 10 random columns of 20,000 a row
        return jgen.random_sparse(200, 20000, density=0.0005, seed=3)
    return jgen.random_sparse(200, 160, density=0.05, seed=3)


@pytest.mark.parametrize("group_rows", [None, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ["clustered", "banded", "random"])
def test_csr_plan_covers_every_entry_once(name, group_rows):
    """Every entry of the pattern is in the plan exactly once, in a group
    whose row holds it, at the key (column) it is listed under; a group's
    items are its distinct columns, ascending."""
    csr = _plan_pattern(name)
    rows = csr.row_indices()
    order = gp.similar_rows_order(csr.row_ptr, csr.col_idx)
    plan = gp.gather_plan(rows, csr.col_idx, order, group_rows)
    if not plan.grouped:
        assert group_rows is None and plan.n == csr.nnz
        return
    seen = np.zeros(csr.nnz, dtype=np.int64)
    for row, ents, keys in gp.plan_entries(plan):
        assert (rows[ents] == row).all() and (csr.col_idx[ents] == keys).all()
        seen[ents] += 1
    assert (seen == 1).all()
    for g in plan.groups:
        keys = plan.items[g[0]:g[1], 0]
        assert (np.diff(keys) > 0).all()
    # the tasks cover every item once, in runs of at most GATHER_TASK_ITEMS
    t = plan.tasks
    assert (t[:, 2] - t[:, 1] <= gp.GATHER_TASK_ITEMS).all()
    assert np.array_equal(np.sort(np.concatenate(
        [np.arange(a, b) for _, a, b in t])), np.arange(len(plan.items)))


@pytest.mark.parametrize("group_rows", [2, 8, 16])
@pytest.mark.parametrize("name", ["clustered", "banded"])
def test_plan_order_plain_matches_csr_sddmm_jax(name, group_rows):
    """The kernel's walk of the plan in PyTorch ops, and
    ``csr_sddmm_torch`` given the plan, against ``csr_sddmm_jax``."""
    csr = _plan_pattern(name)
    a = jgen.make_dense(csr.m, K, seed=1)
    b = jgen.make_dense(K, csr.n, seed=2)
    rows = csr.row_indices().astype(np.int32)
    cols = csr.col_idx.astype(np.int32)
    bt = np.ascontiguousarray(b.T)
    want = np.asarray(csr_sddmm_jax(jnp.asarray(a), jnp.asarray(bt),
                                    jnp.asarray(rows), jnp.asarray(cols)))
    plan = gp.gather_plan(rows, cols, gp.similar_rows_order(
        csr.row_ptr, csr.col_idx), group_rows)
    got = hy.gather_dot_plan_plain(torch.from_numpy(a),
                                   torch.from_numpy(bt)[None], plan)
    assert np.max(np.abs(got.numpy() - want) / np.abs(want)) <= PARITY_REL
    got2 = cs.csr_sddmm_torch(*map(torch.from_numpy, (a, bt, rows, cols)),
                              plan=plan)
    assert torch.equal(got, got2)


def test_csr_plan_groups_shared_rows():
    """The CSR baseline's plan finds the planted clusters of shuffled rows
    (through ``similar_rows_order``) and the band, and reads far fewer B^T
    rows than entries; scattered random rows share nothing and keep the
    entry-order walk.  A plan that covers another entry count is
    refused."""
    for name in ("clustered", "banded"):
        csr = _plan_pattern(name)
        plan = cs.csr_plan(TCSR(csr.shape, csr.row_ptr, csr.col_idx,
                                csr.values))
        assert plan.grouped and len(plan.items) < 0.6 * csr.nnz, name
    csr = _plan_pattern("scattered")
    assert not cs.csr_plan(TCSR(csr.shape, csr.row_ptr, csr.col_idx,
                                csr.values)).grouped
    a, bt = torch.ones(4, 8), torch.ones(5, 8)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="plan covers"):
        cs.csr_sddmm_torch(a, bt, idx, idx,
                           plan=gp.gather_plan([0, 1], [0, 1], None, 2))
