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
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.utils.check import check_values

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
