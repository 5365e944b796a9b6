"""The port's dense class (``sddmm_tpu_torch.ops.dense``) against the JAX
package's ``sddmm_tpu.ops.dense``, in every compute mode."""

import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops.dense import DenseSDDMM as JaxDense
from sddmm_tpu.ops.dense import dense_masked_sddmm as j_dense_masked
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.ops import dense as dn
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.utils.check import check_values

K = 64
MODES = ("tf32", "float32", "mixed", "float16", "bfloat16")
# Port vs JAX: the same bf16 planes ("mixed", "float16", "bfloat16") or the
# exact product within one fp32 rounding ("float32", the bf16x6 split), with
# sums in another order.
PARITY_REL = 1e-5
# "tf32": JAX's CPU backend computes Precision.HIGH in full fp32, the port
# the bf16x3 split: at most 3 * 2^-18 relative per product on U[0,2) data
# (see test_torch_hybrid.SPLIT_REL).
SPLIT_REL = 3 * 2.0 ** -18
# The same, for a value that is one product or a few (K < 16): no sum
# averages the split's errors, so the worst case holds.  Each bf16 rounding
# errs by at most 2^-8 relative, so al.bl and the two rounding errors of
# the lo planes are each at most 2^-16 of a.b.
SPLIT_REL_FEW = 3 * 2.0 ** -16


@pytest.fixture(scope="module")
def case():
    csr = jgen.random_sparse(96, 80, density=0.3, seed=46)
    a = jgen.make_dense(csr.m, K, seed=1)
    b = jgen.make_dense(K, csr.n, seed=2)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    return csr, tcsr, a, b


@pytest.mark.parametrize("order", ["packed", "csr"])
@pytest.mark.parametrize("mode", MODES)
def test_dense_matches_jax(mode, order, case):
    csr, tcsr, a, b = case
    jr = JaxDense.from_csr(csr, compute_dtype=mode)
    want = np.asarray(jr.run_padded(*jr.prepare_operands(a, b=b),
                                    order=order))
    r = dn.DenseSDDMM.from_csr(tcsr, compute_dtype=mode, device="cpu")
    got = r.run_padded(*r.prepare_operands(a, b=b), order=order)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = SPLIT_REL if mode == "tf32" else PARITY_REL
    rel = np.abs(got.numpy() - want) / np.abs(want)
    assert rel.max() <= tol, rel.max()
    if order == "csr" and mode in ("tf32", "float32", "mixed"):
        res = check_values(sddmm_reference(a, b, tcsr), got.numpy())
        assert res.passed and res.num_errors == 0, str(res)


@pytest.mark.parametrize("mode", ["tf32", "float32"])
@pytest.mark.parametrize("k", [1, 4, 8, 24])
def test_dense_any_k_matches_jax(k, mode, case):
    """K off the tile kernel's 16-step (tile_dot zero-pads it before a
    launch) against the JAX dense class, which takes any K."""
    csr, tcsr, _, _ = case
    a = jgen.make_dense(csr.m, k, seed=1)
    b = jgen.make_dense(k, csr.n, seed=2)
    jr = JaxDense.from_csr(csr, compute_dtype=mode)
    want = np.asarray(jr.run_padded(*jr.prepare_operands(a, b=b),
                                    order="csr"))
    got = dn.DenseSDDMM.from_csr(tcsr, compute_dtype=mode,
                                 device="cpu")(a, b=b).numpy()
    tol = SPLIT_REL_FEW if mode == "tf32" else PARITY_REL
    assert np.max(np.abs(got - want) / np.abs(want)) <= tol
    res = check_values(sddmm_reference(a, b, tcsr), got)
    assert res.passed and res.num_errors == 0, str(res)


@pytest.mark.parametrize("mode", ["tf32", "bfloat16"])
def test_dense_masked_matches_jax(mode, case):
    csr, tcsr, a, b = case
    want = j_dense_masked(a, b, csr, compute_dtype=mode)
    got = dn.dense_masked_sddmm(a, b, tcsr, compute_dtype=mode, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (csr.nnz,)
    tol = SPLIT_REL if mode == "tf32" else PARITY_REL
    assert np.max(np.abs(got - want) / np.abs(want)) <= tol


def test_operands_bt_and_storage(case):
    _, tcsr, a, b = case
    r = dn.DenseSDDMM.from_csr(tcsr, compute_dtype="mixed", device="cpu")
    a1, bt1 = r.prepare_operands(a, b=b)
    a2, bt2 = r.prepare_operands(a, bt=np.ascontiguousarray(b.T))
    assert a1.dtype == torch.float32 and bt1.dtype == torch.bfloat16
    assert torch.equal(a1, a2) and torch.equal(bt1, bt2)
    assert torch.equal(r(a, b=b), r(a, bt=b.T))
    with pytest.raises(ValueError, match="do not fit"):
        r.run_padded(a1[:-1], bt1)


def test_csr_order_two_d_index_above_the_flat_limit(case, monkeypatch):
    """Above M*N = 2^31 the CSR gather takes a (row, col) index; forced
    here by lowering the limit, it gives the same values."""
    _, tcsr, a, b = case
    flat = dn.DenseSDDMM.from_csr(tcsr, device="cpu")
    want = flat(a, b=b)
    assert len(flat._csr_gather()) == 1
    monkeypatch.setattr(dn, "FLAT_INDEX_LIMIT", 16)
    two_d = dn.DenseSDDMM.from_csr(tcsr, device="cpu")
    assert torch.equal(two_d(a, b=b), want)
    assert len(two_d._csr_gather()) == 2


def test_csr_order_needs_the_pattern(case):
    _, tcsr, a, b = case
    r = dn.DenseSDDMM(tcsr.m, tcsr.n, device="cpu")
    assert tuple(r(a, b=b, order="packed").shape) == (tcsr.m, tcsr.n)
    with pytest.raises(ValueError, match="from_csr"):
        r(a, b=b)
    with pytest.raises(ValueError, match="compute_dtype"):
        dn.DenseSDDMM(4, 4, compute_dtype="tf16", device="cpu")
