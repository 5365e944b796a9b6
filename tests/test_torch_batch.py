"""The port's batched SDDMM (``sddmm_tpu_torch.ops.batch``) against the JAX
package's ``sddmm_tpu.ops.batch``, on one packing carried across with
``interop.packed_from_reference`` and the same numpy batches."""

import functools

import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops.batch import BatchedHybridSDDMM as JaxBatched
from sddmm_tpu.ops.batch import batched_csr_sddmm as j_batched_csr_sddmm
from sddmm_tpu.ops.batch import batched_transpose as j_batched_transpose
from sddmm_tpu.ops.hybrid import HybridSDDMM as JaxHybrid
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.interop import packed_from_reference
from sddmm_tpu_torch.ops import batch as bt
from sddmm_tpu_torch.ops import batched_csr_sddmm, batched_transpose
from sddmm_tpu_torch.ops.csr_sddmm import csr_plan
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM

# "float32" on both sides: JAX's CPU backend takes the exact fp32 dot, the
# port the six-product bf16 split, within about one fp32 rounding; sums in
# another order
RTOL = 1e-5
# the CSR path: exact fp32 products on both sides, another sum order
CSR_RTOL = 1e-6
BATCH = 3


def _batches(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 2, (BATCH, m, k)).astype(np.float32),
            rng.uniform(0, 2, (BATCH, k, n)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _case(name):
    csr = jgen.block_clustered(24, 20, block_prob=0.15, block_density=0.8,
                               noise_density=0.002, seed=7)
    kw = {"G1": {}, "G2C2+hub": dict(group_size=2, k_chunks=2,
                                     hub_cols=64)}[name]
    t = j_from_params(csr, 32, alpha=0.3, delta=0.05, **kw)
    return csr, t


@pytest.mark.parametrize("pattern", ["random", "clustered"])
@pytest.mark.parametrize("K", [24, 32])
def test_batched_csr_sddmm_matches_jax(K, pattern):
    """The batch in one gather-dot call (a head stride), walking the
    pattern's plan: the entry order on a random pattern, groups of rows
    that share columns on a clustered one (rows shuffled)."""
    csr = (jgen.random_sparse(120, 90, density=0.06, seed=3)
           if pattern == "random" else
           jgen.block_clustered(12, 12, block_prob=0.2, block_density=0.7,
                                seed=3))
    if pattern == "clustered":
        assert csr_plan(TCSR(csr.shape, csr.row_ptr, csr.col_idx,
                             csr.values)).grouped
    a, b = _batches(csr.m, csr.n, K, seed=K)
    want = j_batched_csr_sddmm(a, b, csr)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    got = batched_csr_sddmm(a, b, tcsr, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (BATCH, csr.nnz)
    np.testing.assert_allclose(got, want, rtol=CSR_RTOL)


@pytest.mark.parametrize("name", ["G1", "G2C2+hub"])
def test_batched_hybrid_matches_jax(name):
    csr, t = _case(name)
    p = t.packed
    a, b = _batches(csr.m, csr.n, 32, seed=1)
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks)
    want = np.asarray(JaxBatched(jr)(a, b))
    r = HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                    k_chunks=t.k_chunks, device="cpu")
    got = bt.BatchedHybridSDDMM(r)(a, b)
    assert got.shape == want.shape == (BATCH, p.packed_size)
    real = p.inv_idx
    np.testing.assert_allclose(got[:, real], want[:, real], rtol=RTOL)


def test_batched_run_padded_csr_order_is_per_element():
    """order="csr" of the batch is each element's own call, stacked."""
    csr, t = _case("G2C2+hub")
    r = HybridSDDMM(packed_from_reference(t.packed), compute_dtype="float32",
                    k_chunks=t.k_chunks, device="cpu")
    a, b = _batches(csr.m, csr.n, 32, seed=2)
    a_pad = bt._pad_rows(torch.from_numpy(a))
    bt_pad = bt._pad_rows(batched_transpose(torch.from_numpy(b)))
    got = bt.BatchedHybridSDDMM(r).run_padded(a_pad, bt_pad, order="csr")
    assert tuple(got.shape) == (BATCH, csr.nnz)
    for i in range(BATCH):
        assert torch.equal(got[i], r(a[i], b[i]))
    plain = bt.BatchedHybridSDDMM(r).run_padded(a_pad, bt_pad, order="csr",
                                                plain=True)
    assert torch.equal(got, plain)
    with pytest.raises(ValueError, match="want a_pad"):
        bt.BatchedHybridSDDMM(r).run_padded(a_pad[0], bt_pad)
    with pytest.raises(ValueError, match="want a_pad"):
        bt.BatchedHybridSDDMM(r).run_padded(a_pad, bt_pad[:2])


def test_batched_transpose_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7)).astype(
        np.float32)
    got = batched_transpose(torch.from_numpy(x))
    assert got.is_contiguous()
    assert np.array_equal(got.numpy(), np.asarray(j_batched_transpose(x)))


def test_batch_overlap_report_needs_the_card():
    _, t = _case("G1")
    r = HybridSDDMM(packed_from_reference(t.packed), device="cpu")
    a, b = _batches(r.packed.m, r.packed.n, 32, seed=0)
    with pytest.raises(RuntimeError, match="card"):
        bt.batch_overlap_report(r, a, b)
