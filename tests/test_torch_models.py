"""The port's attention models (``sddmm_tpu_torch.models``) against the JAX
package's ``sddmm_tpu.models``, on weights carried across by ``interop``
and the same numpy inputs.  Both run in the models' default "float32"
mode; on the CPU the port's kernels take their plain versions."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.data.sparse import COO as JCOO
from sddmm_tpu.models import BlockSparseAttention as JaxBlockSparse
from sddmm_tpu.models import make_attention_mask as j_make_attention_mask
from sddmm_tpu.models.block_sparse_attention import (
    dense_reference_attention as j_dense_reference_attention)
from sddmm_tpu.models.graph_attention import (
    GraphAttentionLayer as JaxGraphAttention)
from sddmm_tpu.models.graph_attention import (
    GraphAttentionParams as JaxGraphParams)
from sddmm_tpu.models.graph_attention import (
    segment_softmax as j_segment_softmax)
from sddmm_tpu_torch import interop
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.entry import entry
from sddmm_tpu_torch.models import (BlockSparseAttention,
                                    GraphAttentionLayer,
                                    dense_reference_attention,
                                    make_attention_mask, segment_softmax)
from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm_torch
from sddmm_tpu_torch.ops.dense import DenseSDDMM
from sddmm_tpu_torch.ops.spmm import HeadAggregation
from torch_native_ready import reference_native_loaded  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# The scores match within about one fp32 rounding (JAX's CPU backend takes
# the exact fp32 dot, the port the six-product bf16 split), and the softmax
# and aggregation sum in another order: JAX in packed-slot order through
# segment sums, the port in CSR order.
RTOL, ATOL = 1e-5, 1e-6
# against the fp64 dense oracle: the fp32 forward's own roundings
ORACLE_RTOL, ORACLE_ATOL = 1e-4, 1e-5


def _tcsr(csr):
    return TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)


def _full_graph(n):
    rows, cols = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return JCOO((n, n), rows.ravel(), cols.ravel(), np.ones(n * n)).to_csr()


def _graph_case(name):
    """(adjacency, F, D, PRNG seed, x seed): the JAX tests' own cases."""
    if name == "powerlaw200":
        return jgen.powerlaw_graph(200, avg_degree=6, seed=8), 16, 8, 1, 2
    if name == "dense12":
        return _full_graph(12), 8, 4, 3, 5
    return jgen.block_clustered(8, 8, block_prob=0.25, seed=5), 32, 32, 0, 1


@pytest.mark.parametrize("name", ["powerlaw200", "dense12", "entry"])
def test_graph_attention_matches_jax(name):
    adj, F, D, key, xseed = _graph_case(name)
    jl = JaxGraphAttention(adj, feature_dim=F, head_dim=D)
    params = jl.init(jax.random.PRNGKey(key))
    x = jgen.make_dense(adj.m, F, seed=xseed)
    want = np.asarray(jl(params, jnp.asarray(x)))
    layer = GraphAttentionLayer(_tcsr(adj), feature_dim=F, head_dim=D,
                                device="cpu")
    interop.graph_attention_params_from_reference(params, layer)
    with torch.inference_mode():
        got = layer(torch.from_numpy(x))
    assert got.shape == (adj.m, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a node with no edges outputs exact zeros
    empty = np.nonzero(adj.row_nnz() == 0)[0]
    if name == "powerlaw200":
        assert len(empty)
    assert not got.numpy()[empty].any()
    # plain=True is the same computation on the CPU
    with torch.inference_mode():
        assert torch.equal(layer(torch.from_numpy(x), plain=True), got)


def test_graph_attention_matches_dense_softmax_attention():
    """On the fully connected 12-node graph the layer is dense softmax
    attention (the JAX test's oracle, here in fp64)."""
    adj, F, D, _, _ = _graph_case("dense12")
    layer = GraphAttentionLayer(_tcsr(adj), feature_dim=F, head_dim=D,
                                device="cpu")
    p = layer.init(torch.Generator().manual_seed(3))
    x = torch.from_numpy(jgen.make_dense(adj.m, F, seed=5))
    with torch.inference_mode():
        got = layer(x)
    q, k, v = (x.double() @ w.double() for w in p)
    s = q @ k.T / np.sqrt(D)
    want = torch.softmax(s, dim=1) @ v
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL)


def test_entry_matches_jax_layer():
    """The port's entry (128 nodes, F = D = 32) against the JAX layer on
    the entry's own weights, carried the other way."""
    fn, (x,) = entry("cpu")
    got = fn(x)
    assert got.shape == (128, 32) and torch.isfinite(got).all()
    assert got.grad_fn is None
    layer = fn.layer
    adj = jgen.block_clustered(8, 8, block_prob=0.25, seed=5)
    jl = JaxGraphAttention(adj, feature_dim=32, head_dim=32)
    params = JaxGraphParams(*(jnp.asarray(w.numpy())
                              for w in layer.params()))
    want = np.asarray(jl(params, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["test_models", "random_unsorted"])
def test_segment_softmax_matches_jax(case):
    if case == "test_models":
        rows = np.array([0, 0, 0, 1, 1, 3], dtype=np.int32)
        scores = np.array([1.0, 2.0, 3.0, -1.0, 1.0, 0.5], dtype=np.float32)
        num_rows = 4
    else:
        rng = np.random.default_rng(9)
        num_rows = 50
        rows = rng.integers(0, num_rows, 700).astype(np.int32)
        rows = rows[rows % 7 != 3]          # some rows left empty
        scores = (rng.standard_normal(len(rows)) * 4).astype(np.float32)
    want = np.asarray(j_segment_softmax(jnp.asarray(scores),
                                        jnp.asarray(rows), num_rows))
    got = segment_softmax(torch.from_numpy(scores), torch.from_numpy(rows),
                          num_rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    sums = torch.zeros(num_rows, dtype=torch.float64).index_add_(
        0, torch.from_numpy(rows).long(), got.double())
    present = np.unique(rows)
    np.testing.assert_allclose(sums.numpy()[present], 1.0, rtol=RTOL)


def test_attention_mask_matches_jax():
    for kw in (dict(window=8, num_global=3), dict(window=6, num_global=2,
                                                  causal=True),
               dict(window=12)):
        want = j_make_attention_mask(96, **kw)
        got = make_attention_mask(96, **kw)
        assert got.shape == want.shape
        assert np.array_equal(got.row_ptr, want.row_ptr)
        assert np.array_equal(got.col_idx, want.col_idx)


def _block_case(causal, a_layout="rows"):
    mask = j_make_attention_mask(160, window=12, num_global=4, causal=causal)
    jm = JaxBlockSparse(mask, feature_dim=24, num_heads=2, head_dim=16,
                        a_layout=a_layout)
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(5).standard_normal((160, 24)).astype(
        np.float32)
    model = BlockSparseAttention(_tcsr(mask), feature_dim=24, num_heads=2,
                                 head_dim=16, a_layout=a_layout, device="cpu")
    interop.block_sparse_params_from_reference(params, model)
    return mask, jm, params, x, model


@pytest.mark.parametrize("causal", [False, True], ids=["window",
                                                       "causal"])
def test_block_sparse_attention_matches_jax(causal):
    mask, jm, params, x, model = _block_case(causal)
    want = np.asarray(jm(params, x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (160, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the port's fp64 oracle, and the JAX package's
    oracle = dense_reference_attention(model.params(), x, _tcsr(mask))
    assert oracle.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), oracle.numpy(),
                               rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
    j_oracle = j_dense_reference_attention(
        params, x.astype(np.float64), mask)
    np.testing.assert_allclose(oracle.numpy(), j_oracle, rtol=1e-10,
                               atol=1e-12)


def test_block_sparse_attention_panels_layout():
    """a_layout is passed through to the runner, as in the JAX model."""
    mask, jm, params, x, model = _block_case(False, a_layout="panels")
    assert model.runner.a_layout == "panels"
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        plain = model(torch.from_numpy(x), plain=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(params, x)),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, plain)


def test_attention_layers_hold_one_copy_of_the_mask():
    """The block-sparse layer of 2 heads and the graph layer aggregate
    through their attention core's ``HeadAggregation``, one copy of the
    mask for all heads: as many column ids as the mask has entries, not
    heads times that."""
    mask, _, _, _, model = _block_case(False)
    adj, F, D, _, _ = _graph_case("powerlaw200")
    layer = GraphAttentionLayer(_tcsr(adj), feature_dim=F, head_dim=D,
                                device="cpu")
    assert model.num_heads == 2
    for m, pattern in ((model, mask), (layer, adj)):
        agg = m.core.agg
        assert isinstance(agg, HeadAggregation)
        assert agg.shape == pattern.shape
        assert agg.cols.shape == (pattern.nnz,)


def test_interop_rejects_wrong_shapes():
    adj, F, D, key, _ = _graph_case("dense12")
    params = JaxGraphAttention(adj, feature_dim=F, head_dim=D).init(
        jax.random.PRNGKey(key))
    layer = GraphAttentionLayer(_tcsr(adj), feature_dim=F, head_dim=D + 1,
                                device="cpu")
    with pytest.raises(ValueError, match="weight"):
        interop.graph_attention_params_from_reference(params, layer)
    _, _, bparams, _, model = _block_case(False)
    with pytest.raises(ValueError, match="weight"):
        interop.block_sparse_params_from_reference(params, model)
    assert interop.block_sparse_params_from_reference(bparams, model) is model


def test_forward_raises_on_grad_requiring_operands():
    """Once a guard that raised (there was no backward pass); now a forward
    that autograd differentiates returns values with a grad_fn, on the CPU
    as on the card, and finite gradients reach every weight and input:
    both models, the runners, the dense class and csr_sddmm_torch.  Under
    no_grad nothing is recorded."""
    adj, F, D, _, _ = _graph_case("dense12")
    layer = GraphAttentionLayer(_tcsr(adj), feature_dim=F, head_dim=D,
                                device="cpu")
    layer.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(jgen.make_dense(adj.m, F, seed=5))
    assert all(p.requires_grad for p in layer.parameters())
    out = layer(x)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for w in layer.parameters():
        assert torch.isfinite(w.grad).all() and w.grad.abs().max() > 0
    mask, _, _, xb, model = _block_case(True)
    xb = torch.from_numpy(xb).requires_grad_()
    model(xb).sum().backward()
    assert torch.isfinite(xb.grad).all() and xb.grad.abs().max() > 0
    assert all(w.grad is not None for w in model.parameters())
    with torch.no_grad():
        assert layer(x.requires_grad_()).grad_fn is None
    # the runners' own calls
    r = layer.runner
    q = torch.ones((adj.m + 1, D), requires_grad=True)
    r.run_padded(q, q.detach()).sum().backward()
    assert q.grad.abs().max() > 0
    dense = DenseSDDMM(4, 4, device="cpu")
    a = torch.ones(4, 8, requires_grad=True)
    dense.run_padded(a, torch.ones(4, 8)).sum().backward()
    assert torch.equal(a.grad, torch.full((4, 8), 4.0))
    idx = torch.zeros(3, dtype=torch.int32)
    bt = torch.ones(4, 8, requires_grad=True)
    csr_sddmm_torch(torch.ones(4, 8), bt, idx, idx).sum().backward()
    assert bt.grad[0].tolist() == [3.0] * 8 and not bt.grad[1:].any()


def test_models_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import sddmm_tpu_torch.models, sddmm_tpu_torch.entry\n"
         "import sddmm_tpu_torch.ops.spmm, sddmm_tpu_torch.ops.batch\n"
         "assert 'jax' not in sys.modules, 'jax loaded'\n"
         "assert 'sddmm_tpu' not in sys.modules, 'sddmm_tpu loaded'\n"
         "print('clean')\n"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
