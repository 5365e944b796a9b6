"""The port's backward passes against ``jax.vjp`` / ``jax.grad`` of the JAX
package's same functions, on the CPU (where each backward takes its plain
version): the hybrid runner through ``device_prepare`` (a random cotangent
on every packed slot, garbage slots included), its heads against JAX's
vmap, the dense class, the CSR SDDMM and SpMM, the segment softmax from
packed scores, and both attention models.  All in "float32", inputs from
numpy seeds; the other compute modes are held to an fp64 product.

The SDDMM and SpMM cases take U[0,2) operands and cotangents, as the
forward parity tests do: a cotangent of mixed signs on a hot row's 512
slots cancels to a value that no fp32 sum order keeps within abs 1e-5 or
rel 1e-3 (JAX's own sum missed fp64 by 3e-5 there, the port's by 1e-4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.models import BlockSparseAttention as JaxBlockSparse
from sddmm_tpu.models import make_attention_mask as j_make_attention_mask
from sddmm_tpu.models.graph_attention import (
    GraphAttentionLayer as JaxGraphAttention)
from sddmm_tpu.models.graph_attention import (
    segment_softmax as j_segment_softmax)
from sddmm_tpu.ops.csr_sddmm import csr_sddmm_jax
from sddmm_tpu.ops.dense import DenseSDDMM as JaxDense
from sddmm_tpu.ops.hybrid import HybridSDDMM as JaxHybrid
from sddmm_tpu.ops.spmm import csr_spmm_jax
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch import interop
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.interop import packed_from_reference
from sddmm_tpu_torch.models import BlockSparseAttention, GraphAttentionLayer
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops import softmax as sm
from sddmm_tpu_torch.ops import spmm as sp
from sddmm_tpu_torch.ops.batch import BatchedHybridSDDMM
from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm_torch
from sddmm_tpu_torch.ops.dense import DenseSDDMM
from sddmm_tpu_torch.ops.tile_dot import STORAGE
from sddmm_tpu_torch.utils.check import check_values
from torch_native_ready import reference_native_loaded  # noqa: F401

K = 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (at 8 threads a worker the trainer's steps
    took 4x the time of one thread, alone and more so beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _contract(want, got):
    """Gradients under the reference's contract (abs 1e-5 or rel 1e-3):
    JAX's segment sums and the port's SpMM add in another order."""
    res = check_values(np.asarray(want), np.asarray(got))
    assert res.passed and res.num_errors == 0, str(res)
    assert np.isfinite(np.asarray(got)).all()


def _powerlaw():
    return jgen.powerlaw_graph(512, avg_degree=12, seed=4)


def _clustered():                    # tests/conftest.py clustered_csr
    return jgen.block_clustered(24, 20, block_prob=0.15, block_density=0.8,
                                noise_density=0.002, seed=7)


#: packings: (matrix, from_params keywords); every feature of the layout
CONFIGS = {
    "G1": (_clustered, {}),
    "G2": (_clustered, dict(group_size=2)),
    "G4C2": (_clustered, dict(group_size=4, k_chunks=2,
                              merge_superpanels=False)),
    "hub+rowslab": (_powerlaw, dict(hub_cols=128, hot_rows=64,
                                    hot_rows_pre=True)),
    "G2C2+slabs": (_powerlaw, dict(group_size=2, k_chunks=2, hub_cols=128,
                                   hot_rows=64, hot_rows_pre=True)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    gen, kw = CONFIGS[name]
    csr = gen()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05, **kw)
    rng = np.random.default_rng(len(name))
    return csr, t, _u02(rng, (csr.m, K)), _u02(rng, (csr.n, K))


def _u02(rng, shape):
    return rng.uniform(0, 2, shape).astype(np.float32)


def _pad(x):
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def _port_grads(r, a, bt, g, order="packed", plain=False):
    """(out, dA, dB^T) of the port's runner through device_prepare, the
    pads inside the differentiated function as in the JAX loss."""
    a_t = torch.tensor(a, requires_grad=True)
    bt_t = torch.tensor(bt, requires_grad=True)
    out = r.run_padded(*r.device_prepare(_pad(a_t), _pad(bt_t)),
                       order=order, plain=plain)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), a_t.grad.numpy(), bt_t.grad.numpy()


def _jax_vjp(jr, a, bt, g, order="packed"):
    def f(a_, bt_):
        z = jnp.zeros((1, a_.shape[1]), a_.dtype)
        a_ops, bt_phys = jr.device_prepare(jnp.concatenate([a_, z]),
                                           jnp.concatenate([bt_, z]))
        return jr.run_padded(a_ops, bt_phys, order=order)
    out, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(bt))
    da, dbt = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(da), np.asarray(dbt)


@pytest.mark.parametrize("name,a_layout", [
    ("G1", "rows"), ("G1", "panels"), ("G2", "rows"), ("G4C2", "panels"),
    ("hub+rowslab", "panels"), ("G2C2+slabs", "rows")])
def test_hybrid_grads_match_jax_vjp(name, a_layout):
    """dA and dB^T of run_padded through device_prepare, with a random
    cotangent on every packed slot (garbage ones too), against jax.vjp of
    the JAX runner: G 1/2/4, C 1/2, both A layouts, the hub and hot-row
    slabs and the residual."""
    csr, t, a, bt = _case(name)
    p = t.packed
    g = _u02(np.random.default_rng(9), p.packed_size)
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks,
                   a_layout=a_layout)
    _, want_a, want_bt = _jax_vjp(jr, a, bt, g)
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                       k_chunks=t.k_chunks, a_layout=a_layout, device="cpu")
    _, got_a, got_bt = _port_grads(r, a, bt, g)
    _contract(want_a, got_a)
    _contract(want_bt, got_bt)
    if a_layout == "panels":
        # the plain route (its forward reads the panel-major A) goes
        # through the same op, its backward the same read pattern's SpMM
        _, pa, pbt = _port_grads(r, a, bt, g, plain=True)
        assert np.array_equal(pa, got_a) and np.array_equal(pbt, got_bt)


def test_hybrid_csr_order_grads_and_read_pattern():
    """Through order="csr" (the gather's backward is a scatter into the
    packed slots) against jax.vjp; the read pattern lists every packed slot
    once and reads real rows and lanes at the real slots."""
    csr, t, a, bt = _case("G2C2+slabs")
    p = t.packed
    g = _u02(np.random.default_rng(3), csr.nnz)
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks)
    _, want_a, want_bt = _jax_vjp(jr, a, bt, g, order="csr")
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                       k_chunks=t.k_chunks, device="cpu")
    _, got_a, got_bt = _port_grads(r, a, bt, g, order="csr")
    _contract(want_a, got_a)
    _contract(want_bt, got_bt)
    rows, lanes, slots = r.read_pattern()
    assert np.array_equal(np.sort(slots), np.arange(p.packed_size))
    at = np.empty_like(rows)
    at[slots] = rows
    assert np.array_equal(at[p.inv_idx], csr.row_indices())
    lane_at = np.empty_like(lanes)
    lane_at[slots] = lanes
    G = p.group_size
    col_order = np.append(p.col_order, p.n)
    col = np.where(lane_at[p.inv_idx] < p.num_col_groups * G,
                   col_order[np.minimum(lane_at[p.inv_idx],
                                        len(p.col_order))], -1)
    assert np.array_equal(col, csr.col_idx)


def test_run_heads_grads_match_jax_vmap():
    """BatchedHybridSDDMM (run_heads, 3 heads, G=2, C=2, both slabs)
    against jax.vjp of the JAX runner under vmap, with a cotangent on every
    slot of every head."""
    csr, t, _, _ = _case("G2C2+slabs")
    p = t.packed
    rng = np.random.default_rng(4)
    a = _u02(rng, (3, csr.m, K))
    bt = _u02(rng, (3, csr.n, K))
    g = _u02(rng, (3, p.packed_size))
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks)

    def one(a_, bt_):
        z = jnp.zeros((1, K), a_.dtype)
        return jr.run_padded(*jr.device_prepare(jnp.concatenate([a_, z]),
                                                jnp.concatenate([bt_, z])))
    _, vjp = jax.vjp(jax.vmap(one), jnp.asarray(a), jnp.asarray(bt))
    want_a, want_bt = vjp(jnp.asarray(g))
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                       k_chunks=t.k_chunks, device="cpu")
    a_t = torch.tensor(a, requires_grad=True)
    bt_t = torch.tensor(bt, requires_grad=True)
    pad = functools.partial(torch.nn.functional.pad, pad=(0, 0, 0, 1))
    out = BatchedHybridSDDMM(r).run_padded(pad(a_t), pad(bt_t))
    out.backward(torch.from_numpy(g))
    _contract(want_a, a_t.grad)
    _contract(want_bt, bt_t.grad)


@pytest.mark.parametrize("mode", ["tf32", "mixed", "float16", "bfloat16"])
def test_hybrid_grads_other_modes_vs_fp64(mode):
    """In the modes other than "float32" the backward sums in fp32 at the
    storage-cast operands; with a cotangent on the real slots it is held
    to the fp64 product (G ⊙ S)·B and (G ⊙ S)^T·A of those operands (JAX's
    "tf32" VJP rounds its cotangent to bf16, so it is not the yardstick)."""
    csr, t, a, bt = _case("G2C2+slabs")
    p = t.packed
    g = _u02(np.random.default_rng(5), csr.nnz)
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype=mode,
                       k_chunks=t.k_chunks, device="cpu")
    _, got_a, got_bt = _port_grads(r, a, bt, g, order="csr")
    adt, bdt = STORAGE[mode]
    a_s = torch.from_numpy(a).to(adt).double().numpy()
    bt_s = torch.from_numpy(bt).to(bdt).double().numpy()
    gd = np.zeros((csr.m, csr.n))
    np.add.at(gd, (csr.row_indices(), csr.col_idx), g.astype(np.float64))
    _contract(gd @ bt_s, got_a)
    _contract(gd.T @ a_s, got_bt)


def test_hybrid_backward_is_once_differentiable():
    csr, t, a, bt = _case("G1")
    r = hy.HybridSDDMM(packed_from_reference(t.packed),
                       compute_dtype="float32", device="cpu")
    a_t = torch.tensor(a, requires_grad=True)
    out = r.run_padded(*r.device_prepare(_pad(a_t), _pad(torch.tensor(bt))))
    (da,) = torch.autograd.grad(out.square().sum(), a_t, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        da.sum().backward()


def test_dense_grads_match_jax_vjp():
    """DenseSDDMM.run_padded into CSR order against jax.vjp of the JAX
    dense class."""
    csr = jgen.random_sparse(96, 80, density=0.3, seed=6)
    rng = np.random.default_rng(6)
    a, bt = _u02(rng, (csr.m, K)), _u02(rng, (csr.n, K))
    g = _u02(rng, csr.nnz)
    jd = JaxDense.from_csr(csr, compute_dtype="float32")
    _, vjp = jax.vjp(lambda a_, b_: jd.run_padded(a_, b_, order="csr"),
                     jnp.asarray(a), jnp.asarray(bt))
    want_a, want_bt = vjp(jnp.asarray(g))
    d = DenseSDDMM.from_csr(TCSR(csr.shape, csr.row_ptr, csr.col_idx,
                                 csr.values), compute_dtype="float32",
                            device="cpu")
    a_t = torch.tensor(a, requires_grad=True)
    bt_t = torch.tensor(bt, requires_grad=True)
    out = d.run_padded(a_t, bt_t, order="csr")
    out.backward(torch.from_numpy(g))
    _contract(want_a, a_t.grad)
    _contract(want_bt, bt_t.grad)


@pytest.mark.parametrize("batch", [None, 2])
def test_csr_sddmm_grads_match_jax_vjp(batch):
    """csr_sddmm_torch (one pair, and a batch as batched_csr_sddmm runs it)
    against jax.vjp of csr_sddmm_jax (vmapped for the batch)."""
    csr = _clustered()
    rng = np.random.default_rng(7)
    lead = () if batch is None else (batch,)
    a = _u02(rng, lead + (csr.m, K))
    bt = _u02(rng, lead + (csr.n, K))
    g = _u02(rng, lead + (csr.nnz,))
    rows = csr.row_indices().astype(np.int32)
    cols = csr.col_idx.astype(np.int32)
    fn = functools.partial(csr_sddmm_jax, rows=jnp.asarray(rows),
                           cols=jnp.asarray(cols))
    if batch is not None:
        fn = jax.vmap(fn)
    _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(bt))
    want_a, want_bt = vjp(jnp.asarray(g))
    a_t = torch.tensor(a, requires_grad=True)
    bt_t = torch.tensor(bt, requires_grad=True)
    out = csr_sddmm_torch(a_t, bt_t, torch.from_numpy(rows),
                          torch.from_numpy(cols))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _contract(want_a, a_t.grad)
    _contract(want_bt, bt_t.grad)


def test_csr_spmm_grads_match_jax_vjp():
    """csr_spmm_torch's values and dense cotangents against jax.vjp of
    csr_spmm_jax, without a plan and with one, which keeps the backward's
    state (built at the first backward) for the next."""
    csr = _clustered()
    rng = np.random.default_rng(8)
    vals, dense = _u02(rng, csr.nnz), _u02(rng, (csr.n, K))
    g = _u02(rng, (csr.m, K))
    rows = csr.row_indices().astype(np.int32)
    cols = csr.col_idx.astype(np.int32)
    _, vjp = jax.vjp(lambda v, d: csr_spmm_jax(v, jnp.asarray(rows),
                                               jnp.asarray(cols), d, csr.m),
                     jnp.asarray(vals), jnp.asarray(dense))
    want_v, want_d = vjp(jnp.asarray(g))
    plan = sp.spmm_plan(csr.row_ptr, csr.col_idx)
    kept = []
    for pl in (None, plan, plan):
        v_t = torch.tensor(vals, requires_grad=True)
        d_t = torch.tensor(dense, requires_grad=True)
        out = sp.csr_spmm_torch(v_t, torch.from_numpy(rows).long(),
                                torch.from_numpy(cols), d_t, csr.m,
                                plan=pl)
        out.backward(torch.from_numpy(g))
        _contract(want_v, v_t.grad)
        _contract(want_d, d_t.grad)
        kept.append(plan.grads)
    assert kept[0] is None and kept[1] is not None and kept[2] is kept[1]


def test_segment_softmax_grads_match_jax_vjp():
    """segment_softmax_torch from 2 heads' packed scores through inv_idx
    (the models' call) against jax.vjp of the JAX segment softmax of the
    gathered, scaled scores; the padding slots get exactly 0."""
    csr = _powerlaw()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05)
    p = t.packed
    rng = np.random.default_rng(10)
    flat = (rng.standard_normal((2, p.packed_size)) * 3).astype(np.float32)
    g = rng.standard_normal((2, csr.nnz)).astype(np.float32)
    scale = 0.125
    rows = jnp.asarray(csr.row_indices().astype(np.int32))
    inv = jnp.asarray(p.inv_idx)

    def f(x):
        return jax.vmap(lambda s: j_segment_softmax(
            s[inv] * scale, rows, csr.m))(x)
    _, vjp = jax.vjp(f, jnp.asarray(flat))
    (want,) = vjp(jnp.asarray(g))
    x = torch.tensor(flat, requires_grad=True)
    got = sm.segment_softmax_torch(
        x, torch.from_numpy(csr.row_ptr.astype(np.int64)), scale,
        torch.from_numpy(p.inv_idx.astype(np.int32)))
    got.backward(torch.from_numpy(g))
    _contract(want, x.grad)
    pad = np.ones(p.packed_size, dtype=bool)
    pad[p.inv_idx] = False
    assert pad.any() and not x.grad.numpy()[:, pad].any()


def _graph_layers():
    adj = jgen.powerlaw_graph(200, avg_degree=6, seed=8)
    jl = JaxGraphAttention(adj, feature_dim=16, head_dim=8)
    params = jl.init(jax.random.PRNGKey(1))
    layer = GraphAttentionLayer(TCSR(adj.shape, adj.row_ptr, adj.col_idx,
                                     adj.values), feature_dim=16, head_dim=8,
                                device="cpu")
    interop.graph_attention_params_from_reference(params, layer)
    return adj, jl, params, layer


def test_graph_attention_grads_match_jax_grad():
    """jax.grad of sum(out^2) through the JAX layer against the port's
    backward (the SDDMM, softmax and SpMM autograd ops, the projections'
    torch autograd), weights carried across by interop; the plain path's
    gradients agree too."""
    adj, jl, params, layer = _graph_layers()
    x = jgen.make_dense(adj.m, 16, seed=2)
    want = jax.grad(lambda p_, x_: jnp.sum(jl(p_, x_) ** 2), argnums=(0, 1))(
        params, jnp.asarray(x))
    x_t = torch.tensor(x, requires_grad=True)
    layer(x_t).square().sum().backward()
    for w_want, w in zip(want[0], (layer.w_q, layer.w_k, layer.w_v)):
        _contract(w_want, w.grad)
    _contract(want[1], x_t.grad)
    grads = [w.grad.clone() for w in (layer.w_q, layer.w_k, layer.w_v)]
    layer.zero_grad()
    layer(torch.tensor(x), plain=True).square().sum().backward()
    for g_kernel, w in zip(grads, (layer.w_q, layer.w_k, layer.w_v)):
        _contract(w.grad, g_kernel)


@pytest.mark.parametrize("heads", [1, 2])
def test_block_sparse_attention_grads_match_jax_grad(heads):
    """tests/test_models.py's grad-flow case (64 positions, window 6, 2
    global tokens, causal, F = D = 8) at 1 head, and 2 heads, against
    jax.grad of sum(out^2), weights carried across by interop."""
    mask = j_make_attention_mask(64, window=6, num_global=2, causal=True)
    jm = JaxBlockSparse(mask, feature_dim=8, num_heads=heads, head_dim=8)
    params = jm.init(jax.random.PRNGKey(1))
    x = np.random.default_rng(7).standard_normal((64, 8)).astype(np.float32)
    want = jax.grad(lambda p_: jnp.sum(jm(p_, jnp.asarray(x)) ** 2))(params)
    model = BlockSparseAttention(TCSR(mask.shape, mask.row_ptr, mask.col_idx,
                                      mask.values), feature_dim=8,
                                 num_heads=heads, head_dim=8, device="cpu")
    interop.block_sparse_params_from_reference(params, model)
    out = model(torch.from_numpy(x))
    assert out.grad_fn is not None
    out.square().sum().backward()
    for w_want, w in zip(want, (model.w_q, model.w_k, model.w_v,
                                model.w_o)):
        assert np.abs(np.asarray(w_want)).max() > 0
        _contract(w_want, w.grad)


def test_training_after_serving_on_one_model():
    """Forwards under inference_mode first (they build the runner's cached
    int32 slot index and the dense class's CSR index), then a backward on
    the same objects: what they cache is no inference tensor, so autograd
    may save it."""
    _, _, params, layer = _graph_layers()
    x = torch.from_numpy(jgen.make_dense(200, 16, seed=2))
    with torch.inference_mode():
        served = layer(x)
    out = layer(x)
    assert torch.equal(out.detach(), served)
    out.square().sum().backward()
    assert layer.w_q.grad.abs().max() > 0
    csr = jgen.random_sparse(64, 48, density=0.3, seed=1)
    d = DenseSDDMM.from_csr(TCSR(csr.shape, csr.row_ptr, csr.col_idx,
                                 csr.values), compute_dtype="float32",
                            device="cpu")
    a = torch.rand(64, 8, requires_grad=True)
    with torch.inference_mode():
        d.run_padded(a.detach(), torch.rand(48, 8), order="csr")
    d.run_padded(a, torch.rand(48, 8), order="csr").sum().backward()
    assert a.grad.abs().max() > 0
