"""The port's hybrid SDDMM slice against the JAX package's, on one packing.

The packing is built once in the JAX package and carried across with
``interop.packed_from_reference``; both runners get the same numpy A and B.
The JAX side runs its Pallas tile dot in interpret mode, as the JAX
package's own tests do on the CPU."""

import functools

import jax
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops import pallas_tiles
from sddmm_tpu.ops.hybrid import HybridSDDMM as JaxHybrid
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.interop import operands_from_numpy, packed_from_reference
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.utils.check import check_values

K = 128
# Port vs JAX on real slots: the same bf16x3 (or exact fp32) products,
# summed in another order.
PARITY_REL = 1e-5
CLUSTERED16 = dict(alpha=0.2, delta=0.05, b_cost_scale=2.0)  # k128 config


@pytest.fixture(scope="module")
def pallas_interpret():
    """Route the JAX hybrid's Pallas tile dot through interpret mode.  The
    caches are cleared first: a trace made without interpret mode stays in
    ``_hybrid_packed_jit``'s cache and would be reused."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_tiles, "tile_dot_padded",
               functools.partial(pallas_tiles.tile_dot_padded,
                                 interpret=True))
    jax.clear_caches()
    yield
    mp.undo()
    jax.clear_caches()


def _case(name):
    if name == "quick1024":      # bench.py --quick clustered16, 1024 x 1024
        csr = jgen.block_clustered(64, 64, block_prob=0.08,
                                   block_density=0.7,
                                   noise_density=0.0005, seed=42)
    else:                        # tests/conftest.py clustered_csr
        csr = jgen.block_clustered(24, 20, block_prob=0.15,
                                   block_density=0.8, noise_density=0.002,
                                   seed=7)
    t = j_from_params(csr, K, **CLUSTERED16)
    a = jgen.make_dense(csr.m, K, seed=1)
    b = jgen.make_dense(K, csr.n, seed=2)
    return csr, t.packed, a, b


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in ("quick1024", "conftest")}


def _jax_packed(packed, a, b, compute_dtype, a_layout):
    r = JaxHybrid(packed, compute_dtype=compute_dtype, a_layout=a_layout,
                  use_pallas=compute_dtype == "tf32")
    a_ops, bt = r.prepare_operands(a, b=b)
    return np.asarray(r.run_padded(a_ops, bt, order="packed"))


def _port(packed, a, b, compute_dtype, a_layout):
    r = hy.HybridSDDMM(packed_from_reference(packed),
                       compute_dtype=compute_dtype, a_layout=a_layout,
                       use_pallas=True)
    ops = operands_from_numpy(r, a, b)
    flat = r.run_padded(*ops, order="packed")
    return r, flat, r.run_padded(*ops, order="csr")


@pytest.mark.parametrize("compute_dtype", ["tf32", "float32"])
@pytest.mark.parametrize("a_layout", ["panels", "rows"])
@pytest.mark.parametrize("name", ["quick1024", "conftest"])
def test_slice_matches_jax(name, a_layout, compute_dtype, cases,
                           pallas_interpret):
    csr, packed, a, b = cases[name]
    want = _jax_packed(packed, a, b, compute_dtype, a_layout)
    runner, flat, csr_vals = _port(packed, a, b, compute_dtype, a_layout)
    assert flat.shape == (packed.packed_size,) and flat.dtype == torch.float32
    real = packed.inv_idx                    # the packed slot of each nnz
    got = flat.numpy()[real]
    rel = np.abs(got - want[real]) / np.abs(want[real])
    assert rel.max() <= PARITY_REL, rel.max()
    assert np.array_equal(csr_vals.numpy(), flat.numpy()[real])
    res = check_values(sddmm_reference(a, b, csr), csr_vals.numpy())
    assert res.passed and res.num_errors == 0, str(res)


def test_dense_tiles_go_through_tile_dot(cases, monkeypatch):
    """Every dense segment of a tf32 call reaches tile_dot_bf16x3 (the
    kernel's wrapper), once per (family, bucket) segment."""
    _, packed, a, b = cases["quick1024"]
    calls = []
    real = hy.tile_dot_bf16x3

    def spy(a_run, bg, out=None):
        calls.append(tuple(a_run.shape))
        return real(a_run, bg, out=out)

    monkeypatch.setattr(hy, "tile_dot_bf16x3", spy)
    r = hy.HybridSDDMM(packed_from_reference(packed), a_layout="panels")
    r.run_padded(*operands_from_numpy(r, a, b))
    n_segments = sum(len(getattr(packed, f + "_buckets"))
                     for f in ("super", "quad", "pair", "group"))
    assert len(calls) == n_segments > 0


def test_plain_flag_gives_same_values(cases):
    _, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), a_layout="panels")
    ops = operands_from_numpy(r, a, b)
    assert torch.equal(r.run_padded(*ops), r.run_padded(*ops, plain=True))


def test_packed_rows_cols_and_from_csr(cases):
    csr, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed))
    assert np.array_equal(r.packed_rows.numpy(), packed.packed_rows)
    assert np.array_equal(r.packed_cols.numpy(), packed.packed_cols)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    r2 = hy.HybridSDDMM.from_csr(tcsr, 0.3, 0.3)
    res = check_values(sddmm_reference(a, b, csr), r2(a, b).numpy())
    assert res.passed, str(res)


def test_packed_from_reference_copies(cases):
    _, packed, _, _ = cases["conftest"]
    p = packed_from_reference(packed)
    assert p.res_rows is not packed.res_rows
    assert np.array_equal(p.res_rows, packed.res_rows)
    assert p.super_buckets == packed.super_buckets


def test_residual_gather_dot_matches_jax_formula():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 2, (65, 96)).astype(np.float32)
    bt = rng.uniform(0, 2, (81, 96)).astype(np.float32)
    rows = rng.integers(0, 65, 500).astype(np.int32)
    gids = rng.integers(0, 81, 500).astype(np.int32)
    want = np.asarray(jax.numpy.sum(jax.numpy.asarray(a)[rows]
                                    * jax.numpy.asarray(bt)[gids], axis=-1))
    got = hy.residual_gather_dot(*map(torch.from_numpy, (a, bt, rows, gids)))
    assert np.abs(got.numpy() - want).max() / np.abs(want).min() <= 1e-6
    before = hy.residual_gather_dot.launches
    out = torch.empty(500)
    hy.residual_gather_dot(*map(torch.from_numpy, (a, bt, rows, gids)),
                           out=out)
    assert torch.equal(out, got) and hy.residual_gather_dot.launches == before
    with pytest.raises(TypeError):
        hy.residual_gather_dot(*map(torch.from_numpy,
                                    (a, bt, rows.astype(np.int64), gids)))


@pytest.mark.parametrize("kw", [dict(group_size=2), dict(hub_cols=128),
                                dict(hot_rows=64, hot_rows_pre=True)],
                         ids=["G2", "hub", "rowslab"])
def test_out_of_slice_configs_raise(kw):
    csr = jgen.powerlaw_graph(512, avg_degree=12, seed=4)
    t = j_from_params(csr, K, alpha=0.3, delta=0.05, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hy.HybridSDDMM(packed_from_reference(t.packed))


@pytest.mark.parametrize("kw", [dict(k_chunks=2),
                                dict(compute_dtype="mixed"),
                                dict(compute_dtype="bfloat16")])
def test_out_of_slice_options_raise(kw, cases):
    _, packed, _, _ = cases["conftest"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hy.HybridSDDMM(packed_from_reference(packed), **kw)


def test_panels_layout_needs_panel_operands(cases):
    _, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), a_layout="panels")
    (a_pad, _), bt = operands_from_numpy(r, a, b)
    with pytest.raises(ValueError):
        r.run_padded(a_pad, bt)
