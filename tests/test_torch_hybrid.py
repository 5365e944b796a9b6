"""The port's hybrid SDDMM against the JAX package's, on one packing.

The packing is built once in the JAX package and carried across with
``interop.packed_from_reference``; both runners get the same numpy A and B.
At G=1 in "tf32" the JAX side runs its Pallas tile dot in interpret mode, as
the JAX package's own tests do on the CPU."""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops import pallas_tiles
from sddmm_tpu.ops.hybrid import HybridSDDMM as JaxHybrid
from sddmm_tpu.ops.hybrid import build_bt_phys as j_build_bt_phys
from sddmm_tpu.ops.hybrid import sddmm_hybrid as j_sddmm_hybrid
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch import _kernels, sddmm_hybrid
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.interop import operands_from_numpy, packed_from_reference
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops.gather_plan import gather_plan, plan_entries
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.utils.check import check_values
from torch_native_ready import reference_native_loaded  # noqa: F401

K = 128
# Port vs JAX on real slots where both compute the same products (the
# Pallas bf16x3 in interpret mode, or the same bf16 planes in "mixed",
# "float16" and "bfloat16"), summed in another order.
PARITY_REL = 1e-5
# "tf32" where the JAX side does not reach Pallas (G>1, the slabs): its CPU
# backend computes Precision.HIGH in full fp32, while the port keeps the
# bf16x3 split.  Per product the split drops al.bl and the rounding of each
# lo, each at most 2^-18 relative, and U[0,2) sums have no cancellation:
# the bound is 3 * 2^-18 (measured at most 2.1e-6).
SPLIT_REL = 3 * 2.0 ** -18
CLUSTERED16 = dict(alpha=0.2, delta=0.05, b_cost_scale=2.0)  # k128 config
MODES = ("tf32", "float32", "mixed", "float16", "bfloat16")
# modes that pass the reference's contract (ops/hybrid.py docstring)
CONTRACT_MODES = ("tf32", "float32", "mixed")


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


def _jax_packed(packed, a, b, compute_dtype, a_layout, k_chunks=1):
    r = JaxHybrid(packed, compute_dtype=compute_dtype, a_layout=a_layout,
                  use_pallas=compute_dtype == "tf32", k_chunks=k_chunks)
    a_ops, bt = r.prepare_operands(a, b=b)
    return np.asarray(r.run_padded(a_ops, bt, order="packed"))


def _port(packed, a, b, compute_dtype, a_layout, k_chunks=1):
    r = hy.HybridSDDMM(packed_from_reference(packed),
                       compute_dtype=compute_dtype, a_layout=a_layout,
                       use_pallas=True, k_chunks=k_chunks, device="cpu")
    ops = operands_from_numpy(r, a, b)
    flat = r.run_padded(*ops, order="packed")
    return r, flat, r.run_padded(*ops, order="csr")


def _assert_matches_jax(csr, packed, a, b, mode, a_layout, k_chunks, tol,
                        contract):
    """Real slots against the JAX runner within ``tol``; CSR order is the
    real slots; the reference's contract where the mode passes it."""
    want = _jax_packed(packed, a, b, mode, a_layout, k_chunks)
    _, flat, csr_vals = _port(packed, a, b, mode, a_layout, k_chunks)
    assert flat.shape == (packed.packed_size,) and flat.dtype == torch.float32
    real = packed.inv_idx                    # the packed slot of each nnz
    got = flat.numpy()[real]
    rel = np.abs(got - want[real]) / np.abs(want[real])
    assert rel.max() <= tol, rel.max()
    assert np.array_equal(csr_vals.numpy(), got)
    if contract:
        res = check_values(sddmm_reference(a, b, csr), csr_vals.numpy())
        assert res.passed and res.num_errors == 0, str(res)


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
    """Every dense segment of a tf32 call reaches the tile kernel's wrapper
    (``tile_table``) in one call, whose table holds each (family, bucket)
    segment's runs, never as a plain call."""
    _, packed, a, b = cases["quick1024"]
    calls = []
    real = hy.tile_table

    def spy(a_pad, bt, table, mode, out, accumulate=False):
        calls.append((tuple(a_pad.shape), table, mode))
        return real(a_pad, bt, table, mode, out, accumulate=accumulate)

    monkeypatch.setattr(hy, "tile_table", spy)
    r = hy.HybridSDDMM(packed_from_reference(packed), a_layout="panels",
                       device="cpu")
    r.run_padded(*operands_from_numpy(r, a, b))
    n_segments = sum(len(getattr(packed, f + "_buckets"))
                     for f in ("super", "quad", "pair", "group"))
    assert len(calls) == 1 and n_segments > 0
    (shape, table, mode), = calls
    assert mode == "tf32" and shape == (1, packed.m + 1, K)
    # one entry per run, 64-row window and 128-lane group of b*128 lanes
    n_windows = sum(
        n_runs * -(-getattr(packed, f + "_rows").shape[1] // 64) * b_
        for f in ("super", "quad", "pair", "group")
        for b_, _, n_runs in getattr(packed, f + "_buckets"))
    assert table.n_entries == n_windows


def test_plain_flag_gives_same_values(cases):
    _, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), a_layout="panels",
                       device="cpu")
    ops = operands_from_numpy(r, a, b)
    assert torch.equal(r.run_padded(*ops), r.run_padded(*ops, plain=True))


def test_packed_rows_cols_and_from_csr(cases):
    csr, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), device="cpu")
    assert np.array_equal(r.packed_rows.numpy(), packed.packed_rows)
    assert np.array_equal(r.packed_cols.numpy(), packed.packed_cols)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    r2 = hy.HybridSDDMM.from_csr(tcsr, 0.3, 0.3, device="cpu")
    res = check_values(sddmm_reference(a, b, csr), r2(a, b).numpy())
    assert res.passed, str(res)


def test_packed_from_reference_copies(cases):
    _, packed, _, _ = cases["conftest"]
    p = packed_from_reference(packed)
    assert p.res_rows is not packed.res_rows
    assert np.array_equal(p.res_rows, packed.res_rows)
    assert p.super_buckets == packed.super_buckets


def test_packed_from_reference_carries_slabs_and_members():
    _, t, _, _ = _config_case("G2C2+slabs")
    q = packed_from_reference(t.packed)
    assert q.group_size == 2 and q.hub_cols == t.packed.hub_cols > 0
    for f in ("res_member", "rowslab_rows", "rowslab_rank", "rowslab_csr"):
        x, y = getattr(t.packed, f), getattr(q, f)
        assert y is not x and np.array_equal(x, y), f
    assert q.res_member.max() == 1


@pytest.mark.parametrize("G,C", [(1, 1), (2, 1), (4, 2)])
def test_residual_gather_dot_matches_jax_formula(G, C):
    """The gather-dot's CPU path against the JAX residual's formula
    (take, one-hot member select, fp32 row sums over the chunks)."""
    jnp = jax.numpy
    rng = np.random.default_rng(3)
    kc = 96 // C
    a = rng.uniform(0, 2, (65, 96)).astype(np.float32)
    bt = rng.uniform(0, 2, (C, 81, G * kc)).astype(np.float32)
    rows = rng.integers(0, 65, 500).astype(np.int32)
    gids = rng.integers(0, 81, 500).astype(np.int32)
    member = rng.integers(0, G, 500).astype(np.int32)
    onehot = jnp.asarray(member)[:, None] == jnp.arange(G)[None, :]
    want = 0
    for c in range(C):
        br = jnp.asarray(bt[c])[gids].reshape(500, G, kc)
        br = jnp.sum(br * onehot[:, :, None], axis=1)
        want = want + jnp.sum(jnp.asarray(a)[rows, c * kc:(c + 1) * kc]
                              * br, axis=-1)
    want = np.asarray(want)
    args = [torch.from_numpy(x) for x in (a, bt, rows, gids)] + [
        torch.from_numpy(member) if G > 1 else None]
    got = hy.residual_gather_dot(*args)
    assert np.abs(got.numpy() - want).max() / np.abs(want).min() <= 1e-6
    before = dict(_kernels.launches)
    out = torch.empty(500)
    hy.residual_gather_dot(*args, out=out)
    assert torch.equal(out, got) and dict(_kernels.launches) == before
    with pytest.raises(TypeError):
        hy.residual_gather_dot(args[0], args[1], args[2].long(), *args[3:])
    if G > 1:
        with pytest.raises(ValueError, match="member"):
            hy.residual_gather_dot(*args[:4])


def _powerlaw():
    return jgen.powerlaw_graph(512, avg_degree=12, seed=4)


def _clustered():                    # tests/conftest.py clustered_csr
    return jgen.block_clustered(24, 20, block_prob=0.15, block_density=0.8,
                                noise_density=0.002, seed=7)


#: packings beyond G=1, C=1 without slabs: (matrix, from_params keywords)
CONFIGS = {
    "G2": (_clustered, dict(group_size=2)),
    "G4": (_clustered, dict(group_size=4, merge_superpanels=False)),
    "hub": (_powerlaw, dict(hub_cols=128)),
    "rowslab": (_powerlaw, dict(hot_rows=64, hot_rows_pre=True)),
    "hub+rowslab": (_powerlaw, dict(hub_cols=128, hot_rows=64,
                                    hot_rows_pre=True)),
    "C2": (_clustered, dict(k_chunks=2)),
    "G2C2+slabs": (_powerlaw, dict(group_size=2, k_chunks=2, hub_cols=128,
                                   hot_rows=64, hot_rows_pre=True)),
}


@functools.lru_cache(maxsize=None)
def _config_case(name):
    gen, kw = CONFIGS[name]
    csr = gen()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05, **kw)
    a = jgen.make_dense(csr.m, K, seed=1)
    b = jgen.make_dense(K, csr.n, seed=2)
    return csr, t, a, b


@pytest.mark.parametrize("a_layout", ["rows", "panels"])
@pytest.mark.parametrize("name", ["G2", "G4", "hub", "rowslab",
                                  "hub+rowslab", "C2"])
def test_configs_match_jax(name, a_layout, pallas_interpret):
    """G>1, C>1 and both slabs in "tf32" against the JAX runner, which
    computes them without Pallas (SPLIT_REL)."""
    csr, t, a, b = _config_case(name)
    p = t.packed
    assert (p.group_size > 1 or t.k_chunks > 1 or p.hub_cols
            or p.rowslab_rows is not None), "the case must leave G=1, C=1"
    _assert_matches_jax(csr, p, a, b, "tf32", a_layout, t.k_chunks,
                        SPLIT_REL, contract=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["conftest", "G2C2+slabs"])
def test_modes_match_jax(name, mode, cases, pallas_interpret):
    if name == "conftest":
        csr, packed, a, b = cases[name]
        k_chunks = 1
    else:
        csr, t, a, b = _config_case(name)
        packed, k_chunks = t.packed, t.k_chunks
    tol = (SPLIT_REL if mode == "tf32" and name != "conftest"
           else PARITY_REL)
    _assert_matches_jax(csr, packed, a, b, mode, "panels", k_chunks, tol,
                        contract=mode in CONTRACT_MODES)


@pytest.mark.parametrize("mode", ["tf32", "float32"])
@pytest.mark.parametrize("name,k,C", [
    ("clustered", 1, 1), ("clustered", 4, 1), ("clustered", 8, 1),
    ("clustered", 24, 1), ("clustered", 24, 2), ("slabs", 24, 1)])
def test_any_k_matches_jax(name, k, C, mode, pallas_interpret):
    """K (and kc = K/C) off the tile kernel's 16-step, which tile_dot pads
    with zeros before a launch: every segment, chunk and slab against the
    JAX runner, which takes any K."""
    csr = _clustered() if name == "clustered" else _powerlaw()
    kw = (dict(hub_cols=128, hot_rows=64, hot_rows_pre=True)
          if name == "slabs" else {})
    t = j_from_params(csr, k, alpha=0.3, delta=0.05, k_chunks=C, **kw)
    p = t.packed
    assert t.k_chunks == C and (p.nnz_res > 0 if name == "clustered" else
                                p.hub_cols and p.rowslab_rows is not None)
    a = jgen.make_dense(csr.m, k, seed=1)
    b = jgen.make_dense(k, csr.n, seed=2)
    # the JAX side reaches Pallas only for "tf32" segments at C = 1
    tol = (PARITY_REL if mode == "float32" or (C == 1 and name == "clustered")
           else SPLIT_REL)
    _assert_matches_jax(csr, p, a, b, mode, "panels", C, tol, contract=True)


def test_hot_row_slab_slots():
    """A hot entry's slot is rowslab_base + hot_index * NG*G + rank (not
    rank - H): its value there is its own dot product."""
    csr, t, a, b = _config_case("hub+rowslab")
    p = t.packed
    r = hy.HybridSDDMM(packed_from_reference(p), device="cpu")
    flat = r.run_padded(*operands_from_numpy(r, a, b)).numpy()
    hot_index = {row: i for i, row in enumerate(p.rowslab_rows)
                 if row < p.m}
    base = p.packed_size - p.nnz_res - p.rowslab_nrows * p.rowslab_width
    slots = base + np.array([hot_index[r_] for r_ in p.rowslab_erows]) \
        * p.rowslab_width + p.rowslab_rank
    want = sddmm_reference(a, b, csr)[p.rowslab_csr]
    assert len(slots) > 0 and p.hub_cols > 0
    np.testing.assert_allclose(flat[slots], want, rtol=SPLIT_REL)


@pytest.mark.parametrize("G,C", [(1, 1), (2, 1), (4, 2)])
def test_device_prepare_matches_build_bt_phys(G, C):
    """The port's device_bt_phys (torch ops) builds the JAX package's
    host layout bit for bit."""
    csr = _clustered()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05, group_size=G,
                      k_chunks=C)
    b = jgen.make_dense(K, csr.n, seed=2)
    bt_pad = np.concatenate([b.T, np.zeros((1, K), np.float32)])
    want = j_build_bt_phys(bt_pad, t.packed, C)
    r = hy.HybridSDDMM(packed_from_reference(t.packed), k_chunks=C,
                       device="cpu")
    a = jgen.make_dense(csr.m, K, seed=1)
    _, got = r.prepare_operands(a, b=b)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    _, got_bt = r.prepare_operands(a, bt=np.ascontiguousarray(b.T))
    assert torch.equal(got, got_bt)


@pytest.mark.parametrize("mode", ["mixed", "float16", "bfloat16"])
def test_operands_in_storage_dtypes(mode, cases):
    """prepare_operands casts once, into the JAX package's _STORAGE."""
    _, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), compute_dtype=mode,
                       a_layout="panels", device="cpu")
    (a_pad, a_panels), bt = r.prepare_operands(a, b=b)
    jr = JaxHybrid(packed, compute_dtype=mode, a_layout="panels")
    (ja, jp), jbt = jr.prepare_operands(a, b=b)
    for t_, j_ in ((a_pad, ja), (a_panels, jp), (bt, jbt)):
        assert str(t_.dtype).split(".")[-1] == str(j_.dtype)
        assert np.array_equal(t_.float().numpy(),
                              np.asarray(j_).astype(np.float32))


def test_two_d_bt_needs_identity_layout():
    """A 2-D (N+1, K) B^T is taken only under the identity layout, as in
    the JAX runner; otherwise it raises instead of computing wrong dots.
    The hub packing reorders its columns (hub-first ranks) at G=1, C=1."""
    csr, t, a, b = _config_case("hub")
    r = hy.HybridSDDMM(packed_from_reference(t.packed), device="cpu")
    assert not r.is_identity_layout
    a_pad, _ = operands_from_numpy(r, a, b)
    bt_pad = torch.from_numpy(np.concatenate(
        [b.T, np.zeros((1, K), np.float32)]))
    with pytest.raises(ValueError, match="identity layout"):
        r.run_padded(a_pad, bt_pad)

    ident = jgen.random_sparse(200, 160, density=0.05, seed=3)
    ti = j_from_params(ident, K, alpha=0.3, delta=0.05)
    ri = hy.HybridSDDMM(packed_from_reference(ti.packed), device="cpu")
    assert ri.is_identity_layout
    ai = jgen.make_dense(ident.m, K, seed=1)
    bi = jgen.make_dense(K, ident.n, seed=2)
    a_pad, bt_phys = ri.prepare_operands(ai, b=bi)
    assert torch.equal(ri.run_padded(a_pad, bt_phys[0], order="csr"),
                       ri.run_padded(a_pad, bt_phys, order="csr"))


def test_rows_runner_ignores_panels(cases):
    """A rows-layout runner given a panels runner's (a_pad, a_panels) pair
    uses a_pad and ignores the panels, as the JAX runner does."""
    _, packed, a, b = cases["conftest"]
    p = packed_from_reference(packed)
    panels_ops = hy.HybridSDDMM(p, a_layout="panels",
                                device="cpu").prepare_operands(
        a, b=b)
    rows = hy.HybridSDDMM(p, a_layout="rows", device="cpu")
    assert torch.equal(rows.run_padded(*panels_ops, order="csr"),
                       rows(a, b=b))


def test_unported_clustering_raises():
    """method="device" on the CPU clusters as the JAX package's device
    clustering does (the same row order, so the same packing), and the
    runner agrees with the JAX one; an unknown mode is a ValueError."""
    csr = _powerlaw()
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    got = hy.HybridSDDMM.from_csr(tcsr, 0.3, 0.05, method="device",
                                  device="cpu")
    want = JaxHybrid.from_csr(csr, 0.3, 0.05, method="device")
    assert np.array_equal(got.packed.a_row_gather, want.packed.a_row_gather)
    assert got.packed.packed_size == want.packed.packed_size
    a = jgen.make_dense(csr.m, 32, seed=1)
    b = jgen.make_dense(32, csr.n, seed=2)
    res = check_values(sddmm_reference(a, b, tcsr), got(a, b=b).numpy())
    assert res.passed and not res.num_errors, res
    with pytest.raises(ValueError, match="compute_dtype"):
        hy.check_slice("tf16", 1)


def test_sddmm_hybrid_matches_jax(cases, pallas_interpret):
    csr, packed, a, b = cases["conftest"]
    want = j_sddmm_hybrid(a, b, packed)
    got = sddmm_hybrid(a, b, packed_from_reference(packed), device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (csr.nnz,)
    assert np.max(np.abs(got - want) / np.abs(want)) <= SPLIT_REL


def test_panels_layout_needs_panel_operands(cases):
    _, packed, a, b = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), a_layout="panels",
                       device="cpu")
    (a_pad, _), bt = operands_from_numpy(r, a, b)
    with pytest.raises(ValueError):
        r.run_padded(a_pad, bt)


#: residual layouts: (matrix, from_params keywords)
RES_CONFIGS = {
    "G1": (_clustered, {}),
    "G1 sort gid": (_clustered, dict(sort_res="gid")),
    "G2 sort gid": (_powerlaw, dict(group_size=2, sort_res="gid")),
    "G4C2": (_clustered, dict(group_size=4, k_chunks=2,
                              merge_superpanels=False)),
    "C2 powerlaw": (_powerlaw, dict(k_chunks=2)),
}


@functools.lru_cache(maxsize=None)
def _res_case(name):
    gen, kw = RES_CONFIGS[name]
    csr = gen()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05, **kw)
    assert t.packed.nnz_res > 0
    return csr, t, jgen.make_dense(csr.m, K, seed=1), jgen.make_dense(
        K, csr.n, seed=2)


@pytest.mark.parametrize("group_rows", [None, 2, 8])
@pytest.mark.parametrize("name", list(RES_CONFIGS))
def test_residual_plan_matches_jax(name, group_rows):
    """The residual's plan covers every residual entry exactly once, in a
    group whose row holds it at the listed group row; the plain route in
    plan order matches the JAX residual ("float32": exact fp32 products),
    for CSR- and gid-sorted residuals, G > 1 and C > 1."""
    csr, t, a, b = _res_case(name)
    p = t.packed
    G = p.group_size
    keys = p.res_gids.astype(np.int64) * G + (p.res_member if G > 1 else 0)
    plan = gather_plan(p.res_rows, keys, hy.packing_row_order(p),
                       group_rows)
    assert plan.n == p.nnz_res
    if plan.grouped:
        seen = np.zeros(p.nnz_res, dtype=np.int64)
        for row, ents, ks in plan_entries(plan):
            assert (p.res_rows[ents] == row).all()
            assert (keys[ents] == ks).all()
            seen[ents] += 1
        assert (seen == 1).all()
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks)
    want = np.asarray(jr.run_padded(*jr.prepare_operands(a, b=b)))[
        p.packed_size - p.nnz_res:]
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                       k_chunks=t.k_chunks, device="cpu")
    a_pad, bt_phys = r.prepare_operands(a, b=b)
    args = r.residual_call(a_pad, bt_phys)
    got = (hy.gather_dot_plan_plain(*args[:2], plan) if plan.grouped
           else hy.residual_gather_dot(*args, plan=plan))
    assert np.max(np.abs(got.numpy() - want) / np.abs(want)) <= 1e-6
    # the runner's own plan is a plan of the same entries
    assert r.res_plan.n == p.nnz_res


@pytest.mark.parametrize("name", ["G2C2+slabs", "G4"])
def test_run_heads_matches_jax_heads(name):
    """run_heads over 3 heads (one tile launch and one gather-dot launch
    on the card) against the JAX runner head by head, on the real slots."""
    csr, t, _, _ = _config_case(name)
    p = t.packed
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 2, (3, csr.m, K)).astype(np.float32)
    b = rng.uniform(0, 2, (3, K, csr.n)).astype(np.float32)
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                       k_chunks=t.k_chunks, device="cpu")
    pad = lambda x: torch.nn.functional.pad(torch.from_numpy(x),  # noqa
                                            (0, 0, 0, 1))
    got = r.run_heads(pad(a), r.device_bt(pad(np.ascontiguousarray(
        b.transpose(0, 2, 1))))).numpy()
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks)
    real = p.inv_idx
    res = real >= p.packed_size - p.nnz_res
    for h in range(3):
        want = np.asarray(jr.run_padded(*jr.prepare_operands(a[h], b=b[h])))
        rel = np.abs(got[h][real] - want[real]) / np.abs(want[real])
        assert rel.max() <= PARITY_REL
        assert rel[res].max(initial=0.0) <= 1e-6


def test_default_order_csr_batched_matches_jax():
    """tests/test_grouped.py:229-246 on the port: a runner built with
    default_order="csr" (G=4, C=2) makes BatchedHybridSDDMM return (B, nnz)
    in CSR order, as the JAX runner's does; order=None means the default
    in run_padded and run_heads too, and the keywords after compute_dtype
    are keyword-only."""
    from sddmm_tpu.ops.batch import BatchedHybridSDDMM as JaxBatched
    from sddmm_tpu_torch.ops.batch import BatchedHybridSDDMM

    csr = _clustered()
    t = j_from_params(csr, 32, alpha=0.3, delta=0.05, group_size=4,
                      k_chunks=2, merge_superpanels=False)
    rng = np.random.default_rng(7)
    a = rng.random((3, csr.m, 32), dtype=np.float32)
    b = rng.random((3, 32, csr.n), dtype=np.float32)
    want = JaxBatched(JaxHybrid(t.packed, compute_dtype="float32",
                                default_order="csr", k_chunks=2))(a, b)
    r = hy.HybridSDDMM(packed_from_reference(t.packed),
                       compute_dtype="float32", default_order="csr",
                       k_chunks=2, device="cpu")
    got = BatchedHybridSDDMM(r)(a, b)
    assert got.shape == (3, csr.nnz) == want.shape
    for i in range(3):
        res = check_values(sddmm_reference(a[i], b[i], csr), got[i])
        assert res.passed, str(res)
        assert np.max(np.abs(got[i] - want[i]) / np.abs(want[i])) <= 1e-5
    ops = r.prepare_operands(a[0], b=b[0])
    assert r.run_padded(*ops).shape == (csr.nnz,)
    assert r.run_padded(*ops, order="packed").shape == (
        t.packed.packed_size,)
    with pytest.raises(TypeError):
        hy.HybridSDDMM(packed_from_reference(t.packed), "float32", "csr")
    with pytest.raises(ValueError, match="order"):
        hy.HybridSDDMM(packed_from_reference(t.packed), default_order="coo",
                       device="cpu")


def test_gather_walk_is_chosen_from_k():
    """A planned gather-dot whose block would not fit in shared memory at
    the call's K takes the entry-order walk of the same kernel (decided at
    launch, also for the runner's residual): at K = 4096 a 16-row plan
    needs 282 KB of the 227 a block has, an 8-row plan 150 KB.  Both
    walks give the JAX residual's values."""
    csr, t, a, b = _res_case("G1")
    p = t.packed
    plan16 = gather_plan(p.res_rows, p.res_gids.astype(np.int64),
                         hy.packing_row_order(p), 16)
    assert hy.plan_smem_bytes(16, 4096) > hy.GATHER_SMEM_LIMIT
    assert hy.plan_smem_bytes(8, 4096) <= hy.GATHER_SMEM_LIMIT
    assert hy.planned_walk(plan16, 128) and not hy.planned_walk(plan16, 4096)
    assert not hy.planned_walk(None, 128)
    big = 4096
    rng = np.random.default_rng(2)
    a_pad = torch.tensor(rng.uniform(0, 2, (csr.m + 1, big)),
                         dtype=torch.float32)
    bt = torch.tensor(rng.uniform(0, 2, (csr.n + 1, big)),
                      dtype=torch.float32)
    rows = torch.as_tensor(p.res_rows, dtype=torch.int32)
    gids = torch.as_tensor(p.res_gids, dtype=torch.int32)
    got = hy.residual_gather_dot(a_pad, bt, rows, gids, plan=plan16.to("cpu"))
    want = (a_pad[rows.long()].double() * bt[gids.long()].double()).sum(1)
    assert torch.allclose(got.double(), want, rtol=1e-6)
    r = hy.HybridSDDMM(packed_from_reference(p), compute_dtype="float32",
                       device="cpu")
    r.res_plan = plan16.to("cpu")
    ga = jgen.make_dense(csr.m, big, seed=1)
    gb = jgen.make_dense(big, csr.n, seed=2)
    res = check_values(sddmm_reference(ga, gb, csr), r(ga, gb).numpy())
    assert res.passed and res.num_errors == 0, str(res)


def test_inv_idx32_names_the_int32_limit(cases):
    """At packed_size >= 2^31 the int32 slot index the softmax kernel reads
    cannot exist: the error names that limit, not a light packing."""
    _, packed, _, _ = cases["conftest"]
    r = hy.HybridSDDMM(packed_from_reference(packed), device="cpu")
    # a stub of the two fields the index reads (packed_size is derived)
    r.packed = types.SimpleNamespace(inv_idx=packed.inv_idx,
                                     packed_size=2 ** 31)
    with pytest.raises(ValueError, match=r"2\^31.*int32"):
        r.inv_idx32
    light = hy.HybridSDDMM(packed_from_reference(packed), device="cpu")
    light.packed = dataclasses.replace(light.packed, inv_idx=None)
    with pytest.raises(ValueError, match="light packing"):
        light.inv_idx32
    ok = hy.HybridSDDMM(packed_from_reference(packed), device="cpu")
    assert ok.inv_idx32.dtype == torch.int32
    assert np.array_equal(ok.inv_idx32.numpy(), packed.inv_idx)


@pytest.mark.parametrize("name", ["G1", "G4C2"])
def test_residual_plan_built_at_first_call(name):
    """The runner builds its residual's plan at the first call, not in
    ``__init__``, and the values are those of a runner whose plan was
    built before the call (the same plan: fp32, exactly equal)."""
    csr, t, a, b = _res_case(name)
    p = packed_from_reference(t.packed)
    lazy = hy.HybridSDDMM(p, k_chunks=t.k_chunks, device="cpu")
    eager = hy.HybridSDDMM(p, k_chunks=t.k_chunks, device="cpu")
    assert "res_plan" not in lazy.__dict__
    assert eager.res_plan.n == p.nnz_res
    got = lazy(a, b)
    assert "res_plan" in lazy.__dict__
    assert torch.equal(got, eager(a, b))
