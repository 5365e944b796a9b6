"""The hybrid's backward over the tile kernel's work table (B1:
``tile_dot.tile_table_grad``, ``TileTable.grad_index``, ``HybridSDDMM.vjp``)
on the CPU, where it takes its plain version: against ``jax.vjp`` of the
JAX runner in "float32" (G 1/2/4, C 1/2, both A layouts, the hub and
hot-row slabs, the residual, 3 heads against ``jax.vmap``), against the
read-pattern route, and the backward index against the per-slot read
pattern it replaces: every slot of the work table walked once by each pass,
every partial row reduced into the row or lane the forward read.  Inputs
from numpy seeds, U[0,2) data as in ``test_torch_autograd.py`` (a
mixed-sign cotangent cancels past any fp32 sum order's reach)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops.hybrid import HybridSDDMM as JaxHybrid
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch.interop import packed_from_reference
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops import tile_dot as td
from sddmm_tpu_torch.utils.check import check_values
from torch_native_ready import reference_native_loaded  # noqa: F401

K = 32
# the tile backward against the read-pattern route, or against the kernel's
# walk emulated here: the same fp32 products of U[0,2) data summed in
# another order, as max |got - want| / |want| over the nonzero gradients
SUM_ORDER_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small tensors, and the test workers run side
    by side (as in test_torch_autograd.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _powerlaw():
    return jgen.powerlaw_graph(512, avg_degree=12, seed=4)


def _clustered():
    return jgen.block_clustered(24, 20, block_prob=0.15, block_density=0.8,
                                noise_density=0.002, seed=7)


#: packings (matrix, from_params keywords), as test_torch_autograd.py's
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
    rng = np.random.default_rng(len(name) + 20)
    return csr, t, _u02(rng, (csr.m, K)), _u02(rng, (csr.n, K))


def _u02(rng, shape):
    return rng.uniform(0, 2, shape).astype(np.float32)


def _runner(t, a_layout="rows"):
    return hy.HybridSDDMM(packed_from_reference(t.packed),
                          compute_dtype="float32", k_chunks=t.k_chunks,
                          a_layout=a_layout, device="cpu")


def _contract(want, got):
    res = check_values(np.asarray(want), np.asarray(got))
    assert res.passed and res.num_errors == 0, str(res)


def _rel_nonzero(got, want):
    nz = want != 0
    assert not got[~nz].any()
    return ((got[nz] - want[nz]).abs() / want[nz].abs()).max().item()


def _port_vjp(r, a, bt, g):
    """dA (.., M, K) and dB^T (.., N, K): ``HybridSDDMM.vjp`` at the
    operands ``device_prepare`` makes (a leading head dimension where a is
    3-D), carried back through the pads and ``device_bt`` by autograd."""
    heads = a.ndim == 3
    a_t = torch.tensor(a, requires_grad=True)
    bt_t = torch.tensor(bt, requires_grad=True)
    pad = functools.partial(torch.nn.functional.pad, pad=(0, 0, 0, 1))
    if heads:
        a_pad, bt_phys = pad(a_t), r.device_bt(pad(bt_t))
    else:
        a_ops, bt_phys = r.device_prepare(pad(a_t), pad(bt_t))
        a_pad = a_ops[0] if isinstance(a_ops, tuple) else a_ops
        a_pad, bt_phys = a_pad[None], bt_phys[None]
    g = torch.from_numpy(g)
    da, dbt = r.vjp(a_pad.detach(), bt_phys.detach(),
                    g if heads else g[None])
    torch.autograd.backward([a_pad, bt_phys], [da, dbt])
    return a_t.grad.numpy(), bt_t.grad.numpy()


def _jax_vjp(jr, a, bt, g):
    def one(a_, bt_):
        z = jnp.zeros((1, a_.shape[-1]), a_.dtype)
        a_ops, bt_phys = jr.device_prepare(jnp.concatenate([a_, z]),
                                           jnp.concatenate([bt_, z]))
        return jr.run_padded(a_ops, bt_phys)
    fn = jax.vmap(one) if a.ndim == 3 else one
    _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(bt))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("name,a_layout", [
    ("G1", "rows"), ("G1", "panels"), ("G2", "rows"), ("G4C2", "rows"),
    ("G4C2", "panels"), ("hub+rowslab", "rows"), ("hub+rowslab", "panels"),
    ("G2C2+slabs", "panels")])
def test_tile_grad_plain_matches_jax_vjp(name, a_layout):
    """``vjp`` (tile_table_grad_plain over the work table, the residual's
    plain SpMM) with a U[0,2) cotangent on every packed slot, garbage ones
    too, against jax.vjp of the JAX runner through device_prepare."""
    _, t, a, bt = _case(name)
    g = _u02(np.random.default_rng(11), t.packed.packed_size)
    jr = JaxHybrid(t.packed, compute_dtype="float32", k_chunks=t.k_chunks,
                   a_layout=a_layout)
    want_a, want_bt = _jax_vjp(jr, a, bt, g)
    got_a, got_bt = _port_vjp(_runner(t, a_layout), a, bt, g)
    _contract(want_a, got_a)
    _contract(want_bt, got_bt)


def test_tile_grad_heads_match_jax_vmap():
    """3 heads in one ``vjp`` (G=2, C=2, both slabs, a residual) against
    jax.vjp of the JAX runner under vmap."""
    csr, t, _, _ = _case("G2C2+slabs")
    rng = np.random.default_rng(12)
    a, bt = _u02(rng, (3, csr.m, K)), _u02(rng, (3, csr.n, K))
    g = _u02(rng, (3, t.packed.packed_size))
    jr = JaxHybrid(t.packed, compute_dtype="float32", k_chunks=t.k_chunks)
    want_a, want_bt = _jax_vjp(jr, a, bt, g)
    got_a, got_bt = _port_vjp(_runner(t), a, bt, g)
    _contract(want_a, got_a)
    _contract(want_bt, got_bt)


def _operands(r, t, heads, seed):
    """U[0,2) a_pad (H, M+1, K), bt_phys (H, C, NG+1, G*kc) with zero pads,
    and a cotangent (H, F)."""
    p = r.packed
    rng = np.random.default_rng(seed)
    pad = functools.partial(torch.nn.functional.pad, pad=(0, 0, 0, 1))
    a = pad(torch.from_numpy(_u02(rng, (heads, p.m, K))))
    bt = r.device_bt(pad(torch.from_numpy(_u02(rng, (heads, p.n, K)))))
    g = torch.from_numpy(_u02(rng, (heads, p.packed_size)))
    return a.contiguous(), bt.contiguous(), g


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tile_grad_matches_read_pattern_route(name):
    """The new route (table units + the residual's pattern) against the
    read-pattern route on the same operands, 2 heads: within
    SUM_ORDER_REL; both leave the pads' rows at 0."""
    _, t, _, _ = _case(name)
    r = _runner(t)
    a, bt, g = _operands(r, t, 2, 13)
    da, dbt = r.vjp(a, bt, g)
    ra, rbt = r.vjp_read_pattern(a, bt, g)
    assert _rel_nonzero(da, ra) <= SUM_ORDER_REL
    assert _rel_nonzero(dbt, rbt) <= SUM_ORDER_REL
    assert not da[:, r.packed.m].any() and not dbt[:, :, -1].any()


def _unit_slots(table, idx, pass_b):
    """(slot, partial row) of every cell each unit of one pass walks, in
    the walk's order."""
    ent = table.entries.numpy()
    units = idx.units.numpy()
    units = units[idx.n_units_a:] if pass_b else units[:idx.n_units_a]
    walk = idx.walk.numpy()
    slots, rows = [], []
    for start, count, prow, _ in units:
        for e in walk[start:start + count]:
            row_off, nrows, _, _, nlanes, out_off, out_rs, _ = ent[e]
            r, l = np.meshgrid(np.arange(nrows), np.arange(nlanes),
                               indexing="ij")
            slots.append((out_off + r * out_rs + l).ravel())
            rows.append((prow + (l if pass_b else r)).ravel())
    return np.concatenate(slots), np.concatenate(rows)


@pytest.mark.parametrize("name,a_layout", [
    ("G1", "panels"), ("G2", "rows"), ("G4C2", "panels"),
    ("hub+rowslab", "rows"), ("G2C2+slabs", "panels")])
def test_grad_index_covers_table_once(name, a_layout):
    """Each pass's units walk every entry once and so every (slot, row,
    lane) of the work table once; each partial row is reduced into the A
    row (or B^T lane) the forward read at its slots, per the read pattern,
    or dropped where that is a pad; no partial row is reduced twice; each
    unit holds at most GRAD_PART entries."""
    _, t, _, _ = _case(name)
    r = _runner(t, a_layout)
    p = r.packed
    idx, _ = r.grad_state()
    rows, lanes, slots = r.read_pattern()
    row_at = np.full(p.packed_size, -1)
    row_at[slots] = rows
    lane_at = np.full(p.packed_size, -1)
    lane_at[slots] = lanes
    table_slots = np.sort(slots[slots < r._res_offset])
    n_e = r.table.n_entries
    walk = idx.walk.numpy()
    units = idx.units.numpy()
    assert np.array_equal(np.sort(walk[:n_e]), np.arange(n_e))
    assert np.array_equal(np.sort(walk[n_e:]), np.arange(n_e))
    assert units[:, 1].max() <= td.GRAD_PART
    target = np.full(idx.partials, -1)
    tptr, src = idx.tptr.numpy(), idx.src.numpy()
    assert len(np.unique(src)) == len(src)
    for tt in range(idx.n_targets):
        target[src[tptr[tt]:tptr[tt + 1]]] = tt
    for pass_b, at, real, base in ((False, row_at, p.m, 0),
                                   (True, lane_at,
                                    p.num_col_groups * p.group_size,
                                    idx.n_a)):
        s, prow = _unit_slots(r.table, idx, pass_b)
        assert np.array_equal(np.sort(s), table_slots)
        want = np.where(at[s] < real, at[s] + base, -1)
        assert np.array_equal(target[prow], want)


@pytest.mark.parametrize("name", ["G1", "G4C2", "G2C2+slabs"])
def test_grad_index_walk_reproduces_plain(name):
    """The kernels' algorithm emulated in torch from the index (each
    unit's partial summed over its entries, then each row's partials added
    in the index's order) against tile_table_grad_plain, 2 heads."""
    _, t, _, _ = _case(name)
    r = _runner(t)
    p = r.packed
    a, bt, g = _operands(r, t, 2, 14)
    H, C, nb, gk = bt.shape
    G = p.group_size
    kc = gk // G
    real = dict(real_rows=p.m, real_lanes=p.num_col_groups * G)
    want_a, want_b = td.tile_table_grad_plain(
        a, bt, g, r.table, torch.empty_like(a), torch.empty_like(bt), **real)
    idx = r.table.grad_index(p.m + 1, nb * G, **real)
    ent = r.table.entries.long()
    row_ids, gids = r.table.row_ids.long(), r.table.gids.long()
    lanes_b = bt.reshape(H, C, nb * G, kc).transpose(1, 2).reshape(
        H, nb * G, C * kc)                         # lane-major, chunks side by side
    ws = torch.zeros((H, idx.partials, C * kc))
    for u, (start, count, prow, _) in enumerate(idx.units.tolist()):
        for e in idx.walk[start:start + count].tolist():
            row_off, nrows, gid_off, lane0, nlanes, out_off, out_rs, _ = \
                ent[e].tolist()
            rr, ll = torch.arange(nrows), lane0 + torch.arange(nlanes)
            rows = row_ids[row_off + rr]
            lanes = gids[gid_off + ll // G] * G + ll % G
            d = g[:, out_off + rr[:, None] * out_rs + ll[None] - lane0]
            if u < idx.n_units_a:
                ws[:, prow:prow + nrows] += d @ lanes_b[:, lanes]
            else:
                ws[:, prow:prow + nlanes] += d.transpose(1, 2) @ a[:, rows]
    out = torch.zeros((H, idx.n_targets, C * kc))
    tptr, src = idx.tptr.tolist(), idx.src.long()
    for tt in range(idx.n_targets):
        out[:, tt] = ws[:, src[tptr[tt]:tptr[tt + 1]]].sum(dim=1)
    got_a = out[:, :idx.n_a]
    got_b = out[:, idx.n_a:].reshape(H, nb * G, C, kc).transpose(1, 2)
    assert _rel_nonzero(got_a, want_a) <= SUM_ORDER_REL
    assert _rel_nonzero(got_b.reshape(bt.shape), want_b) <= SUM_ORDER_REL


#: identity-table cases: (accumulate, want dA, want dB^T, real rows, lanes)
IDENTITY = {
    "write": (False, True, True, None, None),
    "accumulate": (True, True, True, None, None),
    "dA only, rows cut": (False, True, False, 120, None),
    "dB^T only, lanes cut": (True, False, True, None, 300),
}


@pytest.mark.parametrize("case", list(IDENTITY))
def test_tile_table_grad_on_an_identity_table(case):
    """tile_table_grad on a table of 3 tiles of 70 rows x 150 lanes (two
    row and two lane windows each) whose rows and lanes overlap from tile
    to tile, 2 heads, C = 2: against fp64 products summed by hand; the
    rows and lanes past the cut get nothing."""
    accumulate, want_a, want_b, real_rows, real_lanes = IDENTITY[case]
    nT, R, L, C, kc, H = 3, 70, 150, 2, 16, 2
    M, NB = 2 * 50 + R, 2 * 100 + L
    table = td.identity_table(nT, R, L, 50, 100, R * L, L, "cpu")
    rng = np.random.default_rng(15)
    a = torch.from_numpy(_u02(rng, (H, M, C * kc)))
    bt = torch.from_numpy(_u02(rng, (H, C, NB, kc)))
    g = torch.from_numpy(_u02(rng, (H, nT * R * L)))
    base_a = torch.from_numpy(_u02(rng, (H, M, C * kc)))
    base_b = torch.from_numpy(_u02(rng, (H, C, NB, kc)))
    da = base_a.clone() if want_a else None
    dbt = base_b.clone() if want_b else None
    td.tile_table_grad(a, bt, g, table, da, dbt, accumulate=accumulate,
                       real_rows=real_rows, real_lanes=real_lanes)
    ex_a = base_a.double() if accumulate else torch.zeros(a.shape,
                                                          dtype=torch.float64)
    ex_b = base_b.double() if accumulate else torch.zeros(
        bt.shape, dtype=torch.float64)
    b_l = bt.double().transpose(1, 2).reshape(H, NB, C * kc)
    for i in range(nT):
        rows, lanes = i * 50 + np.arange(R), i * 100 + np.arange(L)
        d = g[:, i * R * L:(i + 1) * R * L].double().reshape(H, R, L)
        keep_r = rows < (real_rows or M)
        keep_l = lanes < (real_lanes or NB)
        ex_a[:, rows[keep_r]] += (d @ b_l[:, lanes])[:, keep_r]
        db = (d.transpose(1, 2) @ a[:, rows].double())[:, keep_l]
        ex_b[:, :, lanes[keep_l]] += db.reshape(H, -1, C, kc).transpose(1, 2)
    for got, want in ((da, ex_a), (dbt, ex_b)):
        if got is not None:
            assert _rel_nonzero(got.double(), want) <= SUM_ORDER_REL


def test_tile_table_grad_checks():
    """The wrapper refuses operands it cannot take: a non-fp32 operand, a
    cotangent shorter than the table reaches, outputs of another shape."""
    table = td.identity_table(2, 16, 16, 16, 16, 256, 16, "cpu")
    a, bt = torch.rand(1, 32, 16), torch.rand(1, 1, 32, 16)
    g = torch.rand(1, 512)
    with pytest.raises(TypeError, match="float32"):
        td.tile_table_grad(a.half(), bt, g, table, torch.empty_like(a))
    with pytest.raises(ValueError, match="slots"):
        td.tile_table_grad(a, bt, g[:, :500], table, torch.empty_like(a))
    with pytest.raises(ValueError, match="da"):
        td.tile_table_grad(a, bt, g, table, torch.empty(1, 31, 16))


def test_grad_state_is_built_once_without_a_read_pattern():
    """A backward builds the index at the first call (its host seconds
    recorded), keeps it (the table's grad_index returns the same object),
    and never builds the per-slot read pattern."""
    _, t, a, bt = _case("G2C2+slabs")
    r = _runner(t)
    g = _u02(np.random.default_rng(16), t.packed.packed_size)
    _port_vjp(r, a, bt, g)
    assert r.grad_pattern_seconds is not None and r._read_grad is None
    idx, res = r.grad_state()
    p = r.packed
    G = p.group_size
    assert r.table.grad_index(p.m + 1, (p.num_col_groups + 1) * G, p.m,
                              p.num_col_groups * G) is idx
    assert res is not None and res[0].n_entries == p.nnz_res
    _port_vjp(r, a, bt, g)
    assert r.grad_state()[0] is idx and r._read_grad is None
