"""The tile kernel's work table (``ops/tile_dot.TileTable``) on packings
built by the JAX package and carried across with
``interop.packed_from_reference``: G in {1, 2, 4}, C in {1, 2}, the hub
and the hot-row slab, ``a_layout`` "rows" and "panels".

On the CPU a runner's one-launch path is ``tile_table_plain``, the
kernel's per-entry indexing in PyTorch ops; so these tests hold that
indexing to the JAX package's ``_hybrid_packed_jit`` (and its vmapped
batch), and to the per-segment plain route.  The kernel itself is held to
the plain route on the card (``tests/test_torch_card.py``,
``chip_smoke.py``)."""

import functools

import jax
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.ops import pallas_tiles
from sddmm_tpu.ops.batch import BatchedHybridSDDMM as JaxBatched
from sddmm_tpu.ops.hybrid import HybridSDDMM as JaxHybrid
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch.interop import operands_from_numpy, packed_from_reference
from sddmm_tpu_torch.ops import batch as bt
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops import tile_dot as td
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.utils.check import check_values

K = 32
# port vs JAX on real slots: the same bf16 planes and products, summed in
# another order (the Pallas kernel in interpret mode for "tf32" at G = 1,
# C = 1; "mixed", "float16", "bfloat16" everywhere; "float32", exact fp32
# on JAX's CPU backend, within about one fp32 rounding)
PARITY_REL = 1e-5
# "tf32" where the JAX side computes Precision.HIGH in full fp32 (G > 1,
# C > 1, the slabs): the bf16x3 split drops at most 3 * 2^-18 per product
SPLIT_REL = 3 * 2.0 ** -18
# the table route against the per-segment plain route: the same products
# of the same planes, summed by bmm over other batch shapes
ROUTE_REL = 1e-6
MODES = ("tf32", "float32", "mixed", "float16", "bfloat16")
# modes held to the contract here; "mixed" keeps B in bf16, whose rounding
# (up to 2^-9 of each B value) reaches the contract's 1e-3 on these K = 32
# sums on both sides, so it is held to the JAX package only
CONTRACT_MODES = ("tf32", "float32")


def _clustered():                    # tests/conftest.py clustered_csr
    return jgen.block_clustered(24, 20, block_prob=0.15, block_density=0.8,
                                noise_density=0.002, seed=7)


def _powerlaw():
    return jgen.powerlaw_graph(512, avg_degree=12, seed=4)


#: (matrix, from_params keywords) at G in {1, 2, 4}, C in {1, 2}, slabs
CASES = {
    "G1": (_clustered, dict()),
    "G2": (_clustered, dict(group_size=2)),
    "G4": (_clustered, dict(group_size=4, merge_superpanels=False)),
    "G1C2": (_clustered, dict(k_chunks=2)),
    "G2C2+hub+rowslab": (_powerlaw, dict(group_size=2, k_chunks=2,
                                         hub_cols=128, hot_rows=64,
                                         hot_rows_pre=True)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    gen, kw = CASES[name]
    csr = gen()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05, **kw)
    a = jgen.make_dense(csr.m, K, seed=1)
    b = jgen.make_dense(K, csr.n, seed=2)
    return csr, t, a, b


@pytest.fixture(scope="module")
def pallas_interpret():
    """Route the JAX hybrid's Pallas tile dot through interpret mode (the
    caches cleared first, so no trace made without it is reused)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_tiles, "tile_dot_padded",
               functools.partial(pallas_tiles.tile_dot_padded,
                                 interpret=True))
    jax.clear_caches()
    yield
    mp.undo()
    jax.clear_caches()


def _runner(t, mode="tf32", a_layout="panels"):
    return hy.HybridSDDMM(packed_from_reference(t.packed),
                          compute_dtype=mode, k_chunks=t.k_chunks,
                          a_layout=a_layout, device="cpu")


@pytest.mark.parametrize("a_layout", ["rows", "panels"])
@pytest.mark.parametrize("name", list(CASES))
def test_table_writes_every_tile_slot_once(name, a_layout):
    """The entries cover every slot of the segments and slabs exactly once
    and none of the residual's; windows stay within 64 rows and 128 lanes;
    every row id, group row and lane member is in range."""
    _, t, _, _ = _case(name)
    p = t.packed
    r = _runner(t, a_layout=a_layout)
    ent = r.table.entries.numpy()
    assert (ent[:, 1] >= 1).all() and (ent[:, 1] <= td.ROW_WINDOW).all()
    assert (ent[:, 4] >= 1).all() and (ent[:, 4] <= td.LANE_WINDOW).all()
    hits = np.zeros(p.packed_size, dtype=np.int64)
    rr = np.arange(td.ROW_WINDOW)
    ll = np.arange(td.LANE_WINDOW)
    G = p.group_size
    rows, gids = r.table.row_ids.numpy(), r.table.gids.numpy()
    for row_off, nrows, gid_off, lane0, nlanes, out_off, out_rs, _ in ent:
        slots = out_off + rr[:nrows, None] * out_rs + ll[None, :nlanes]
        np.add.at(hits, slots.ravel(), 1)
        assert rows[row_off:row_off + nrows].max() <= p.m
        lanes = lane0 + ll[:nlanes]
        assert gids[gid_off + lanes // G].max() <= p.num_col_groups
    n_tile = p.packed_size - p.nnz_res
    assert (hits[:n_tile] == 1).all() and not hits[n_tile:].any()
    assert r.table.max_row <= p.m and r.table.max_gid <= p.num_col_groups
    assert r.table.out_extent == n_tile


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_table_plain_matches_jax(name, mode, pallas_interpret):
    """``tile_table_plain`` (the runner's path on the CPU) against the JAX
    package's packed run on real slots, in every mode, and under the
    contract where the mode passes it; and against the per-segment plain
    route to ``ROUTE_REL``."""
    csr, t, a, b = _case(name)
    p = t.packed
    jr = JaxHybrid(p, compute_dtype=mode, k_chunks=t.k_chunks,
                   a_layout="panels", use_pallas=mode == "tf32")
    want = np.asarray(jr.run_padded(*jr.prepare_operands(a, b=b)))
    r = _runner(t, mode)
    ops = operands_from_numpy(r, a, b)
    got = r.run_padded(*ops)
    real = p.inv_idx
    rel = np.abs(got.numpy()[real] - want[real]) / np.abs(want[real])
    pallas = mode == "tf32" and p.group_size == 1 and t.k_chunks == 1 and (
        not p.hub_cols and p.rowslab_rows is None)
    tol = SPLIT_REL if mode == "tf32" and not pallas else PARITY_REL
    assert rel.max() <= tol, rel.max()
    if mode in CONTRACT_MODES:
        res = check_values(sddmm_reference(a, b, csr),
                           r.to_csr_order(got).numpy())
        assert res.passed and res.num_errors == 0, str(res)
    route = r.run_padded(*ops, plain=True).numpy()
    tile = real[real < p.packed_size - p.nnz_res]
    g, w = got.numpy()[tile], route[tile]
    assert (np.abs(g - w) / np.abs(w)).max() <= ROUTE_REL


@pytest.mark.parametrize("name", list(CASES))
def test_table_rows_layout_matches_panels(name):
    """Under a_layout="rows" the table names the family rows, under
    "panels" the rows the panels hold: the same values on real slots."""
    _, t, a, b = _case(name)
    p = t.packed
    got = {layout: _runner(t, a_layout=layout).run_padded(
        *operands_from_numpy(_runner(t, a_layout=layout), a, b)).numpy()
        for layout in ("rows", "panels")}
    real = p.inv_idx
    assert np.array_equal(got["rows"][real], got["panels"][real])


@pytest.mark.parametrize("name", ["G1", "G2C2+hub+rowslab"])
def test_batched_table_matches_jax_vmap(name):
    """Three heads through one table with a head stride (the runner's
    ``run_heads``, as BatchedHybridSDDMM calls it) against the JAX
    package's vmapped batch, and each head against its own call."""
    _, t, _, _ = _case(name)
    p = t.packed
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 2, (3, p.m, K)).astype(np.float32)
    b = rng.uniform(0, 2, (3, K, p.n)).astype(np.float32)
    jr = JaxHybrid(p, compute_dtype="float32", k_chunks=t.k_chunks)
    want = np.asarray(JaxBatched(jr)(a, b))
    r = _runner(t, "float32", a_layout="rows")
    a_pad = bt._pad_rows(torch.from_numpy(a))
    b_pad = bt._pad_rows(bt.batched_transpose(torch.from_numpy(b)))
    got = r.run_heads(a_pad, r.device_bt(b_pad))
    real = p.inv_idx
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real],
                               rtol=PARITY_REL)
    for h in range(3):
        one = r.run_padded(*r.device_prepare(a_pad[h], b_pad[h]))
        assert torch.equal(got[h], one)


@pytest.mark.parametrize("mode", MODES)
def test_identity_table_is_the_batched_tile_dot(mode):
    """The table ``tile_dot`` launches on the card for strided operands
    (column views, a strided output at an odd offset), run through
    ``tile_table_plain``, is the batched tile dot."""
    rng = np.random.default_rng(9)
    adt, bdt = td.STORAGE[mode]
    a = torch.tensor(rng.uniform(0, 2, (3, 37, 96)),
                     dtype=torch.float32).to(adt)
    b = torch.tensor(rng.uniform(0, 2, (3, 150, 96)),
                     dtype=torch.float32).to(bdt)
    buf = torch.full((1 + 3 * 37 * 151,), -1.0)
    out = buf[1:].view(3, 37, 151)[:, :, :150]
    av, bv = a[:, :, 32:80], b[:, :, 32:80]
    (sa, ta), (sb, tb) = td._rows_of(av), td._rows_of(bv)
    table = td.identity_table(3, 37, 150, ta, tb, out.stride(0),
                              out.stride(1), "cpu")
    # the kernel's view of the operands: rows sa (sb) apart from the view's
    # first element
    a_rows = torch.as_strided(av, (1, 3 * ta, 48), (0, sa, 1))
    b_rows = torch.as_strided(bv, (1, 1, 3 * tb, 48), (0, 0, sb, 1))
    flat = torch.as_strided(out, (1, table.out_extent), (0, 1))
    td.tile_table_plain(a_rows, b_rows, table, mode, flat)
    want = td.tile_dot_plain(av, bv, mode)
    assert torch.equal(out, want)
    assert buf[0] == -1.0 and (buf[1:].view(3, 37, 151)[:, :, 150]
                               == -1.0).all()


def test_tile_table_rejects():
    _, t, a, b = _case("G1")
    r = _runner(t)
    (a_pad, _), bt_phys = operands_from_numpy(r, a, b)
    out = torch.empty((1, r.packed.packed_size))
    args = (a_pad[None], bt_phys[None], r.table, "tf32")
    with pytest.raises(ValueError, match="slots"):
        td.tile_table(*args, out[:, :10])
    with pytest.raises(TypeError, match="bfloat16"):
        td.tile_table(a_pad[None].bfloat16(), *args[1:], out)
    with pytest.raises(ValueError, match="heads"):
        td.tile_table(a_pad[None], bt_phys[None].expand(2, -1, -1, -1),
                      *args[2:], out)
    with pytest.raises(ValueError, match="indexes row"):
        td.tile_table(a_pad[None, :5], *args[1:], out)
