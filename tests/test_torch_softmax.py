"""The port's segment softmax (``sddmm_tpu_torch.ops.softmax``) against the
JAX package's ``segment_softmax`` as its models apply it, on packings built
by ``from_params`` in the JAX package and carried across with
``interop.packed_from_reference``.  On the CPU ``segment_softmax_torch``
runs its plain version (the gather, the scale, the torch-ops softmax); the
kernel is held to it on the card (``tests/test_torch_card.py``,
``chip_smoke.py``)."""

import functools
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
from sddmm_tpu.models.graph_attention import (
    segment_softmax as j_segment_softmax)
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.interop import packed_from_reference
from sddmm_tpu_torch.ops import csr_softmax
from sddmm_tpu_torch.ops import softmax as sm
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
from torch_native_ready import reference_native_loaded  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# both sides take the same fp32 exps; the denominators are summed in
# another order (segment_sum's against index_add_'s)
RTOL, ATOL = 1e-5, 1e-6
K = 32


def _long_row_csr():
    """Random rows with every 7th row empty and row 2 longer than the
    kernel's in-register limit."""
    rng = np.random.default_rng(5)
    m, n = 120, 900
    rows, cols = [], []
    for r in range(m):
        deg = 0 if r % 7 == 0 else int(rng.integers(1, 30))
        if r == 2:
            deg = sm.SOFTMAX_LONG_ROW + 60
        c = rng.choice(n, deg, replace=False)
        rows.append(np.full(deg, r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return JCOO((m, n), rows, cols, np.ones(len(rows))).to_csr()


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX CSR, JAX packing) of a small pattern packed by from_params."""
    if name == "powerlaw":
        csr = jgen.powerlaw_graph(300, avg_degree=8, seed=4)
    elif name == "clustered":
        csr = jgen.block_clustered(12, 12, block_prob=0.2,
                                   block_density=0.7, seed=3)
    else:
        csr = _long_row_csr()
    t = j_from_params(csr, K, alpha=0.3, delta=0.05)
    return csr, t.packed


def _flat(packed, heads, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((heads, packed.packed_size)) * 4).astype(
        np.float32)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("name", ["powerlaw", "clustered", "long_row"])
def test_packed_softmax_matches_jax(name, heads):
    """The fused softmax on the packed flat vector through inv_idx equals
    JAX's segment_softmax(take(flat, inv_idx) * scale, rows, m), head by
    head."""
    csr, packed = _case(name)
    if name != "clustered":
        assert (csr.row_nnz() == 0).any()
    if name == "long_row":
        assert csr.row_nnz().max() > sm.SOFTMAX_LONG_ROW
    flat = _flat(packed, heads, seed=heads)
    scale = 1.0 / np.sqrt(K)
    rows = jnp.asarray(csr.row_indices())
    r = HybridSDDMM(packed_from_reference(packed), device="cpu")
    before = dict(_kernels.launches)
    got = sm.segment_softmax_torch(torch.from_numpy(flat),
                                   torch.from_numpy(csr.row_ptr.astype(
                                       np.int64)), scale, r.inv_idx32)
    assert dict(_kernels.launches) == before
    assert got.shape == (heads, csr.nnz) and got.dtype == torch.float32
    for h in range(heads):
        want = np.asarray(j_segment_softmax(
            jnp.take(jnp.asarray(flat[h]), jnp.asarray(packed.inv_idx))
            * scale, rows, csr.m))
        np.testing.assert_allclose(got[h].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("name", ["powerlaw", "long_row"])
def test_matches_jax_packed_sentinel_route(name, heads):
    """The JAX models' own route: the softmax over every packed slot with
    the padding slots in a dropped sentinel segment (row m); on the real
    slots it equals the port's CSR-order softmax."""
    csr, packed = _case(name)
    flat = _flat(packed, heads, seed=7)
    scale = 0.125
    got = sm.segment_softmax_torch(
        torch.from_numpy(flat), torch.from_numpy(csr.row_ptr.astype(
            np.int64)), scale,
        torch.from_numpy(packed.inv_idx.astype(np.int32)))
    for h in range(heads):
        attn = np.asarray(j_segment_softmax(
            jnp.asarray(flat[h]) * scale, jnp.asarray(packed.packed_rows),
            csr.m + 1))
        np.testing.assert_allclose(got[h].numpy(), attn[packed.inv_idx],
                                   rtol=RTOL, atol=ATOL)


def test_csr_order_form_and_host_wrapper():
    """Scores already in CSR order (inv_idx None), a 1-D head, and the
    host wrapper ``csr_softmax`` (numpy in, numpy out) against JAX."""
    csr, _ = _case("long_row")
    rng = np.random.default_rng(2)
    scores = (rng.standard_normal((2, csr.nnz)) * 3).astype(np.float32)
    want = np.stack([np.asarray(j_segment_softmax(
        jnp.asarray(s) * 0.5, jnp.asarray(csr.row_indices()), csr.m))
        for s in scores])
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    got = csr_softmax(tcsr, scores, 0.5, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (2, csr.nnz)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    one = sm.segment_softmax_torch(torch.from_numpy(scores[1]),
                                   torch.from_numpy(csr.row_ptr.astype(
                                       np.int64)), 0.5)
    assert one.shape == (csr.nnz,)
    np.testing.assert_allclose(one.numpy(), want[1], rtol=RTOL, atol=ATOL)
    # out= is written in place
    out = torch.full((2, csr.nnz), -7.0)
    res = sm.segment_softmax_torch(torch.from_numpy(scores),
                                   torch.from_numpy(csr.row_ptr.astype(
                                       np.int64)), 0.5, out=out)
    assert res is out and torch.equal(out, torch.from_numpy(got))


def test_find_long_rows_and_rejects():
    row_ptr = np.array([0, 3, 3, 3 + sm.SOFTMAX_LONG_ROW + 1,
                        3 + sm.SOFTMAX_LONG_ROW + 1 + sm.SOFTMAX_LONG_ROW])
    assert sm.find_long_rows(row_ptr).tolist() == [2]
    flat = torch.zeros((1, 10))
    rp = torch.tensor([0, 4, 10])
    with pytest.raises(TypeError, match="inv_idx"):
        sm.segment_softmax_torch(flat, rp, 1.0, torch.arange(10))
    with pytest.raises(TypeError, match="row_ptr"):
        sm.segment_softmax_torch(flat, rp.int())
    with pytest.raises(ValueError, match="float32"):
        sm.segment_softmax_torch(flat.double(), rp)
    with pytest.raises(ValueError, match="out"):
        sm.segment_softmax_torch(flat, rp, out=torch.zeros((1, 9)))
    # once a guard that raised: now an autograd op, whose cotangent is
    # p * (g - sum_row p * g), 0 for a constant g
    x = flat.clone().requires_grad_()
    out = sm.segment_softmax_torch(x, rp)
    assert out.grad_fn is not None
    out.sum().backward()
    assert torch.allclose(x.grad, torch.zeros_like(x), atol=1e-7)


# row lengths about the kernel's classes: empty, one entry, the graph's
# average, the last warp row, the first block row, and a hub past the
# block rows (a split row)
SPLIT_CASE_LENGTHS = (0, 1, 86, 640, 641, 5000)


def _split_case(heads, seed):
    """(row_ptr, inv_idx into packed scores with spare slots, packed
    scores (heads, F), cotangent (heads, nnz)) over rows of
    SPLIT_CASE_LENGTHS entries each, numpy-seeded."""
    rng = np.random.default_rng(seed)
    lens = np.array(SPLIT_CASE_LENGTHS + SPLIT_CASE_LENGTHS[::-1])
    row_ptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    nnz = int(row_ptr[-1])
    inv = rng.permutation(nnz + 300)[:nnz].astype(np.int32)
    flat = (rng.standard_normal((heads, nnz + 300)) * 4).astype(np.float32)
    g = rng.standard_normal((heads, nnz)).astype(np.float32)
    return row_ptr, inv, flat, g


@pytest.mark.parametrize("heads", [1, 3])
def test_split_row_combine_matches_jax(heads):
    """The long rows' plain counterpart (a block row's sums in the
    block's order; a split row's pieces' (max, sum) combined in rank
    order, the backward's sums of p * g by piece) against JAX's
    segment_softmax and its jax.vjp, head by head, on rows of 0, 1, 86,
    640, 641 (block) and 5000 (split) entries."""
    row_ptr, inv, flat, g = _split_case(heads, seed=heads)
    scale = 0.125
    m = len(row_ptr) - 1
    rows = jnp.asarray(np.repeat(np.arange(m), np.diff(row_ptr)))
    rp, idx = torch.from_numpy(row_ptr), torch.from_numpy(inv)
    assert sm.find_long_rows(row_ptr).tolist() == [4, 5, 6, 7]
    got = sm.segment_softmax_split_plain(torch.from_numpy(flat), rp, scale,
                                         idx)
    d = sm.segment_softmax_backward_split_plain(
        got, torch.from_numpy(g), rp, scale, idx, flat.shape[1])
    for h in range(heads):
        def f(s):
            return j_segment_softmax(jnp.take(s, jnp.asarray(inv)) * scale,
                                     rows, m)
        want, vjp = jax.vjp(f, jnp.asarray(flat[h]))
        np.testing.assert_allclose(got[h].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        (want_d,) = vjp(jnp.asarray(g[h]))
        np.testing.assert_allclose(d[h].numpy(), np.asarray(want_d),
                                   rtol=RTOL, atol=ATOL)
    # the split rows alone (past the block rows' limit), piece by piece,
    # against the one-piece softmax
    assert (np.diff(row_ptr)[[5, 6]] > sm.SOFTMAX_BLOCK_ROW).all()
    for r in (5, 6):
        x = torch.from_numpy(flat[:, inv[row_ptr[r]:row_ptr[r + 1]]]) * scale
        np.testing.assert_allclose(sm.split_softmax_plain(x).numpy(),
                                   torch.softmax(x, dim=1).numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_softmax_plan_classes():
    """The kernel's plan: every non-empty row once, by class (8-lane
    groups up to SOFTMAX_SUB_ROW entries, a warp up to SOFTMAX_LONG_ROW,
    a block up to SOFTMAX_BLOCK_ROW, the longest first, a cluster above),
    each class's entries, and the pieces of a split row cover it in
    order."""
    row_ptr, _, _, _ = _split_case(1, seed=0)
    plan = sm.softmax_plan(row_ptr, "cpu")
    lens = np.diff(row_ptr)
    assert plan.counts() == (4, 2, 2, 2)
    assert plan.entries == (2 * 87, 2 * 640, 2 * 641, 2 * 5000)
    rows = plan.rows.numpy()
    assert sorted(rows.tolist()) == np.flatnonzero(lens).tolist()
    assert (lens[rows[:plan.n_sub]] <= sm.SOFTMAX_SUB_ROW).all()
    o = plan.n_sub
    warp = lens[rows[o:o + plan.n_warp]]
    assert ((warp > sm.SOFTMAX_SUB_ROW) & (warp <= sm.SOFTMAX_LONG_ROW)).all()
    o += plan.n_warp
    block = lens[rows[o:o + plan.n_block]]
    assert ((block > sm.SOFTMAX_LONG_ROW)
            & (block <= sm.SOFTMAX_BLOCK_ROW)).all()
    assert (lens[rows[o + plan.n_block:]] > sm.SOFTMAX_BLOCK_ROW).all()
    # a causal mask's block rows, the longest first
    causal = np.r_[0, np.cumsum(np.arange(1, 4097))]
    plan = sm.softmax_plan(causal, "cpu")
    assert plan.counts() == (128, 512, 3456, 0)
    assert plan.entries[2] == 8185536 and sum(plan.entries) == 8390656
    block = plan.rows[640:].numpy()
    assert block.tolist() == list(range(4095, 639, -1))
    for n in (641, 5000, 8, 9):
        pieces = sm._pieces(n)
        assert len(pieces) == sm.SOFTMAX_SPLIT
        assert pieces[0][0] == 0 and pieces[-1][1] == n
        assert all(a == b0 for (_, a), (b0, _) in zip(pieces, pieces[1:]))


# each class's edge: its longest row and the next class's shortest
CLASS_EDGES = {"short/warp": (128, 129), "warp/block": (640, 641),
               "block/split": (4096, 4097)}


@pytest.mark.parametrize("edge", list(CLASS_EDGES))
def test_softmax_plan_class_edges(edge):
    """A row of each class's longest length and one entry longer fall
    in two classes, next to each other in the plan's order; the limits
    are the kernel's (16 entries a lane of a short row's 8, 20 a lane of
    a warp, 16 a thread of a block)."""
    assert (sm.SOFTMAX_SUB_ROW, sm.SOFTMAX_LONG_ROW, sm.SOFTMAX_BLOCK_ROW) \
        == (16 * 8, 20 * 32, 16 * sm.SOFTMAX_BLOCK_THREADS)
    lo, hi = CLASS_EDGES[edge]
    plan = sm.softmax_plan(np.r_[0, np.cumsum([hi, 0, lo, hi])], "cpu")
    i = list(CLASS_EDGES).index(edge)
    want = [0, 0, 0, 0]
    want[i], want[i + 1] = 1, 2
    assert list(plan.counts()) == want
    assert plan.rows.tolist() == [2, 0, 3]
    entries = [0, 0, 0, 0]
    entries[i], entries[i + 1] = lo, 2 * hi
    assert list(plan.entries) == entries


def test_softmax_plan_by_class():
    """The plan cut by class: each part holds that class's rows and
    entries alone, in the plan's order, and a class with no rows is left
    out."""
    row_ptr, _, _, _ = _split_case(1, seed=0)
    plan = sm.softmax_plan(row_ptr, "cpu")
    parts = plan.by_class()
    assert list(parts) == ["short", "warp", "block", "split"]
    assert torch.equal(torch.cat([p.rows for p in parts.values()]),
                       plan.rows)
    for i, name in enumerate(sm.CLASSES):
        counts = parts[name].counts()
        assert counts[i] == parts[name].rows.numel()
        assert sum(counts) == counts[i]
        assert parts[name].entries[i] == plan.entries[i]
        assert sum(parts[name].entries) == plan.entries[i]
    short = sm.softmax_plan(np.array([0, 3, 3, 10]), "cpu").by_class()
    assert list(short) == ["short"]
    causal = np.r_[0, np.cumsum(np.arange(1, 1001))]
    assert list(sm.softmax_plan(causal, "cpu").by_class()) == [
        "short", "warp", "block"]


# block rows: the first, a partial last slot round, one round short of
# the limit, the limit
BLOCK_LENGTHS = (641, 1000, 3839, 4096)


@pytest.mark.parametrize("heads", [1, 3])
def test_block_row_order_matches_jax(heads):
    """The block rows' plain counterpart (a thread's entries t, t + 256,
    .. summed in order, each warp's xor tree, the warps in order; the
    backward's 4-entry chunks from the row's aligned start) against JAX's
    segment_softmax and its jax.vjp, head by head, at each start of a row
    modulo 4 and the one-piece softmax; the forward's order of sums
    against a thread-by-thread loop."""
    rng = np.random.default_rng(20 + heads)
    lens = np.array([1, *BLOCK_LENGTHS, 3, *BLOCK_LENGTHS[::-1], 2])
    row_ptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    m, nnz = len(lens), int(row_ptr[-1])
    inv = rng.permutation(nnz + 100)[:nnz].astype(np.int32)
    flat = (rng.standard_normal((heads, nnz + 100)) * 4).astype(np.float32)
    g = rng.standard_normal((heads, nnz)).astype(np.float32)
    scale = 0.125
    rp, idx = torch.from_numpy(row_ptr), torch.from_numpy(inv)
    plan = sm.softmax_plan(row_ptr, "cpu")
    assert plan.n_block == 2 * len(BLOCK_LENGTHS)
    assert sorted(row_ptr[plan.rows[plan.n_sub:].numpy()] % 4) == [
        0, 0, 1, 1, 2, 2, 3, 3]
    got = sm.segment_softmax_split_plain(torch.from_numpy(flat), rp, scale,
                                         idx)
    d = sm.segment_softmax_backward_split_plain(
        got, torch.from_numpy(g), rp, scale, idx, flat.shape[1])
    rows = jnp.asarray(np.repeat(np.arange(m), lens))
    for h in range(heads):
        def f(s):
            return j_segment_softmax(jnp.take(s, jnp.asarray(inv)) * scale,
                                     rows, m)
        want, vjp = jax.vjp(f, jnp.asarray(flat[h]))
        np.testing.assert_allclose(got[h].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        (want_d,) = vjp(jnp.asarray(g[h]))
        np.testing.assert_allclose(d[h].numpy(), np.asarray(want_d),
                                   rtol=RTOL, atol=ATOL)
    x = torch.from_numpy(flat[:, inv]) * scale
    for r in range(1, m - 1):
        a, b = int(row_ptr[r]), int(row_ptr[r + 1])
        one = torch.softmax(x[:, a:b], dim=1)
        np.testing.assert_allclose(got[:, a:b].numpy(), one.numpy(),
                                   rtol=RTOL, atol=ATOL)
        # the forward's sums, thread by thread as the kernel adds them
        e = torch.exp(x[:, a:b] - x[:, a:b].amax(dim=1, keepdim=True))
        T = sm.SOFTMAX_BLOCK_THREADS
        for hh in range(heads):
            ev = e[hh].numpy()
            part = np.zeros(T, np.float32)
            for t in range(T):
                for k in range(t, b - a, T):
                    part[t] = np.float32(part[t] + ev[k])
            for o in (16, 8, 4, 2, 1):
                part = (part + part[np.arange(T) ^ o]).astype(np.float32)
            total = np.float32(0)
            for w in range(T // 32):
                total = part[32 * w] if w == 0 else np.float32(
                    total + part[32 * w])
            assert torch.equal(got[hh, a:b], e[hh] / float(total))


@pytest.mark.parametrize("heads", [1, 3])
def test_backward_rel_err_holds_each_entry_to_its_terms(heads):
    """``backward_rel_err`` scales an entry's error by the size of its
    terms: a wrong row sum in the 5000-entry row, whose values are small,
    passes a check scaled by the largest value of all rows and fails this
    one; a row sum taken in fp32 where ``g - sum`` cancels (a 2-entry row
    with equal cotangents) passes it, though it fails a check scaled by
    the row's own values; an entry with no terms must be exact."""
    row_ptr, _, flat, g = _split_case(heads, seed=7)
    x = torch.as_tensor(flat[:, :int(row_ptr[-1])])
    rp = torch.as_tensor(row_ptr)
    g = torch.as_tensor(g)
    p = sm.segment_softmax_plain(x, rp, 0.125)
    d = sm.segment_softmax_backward_plain(p, g, rp, 0.125)
    assert sm.backward_rel_err(d, d, p, g, rp, 0.125) == 0.0
    lens = np.diff(row_ptr)
    hub = int(np.argmax(lens))
    a, b = int(row_ptr[hub]), int(row_ptr[hub + 1])
    wrong = d.clone()
    # the hub's row sum off by 1e-4 of the sum of its |p * g|
    delta = 1e-4 * (p[:, a:b] * g[:, a:b]).abs().sum(dim=1, keepdim=True)
    wrong[:, a:b] -= 0.125 * p[:, a:b] * delta
    assert float((wrong - d).abs().max() / d.abs().max()) < 1e-5
    assert sm.backward_rel_err(wrong, d, p, g, rp, 0.125) > 1e-5
    # a 2-entry row whose cotangents agree to 1e-4, its row sum one fp32
    # rounding off (as a sum in another order may be)
    r = int(np.flatnonzero(lens == 86)[0])
    rp2 = torch.tensor([0, 2], dtype=torch.int64)
    p2 = p[:, row_ptr[r]:row_ptr[r] + 2]
    p2 = p2 / p2.sum(dim=1, keepdim=True)
    g2 = torch.full_like(p2, 0.7)
    g2[:, 1] += 1e-4
    want = sm.segment_softmax_backward_plain(p2, g2, rp2, 0.125)
    dot = (p2 * g2).double().sum(dim=1, keepdim=True).float()
    dot = torch.nextafter(dot, torch.full_like(dot, 2.0))
    got = 0.125 * (p2 * (g2 - dot))
    assert float((got - want).abs().max() / want.abs().max()) > 1e-5
    assert sm.backward_rel_err(got, want, p2, g2, rp2, 0.125) <= 1e-5
    bad = got.clone()
    bad[:, 0] += 0.125 * p2[:, 0] * 1e-3
    assert sm.backward_rel_err(bad, want, p2, g2, rp2, 0.125) > 1e-5
    none = torch.zeros((1, 1))
    assert sm.backward_rel_err(none + 1e-30, none, none, none,
                               torch.tensor([0, 1]), 0.125) == float("inf")


def test_softmax_module_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import sddmm_tpu_torch.ops.softmax\n"
         "import sddmm_tpu_torch.ops.gather_plan\n"
         "assert 'jax' not in sys.modules, 'jax loaded'\n"
         "assert 'sddmm_tpu' not in sys.modules, 'sddmm_tpu loaded'\n"
         "print('clean')\n"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
