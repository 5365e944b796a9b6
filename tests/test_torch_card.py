"""Tests of the port's CUDA kernels on the card.  They skip where there is no
CUDA card; on a machine with one (where jax need not be installed) run them
with

    python -m pytest tests/test_torch_card.py --noconftest -q

This file imports nothing of JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data import generate
from sddmm_tpu_torch.models import (BlockSparseAttention, GraphAttentionLayer,
                                    SparseFactorizationModel,
                                    make_attention_mask)
from sddmm_tpu_torch.ops import batch as bt
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops import softmax as sm
from sddmm_tpu_torch.ops import spmm as sp
from sddmm_tpu_torch.ops.gather_plan import gather_plan
from sddmm_tpu_torch.ops import project as pj
from sddmm_tpu_torch.ops import tile_dot as td
from sddmm_tpu_torch.ops.csr_sddmm import (csr_plan, csr_sddmm,
                                          csr_sddmm_torch)
from sddmm_tpu_torch.ops.dense import DenseSDDMM
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.reorder.autotune import from_params
from sddmm_tpu_torch.utils.check import check_values

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda

# kernel vs plain version: the same bf16 products (exact in fp32), summed by
# the tensor cores in another order than bmm's
TILE_REL = 1e-4
# gather-dot vs plain: both exact fp32 products, another sum order
GATHER_REL = 1e-6
# "float32" vs the fp64 product, max abs err / min |exact| on positive data:
# about one fp32 rounding ("tf32" errs by up to 3 * 2^-18 per product)
F32_EXACT = 1e-6
# SpMM kernel vs plain: the same fp32 products summed in another order, as
# max abs err / the sum of the terms' magnitudes.  A sum of n terms errs by
# up to (n-1) * 2^-24 of that, and by about sqrt(n) * 2^-24 in practice:
# 3.8e-6 for the 4096-entry rows of a global token
SPMM_REL = 1e-5
# softmax kernel vs plain, max |kernel - plain| / plain: the same fp32
# exps, the denominator summed in another order over up to 200,000 terms
SOFTMAX_REL = 1e-5
# a model's kernel path vs its plain path, as max abs diff / max |plain|:
# the scores differ by the tile sums' order, the aggregation by the SpMM's
# (an output near 0 has no relative error to speak of)
MODEL_PLAIN = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _u02(rng, shape, device, dtype=torch.float32):
    return torch.tensor(rng.uniform(0, 2, shape), dtype=torch.float32,
                        device=device).to(dtype)


def _rel(got, want):
    return ((got - want).abs() / want.abs()).max().item()


@pytest.mark.parametrize("R", [16, 32, 64, 128])
def test_tile_dot_kernel_matches_plain(R, cuda_device):
    rng = np.random.default_rng(R)
    a, b = _u02(rng, (37, R, 128), cuda_device), _u02(rng, (37, 384, 128),
                                                      cuda_device)
    n = _kernels.launches["sddmm_tile_dot_tf32"]
    got = td.tile_dot(a, b, "tf32")
    want = td.tile_dot_plain(a, b, "tf32")
    torch.cuda.synchronize()
    assert _kernels.launches["sddmm_tile_dot_tf32"] == n + 1
    assert _rel(got, want) <= TILE_REL


@pytest.mark.parametrize("mode", list(td.MODES))
def test_tile_dot_modes_ragged_strided(mode, cuda_device):
    """Each mode instance: R=37 and L=150 leave ragged windows, the output
    is a strided view at an odd offset, and a second K chunk (a column
    view of a wider operand) accumulates into it."""
    rng = np.random.default_rng(5)
    adt, bdt = td.STORAGE[mode]
    a = _u02(rng, (3, 37, 96), cuda_device, adt)
    b = _u02(rng, (3, 150, 96), cuda_device, bdt)
    buf = torch.full((3 * 37 * 151 + 1,), -7.0, device=cuda_device)
    out = buf[1:].view(3, 37, 151)[:, :, :150]
    td.tile_dot(a[:, :, :48], b[:, :, :48], mode, out=out)
    td.tile_dot(a[:, :, 48:], b[:, :, 48:], mode, out=out, accumulate=True)
    want = (td.tile_dot_plain(a[:, :, :48], b[:, :, :48], mode)
            + td.tile_dot_plain(a[:, :, 48:], b[:, :, 48:], mode))
    torch.cuda.synchronize()
    assert _rel(out, want) <= TILE_REL
    assert buf[0].item() == -7.0
    assert (buf[1:].view(3, 37, 151)[:, :, 150] == -7.0).all()
    if mode == "float32":
        assert _exact_err(out, a, b) <= F32_EXACT


def _exact_err(got, a, b):
    """max abs err / min |exact| of got against the fp64 product."""
    exact = torch.bmm(a.double(), b.double().transpose(1, 2))
    return ((got.double() - exact).abs().max() / exact.abs().min()).item()


@pytest.mark.parametrize("probe", [False, True], ids=["U02", "split_probe"])
def test_float32_instance_beats_tf32(probe, cuda_device):
    """On the same operands "float32" is within F32_EXACT of the fp64
    product and below "tf32"; on split_probe operands "tf32" misses
    3 * 2^-18 of each product, so an instance with fewer planes or
    products than float32's six fails here."""
    rng = np.random.default_rng(11)
    if probe:
        a = td.split_probe(rng, (8, 64, 256)).to(cuda_device)
        b = td.split_probe(rng, (8, 192, 256)).to(cuda_device)
    else:
        a = _u02(rng, (8, 64, 256), cuda_device)
        b = _u02(rng, (8, 192, 256), cuda_device)
    err = {mode: _exact_err(td.tile_dot(a, b, mode), a, b)
           for mode in ("float32", "tf32")}
    assert err["float32"] <= F32_EXACT, err
    assert err["float32"] < err["tf32"], err
    if probe:
        assert err["tf32"] >= 3 * 2.0 ** -18 * 0.9, err


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("storage", hy.GATHER_STORAGE,
                         ids=lambda p: "_".join(str(d)[6:] for d in p))
def test_gather_dot_kernel_matches_plain(G, C, storage, cuda_device):
    rng = np.random.default_rng(G * 10 + C)
    kc = 128 // C
    a = _u02(rng, (1025, 128), cuda_device, storage[0])
    bt = _u02(rng, (C, 513, G * kc), cuda_device, storage[1])
    rows = torch.tensor(rng.integers(0, 1025, 5000), dtype=torch.int32,
                        device=cuda_device)
    gids = torch.tensor(rng.integers(0, 513, 5000), dtype=torch.int32,
                        device=cuda_device)
    member = (torch.tensor(rng.integers(0, G, 5000), dtype=torch.int32,
                           device=cuda_device) if G > 1 else None)
    got = hy.residual_gather_dot(a, bt, rows, gids, member)
    want = hy.residual_gather_dot_plain(a, bt, rows, gids, member)
    torch.cuda.synchronize()
    assert _rel(got, want) <= GATHER_REL


def _quick_clustered():
    return generate.block_clustered(64, 64, block_prob=0.08,
                                    block_density=0.7, noise_density=0.0005,
                                    seed=42)


@pytest.mark.parametrize("kw", [
    dict(alpha=0.2, delta=0.05, b_cost_scale=2.0),
    dict(alpha=0.3, delta=0.0, group_size=4, merge_superpanels=False),
    dict(alpha=0.3, delta=0.05, group_size=2, k_chunks=2)],
    ids=["G1", "G4", "G2C2"])
def test_slice_on_card(kw, cuda_device):
    csr = _quick_clustered()
    t = from_params(csr, 128, **kw)
    a = generate.make_dense(csr.m, 128, seed=1)
    b = generate.make_dense(128, csr.n, seed=2)
    r = hy.HybridSDDMM(t.packed, k_chunks=t.k_chunks, a_layout="panels",
                       device=cuda_device)
    ops = r.prepare_operands(a, b=b)
    before = dict(_kernels.launches)
    got = r.run_padded(*ops, order="csr")
    plain = r.run_padded(*ops, order="csr", plain=True)
    torch.cuda.synchronize()
    # delta=0 leaves no residual, and an empty residual launches nothing
    used = ["sddmm_tile_dot_tf32"] + (
        ["sddmm_gather_dot_float32_float32"] if t.packed.nnz_res else [])
    for name in used:
        assert _kernels.launches[name] > before.get(name, 0)
    res = check_values(sddmm_reference(a, b, csr), got.cpu().numpy())
    assert res.passed and res.num_errors == 0, str(res)
    assert _rel(got, plain) <= TILE_REL


def test_slabs_on_card(cuda_device):
    csr = generate.powerlaw_graph(2048, avg_degree=16, seed=44)
    t = from_params(csr, 128, alpha=0.1, delta=0.05, hub_cols=256,
                    hot_rows=128, hot_rows_pre=True)
    assert t.packed.hub_cols and t.packed.rowslab_rows is not None
    a = generate.make_dense(csr.m, 128, seed=1)
    b = generate.make_dense(128, csr.n, seed=2)
    r = hy.HybridSDDMM(t.packed, device=cuda_device)
    got = r(a, b)
    torch.cuda.synchronize()
    res = check_values(sddmm_reference(a, b, csr), got.cpu().numpy())
    assert res.passed and res.num_errors == 0, str(res)


@pytest.mark.parametrize("mode", ["tf32", "float32"])
@pytest.mark.parametrize("K", [8, 24])
def test_tile_dot_any_k(K, mode, cuda_device):
    """K off the kernel's 16-step: tile_dot zero-pads copies of A and B
    before the launch; also a C=2 chunk of kc = K/2 accumulated into a
    strided output."""
    rng = np.random.default_rng(K)
    a = _u02(rng, (37, 37, K), cuda_device)
    b = _u02(rng, (37, 150, K), cuda_device)
    n = _kernels.launches[f"sddmm_tile_dot_{mode}"]
    got = td.tile_dot(a, b, mode)
    assert _kernels.launches[f"sddmm_tile_dot_{mode}"] == n + 1
    out = torch.zeros((37, 37, 151), device=cuda_device)[:, :, :150]
    h = K // 2
    td.tile_dot(a[:, :, :h], b[:, :, :h], mode, out=out)
    td.tile_dot(a[:, :, h:], b[:, :, h:], mode, out=out, accumulate=True)
    want = td.tile_dot_plain(a, b, mode)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TILE_REL
    assert _rel(out, want) <= TILE_REL
    if mode == "float32":
        # at K < 16 the exact values span a wide range, so each is held to
        # its own relative error, not to the smallest one
        exact = torch.bmm(a.double(), b.double().transpose(1, 2))
        assert _rel(got.double(), exact) <= F32_EXACT


@pytest.mark.parametrize("K", [8, 64, 128])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_spmm_kernel_matches_plain(order, K, cuda_device):
    """The SpMM kernel against its plain version: every 5th row empty
    (exact zeros), row 2 with 50,000 entries, rows sorted or not."""
    rng = np.random.default_rng(K)
    m, n = 3000, 4000
    deg = rng.integers(0, 30, m)
    deg[::5] = 0
    deg[2] = 50000
    rows = np.repeat(np.arange(m), deg)
    if order == "unsorted":
        rows = rng.permutation(rows)
    r = torch.tensor(rows, device=cuda_device)
    c = torch.tensor(rng.integers(0, n, len(rows)), dtype=torch.int32,
                     device=cuda_device)
    v = torch.tensor(rng.standard_normal(len(rows)), dtype=torch.float32,
                     device=cuda_device)
    d = torch.tensor(rng.standard_normal((n, K)), dtype=torch.float32,
                     device=cuda_device)
    before = _kernels.launches[_kernels.SPMM_ENTRY]
    got = sp.csr_spmm_torch(v, r, c, d, m)
    assert _kernels.launches[_kernels.SPMM_ENTRY] == before + 1
    want = sp.csr_spmm_plain(v, r, c, d, m)
    scale = sp.csr_spmm_plain(v.abs(), r, c, d.abs(), m)
    torch.cuda.synchronize()
    assert ((got - want).abs() / scale.clamp_min(1e-30)).max() <= SPMM_REL
    assert not got[torch.tensor(deg == 0, device=cuda_device)].any()


def test_graph_attention_kernel_path_matches_plain(cuda_device):
    """The graph layer's kernel path against its plain path, and against
    dense softmax attention in fp64, at a small size; the float32 tile
    instance, the gather-dot and the SpMM all launch."""
    adj = generate.powerlaw_graph(2000, avg_degree=12, seed=8)
    layer = GraphAttentionLayer(adj, 64, 64, device=cuda_device)
    p = layer.init(torch.Generator().manual_seed(0))
    x = torch.as_tensor(generate.make_dense(adj.m, 64, seed=1),
                        device=cuda_device)
    before = dict(_kernels.launches)
    with torch.inference_mode():
        got = layer(x)
        plain = layer(x, plain=True)
    torch.cuda.synchronize()
    used = ["sddmm_tile_dot_float32", _kernels.SPMM_ENTRY,
            _kernels.SOFTMAX_ENTRY] + (
        ["sddmm_gather_dot_float32_float32"]
        if layer.runner.packed.nnz_res else [])
    for name in used:
        assert _kernels.launches[name] > before.get(name, 0), name
    assert ((got - plain).abs().max() / plain.abs().max()).item() \
        <= MODEL_PLAIN
    q, k, v = (x.double() @ w.double() for w in p)
    mask = torch.zeros((adj.m, adj.m), dtype=torch.bool, device=cuda_device)
    mask[torch.as_tensor(adj.row_indices(), device=cuda_device),
         torch.as_tensor(adj.col_idx, dtype=torch.int64,
                         device=cuda_device)] = True
    s = (q @ k.T / 8.0).masked_fill(~mask, -torch.inf)
    want = torch.nan_to_num(torch.softmax(s, dim=1)) @ v
    res = check_values(want.cpu().numpy(), got.cpu().numpy())
    assert res.passed and res.num_errors == 0, str(res)
    # once a guard that raised: the backward runs on the kernels and its
    # weight gradients match the plain path's
    layer(x).square().sum().backward()
    kernel = [w.grad.clone() for w in layer.parameters()]
    layer.zero_grad()
    layer(x, plain=True).square().sum().backward()
    for g_k, w in zip(kernel, layer.parameters()):
        assert ((g_k - w.grad).abs().max() / w.grad.abs().max()).item() \
            <= MODEL_PLAIN


def test_batched_hybrid_and_overlap_report_on_card(cuda_device):
    """The batch is a loop over the runner on the card: each element equals
    its own call; batch_overlap_report times both with CUDA events."""
    csr = _quick_clustered()
    t = from_params(csr, 64, alpha=0.3, delta=0.05, group_size=2)
    r = hy.HybridSDDMM(t.packed, compute_dtype="float32", device=cuda_device)
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 2, (3, csr.m, 64)).astype(np.float32)
    b = rng.uniform(0, 2, (3, 64, csr.n)).astype(np.float32)
    got = bt.BatchedHybridSDDMM(r)(a, b)
    for i in range(3):
        flat = r.run_padded(*r.prepare_operands(a[i], b=b[i])).cpu().numpy()
        assert np.array_equal(got[i][t.packed.inv_idx],
                              flat[t.packed.inv_idx])
    rep = bt.batch_overlap_report(r, a, b, iterations=5)
    assert rep["batch_size"] == 3 and rep["batch_ms"] > 0
    assert rep["serial_ms"] > 0 and rep["overlap_efficiency"] > 0


@pytest.mark.parametrize("mode", ["tf32", "float32", "mixed"])
def test_dense_and_csr_baseline_on_card(mode, cuda_device):
    csr = generate.random_sparse(512, 384, density=0.2, seed=46)
    a = generate.make_dense(csr.m, 64, seed=1)
    b = generate.make_dense(64, csr.n, seed=2)
    want = sddmm_reference(a, b, csr)
    dense = DenseSDDMM.from_csr(csr, compute_dtype=mode, device=cuda_device)
    got = dense(a, b=b).cpu().numpy()
    res = check_values(want, got)
    assert res.passed and res.num_errors == 0, str(res)
    res = check_values(want, csr_sddmm(a, b, csr, device=cuda_device))
    assert res.passed and res.num_errors == 0, str(res)


def _committed(name, k):
    """from_params keywords of a committed config (as bench.py maps it),
    and its A layout."""
    cfg = json.loads((ROOT / "results" / "tuned_configs.json").read_text())[
        f"k{k}"][name]
    return cfg.get("a_layout", "rows"), dict(
                alpha=cfg["alpha"], delta=cfg["delta"],
                group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
                merge_superpanels=cfg.get("merge", True),
                hub_cols=cfg.get("hub", 0),
                b_cost_scale=cfg.get("b_cost_scale", 1.0),
                sort_runs=cfg.get("sort_runs", "cid"),
                sort_res=cfg.get("sort_res", "csr"))


@pytest.mark.parametrize("name,k", [("clustered16", 128), ("banded", 64),
                                    ("clustered16", 32)])
def test_one_tile_launch_per_call(name, k, cuda_device):
    """A committed config's packing of a small matrix: one call is one
    tile-kernel launch (every segment, chunk and slab) plus one gather-dot
    launch where there is a residual, and matches the per-segment plain
    route."""
    csr = _quick_clustered()
    a_layout, kw = _committed(name, k)
    t = from_params(csr, k, **kw)
    a = generate.make_dense(csr.m, k, seed=1)
    b = generate.make_dense(k, csr.n, seed=2)
    r = hy.HybridSDDMM(t.packed, k_chunks=t.k_chunks, a_layout=a_layout,
                       device=cuda_device)
    ops = r.prepare_operands(a, b=b)
    before = dict(_kernels.launches)
    got = r.run_padded(*ops, order="csr")
    torch.cuda.synchronize()
    counts = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
              if c > before.get(n, 0)}
    want = {"sddmm_tile_dot_tf32": 1}
    if t.packed.nnz_res:
        want["sddmm_gather_dot_float32_float32"] = 1
    assert counts == want
    plain = r.run_padded(*ops, order="csr", plain=True)
    assert _rel(got, plain) <= TILE_REL
    res = check_values(sddmm_reference(a, b, csr), got.cpu().numpy())
    assert res.passed and res.num_errors == 0, str(res)


@pytest.mark.parametrize("mode", ["float32", "tf32"])
def test_batched_one_launch_matches_loop(mode, cuda_device):
    """Three heads over a G=2, C=2 packing with a hub slab: one tile-kernel
    launch for all heads, equal to each head's own call."""
    csr = _quick_clustered()
    t = from_params(csr, 64, alpha=0.3, delta=0.05, group_size=2,
                    k_chunks=2, hub_cols=128)
    assert t.packed.hub_cols and t.k_chunks == 2
    r = hy.HybridSDDMM(t.packed, compute_dtype=mode, k_chunks=2,
                       device=cuda_device)
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.uniform(0, 2, (3, csr.m + 1, 64)),
                     dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rng.uniform(0, 2, (3, csr.n + 1, 64)),
                     dtype=torch.float32, device=cuda_device)
    a[:, -1] = 0
    b[:, -1] = 0
    n = _kernels.launches[f"sddmm_tile_dot_{mode}"]
    got = bt.BatchedHybridSDDMM(r).run_padded(a, b, order="csr")
    torch.cuda.synchronize()
    assert _kernels.launches[f"sddmm_tile_dot_{mode}"] == n + 1
    for h in range(3):
        one = r.run_padded(*r.device_prepare(a[h], b[h]), order="csr")
        assert torch.equal(got[h], one)
    plain = bt.BatchedHybridSDDMM(r).run_padded(a, b, order="csr",
                                                plain=True)
    assert _rel(got, plain) <= TILE_REL


@pytest.mark.parametrize("K", [64, 128])
def test_spmm_long_row_split_matches_plain(K, cuda_device):
    """Rows longer than SPMM_LONG_ROW (a global token's 4096 entries, and
    100,000) are split across a block's warps and their pieces added in a
    fixed order: within SPMM_REL of the plain version, the same on every
    run, and empty rows exact zeros."""
    rng = np.random.default_rng(K + 1)
    m, n = 2000, 3000
    deg = rng.integers(0, 600, m)
    deg[::9] = 0
    deg[5], deg[77], deg[1999] = 4096, 100000, sp.SPMM_LONG_ROW + 1
    row_ptr = np.r_[0, np.cumsum(deg)]
    cols = rng.integers(0, n, row_ptr[-1])
    plan = sp.spmm_plan(row_ptr, cols)
    assert (plan.tasks[:, 1] == 0).sum() == 3
    rows = torch.tensor(np.repeat(np.arange(m), deg), device=cuda_device)
    c = torch.tensor(cols, dtype=torch.int32, device=cuda_device)
    v = torch.tensor(rng.standard_normal(len(rows)), dtype=torch.float32,
                     device=cuda_device)
    d = torch.tensor(rng.standard_normal((n, K)), dtype=torch.float32,
                     device=cuda_device)
    rp = torch.tensor(row_ptr, device=cuda_device)
    plan_t = plan.to(cuda_device)
    got = sp.csr_spmm_torch(v, rows, c, d, m, row_ptr=rp, plan=plan_t)
    again = sp.csr_spmm_torch(v, rows, c, d, m, row_ptr=rp, plan=plan_t)
    want = sp.csr_spmm_plain(v, rows, c, d, m)
    scale = sp.csr_spmm_plain(v.abs(), rows, c, d.abs(), m)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ((got - want).abs() / scale.clamp_min(1e-30)).max() <= SPMM_REL
    assert not got[torch.tensor(deg == 0, device=cuda_device)].any()


def _panel_pattern(kind, L=1280):
    """(row_ptr, cols) of a Longformer-shaped band (window 128 a side and a
    global token, whose row and column hold every position) or of a causal
    mask, full or over a window of 128 keys; L = 1280 puts rows past
    SPMM_LONG_ROW in the full mask and the global row."""
    if kind == "band":
        mask = make_attention_mask(L, window=128, num_global=1)
        return mask.row_ptr.astype(np.int64), mask.col_idx.astype(np.int64)
    lo = np.maximum(np.arange(L) - (L if kind == "causal" else 127), 0)
    lengths = np.arange(L) + 1 - lo
    row_ptr = np.r_[0, np.cumsum(lengths)]
    return row_ptr, (np.arange(row_ptr[-1])
                     - np.repeat(row_ptr[:-1] - lo, lengths))


#: (input heads, dense heads, output heads, through the transpose): query
#: heads reading a group's V (kv_shift 2 and 4), and V's gradient summing
#: groups of 8 and 16 query heads, its values read through vidx
PANEL_HEADS = {"shift2": (16, 4, 16, False), "shift4": (16, 1, 16, False),
               "sum8": (16, 16, 2, True), "sum16": (16, 16, 1, True)}


@pytest.mark.parametrize("heads", sorted(PANEL_HEADS))
@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("kind", ["band", "causal", "window"])
def test_spmm_panel_kernel_matches_split_plain(kind, K, heads, cuda_device):
    """The panel path on a band with a global token and on causal masks
    (or their transposes, read through vidx): at least 95 % of the entries
    in panels, the launch bit-equal to ``csr_spmm_split_plain`` in the
    plan's order and on a second run, and within SPMM_REL of the plain
    version (rows that were long now sum in one pass)."""
    H, Hd, Ho, through_t = PANEL_HEADS[heads]
    row_ptr, cols = _panel_pattern(kind)
    L = len(row_ptr) - 1
    rows = np.repeat(np.arange(L), np.diff(row_ptr))
    vidx = None
    if through_t:
        pat = sp.SpmmPattern(cols, rows, L, cuda_device)
        (row_ptr, cols), vidx = pat._host, pat.vidx
        rows = np.repeat(np.arange(L), np.diff(row_ptr))
    plan = sp.spmm_plan(row_ptr, cols)
    assert plan.panel_entries >= 0.95 * len(cols)
    rng = np.random.default_rng(K + len(heads))
    v = torch.tensor(rng.standard_normal((H, len(cols))), dtype=torch.float32,
                     device=cuda_device)
    d = torch.tensor(rng.standard_normal((Hd, L, K)), dtype=torch.float32,
                     device=cuda_device)
    rp = torch.tensor(row_ptr, device=cuda_device)
    c = torch.tensor(cols, dtype=torch.int32, device=cuda_device)
    plan_t = plan.to(cuda_device)
    got, again = (torch.empty((Ho, 1, L, K), device=cuda_device)
                  for _ in range(2))
    n = _kernels.launches[_kernels.SPMM_ENTRY]
    sp.spmm_launch(plan_t, rp, c, v, d[:, None], got, vidx)
    sp.spmm_launch(plan_t, rp, c, v, d[:, None], again, vidx)
    assert _kernels.launches[_kernels.SPMM_ENTRY] == n + 2
    want = sp.csr_spmm_split_plain(v, c, d, row_ptr, plan, vidx, Ho)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got[:, 0], want)
    # the plain version, each output head's group summed
    vals = v if vidx is None else v[:, vidx.long()]
    r = torch.tensor(rows, device=cuda_device)
    shift, per = sp.head_shift(H, Hd), H // Ho
    for o in range(Ho):
        plain = scale = 0
        for i in range(o * per, (o + 1) * per):
            plain = plain + sp.csr_spmm_plain(vals[i], r, c, d[i >> shift], L)
            scale = scale + sp.csr_spmm_plain(vals[i].abs(), r, c,
                                              d[i >> shift].abs(), L)
        assert ((got[o, 0] - plain).abs() / scale.clamp_min(1e-30)).max() \
            <= SPMM_REL


@pytest.mark.parametrize("kind", ["band", "causal", "window"])
def test_spmm_panel_skips_columns_outside_a_row(kind, cuda_device):
    """A NaN in a dense row reaches exactly the rows that hold its column,
    though the panel stages that dense row for all 64 of its rows."""
    row_ptr, cols = _panel_pattern(kind)
    L = len(row_ptr) - 1
    plan = sp.spmm_plan(row_ptr, cols)
    assert plan.panel_entries >= 0.95 * len(cols)
    rng = np.random.default_rng(7)
    d = torch.tensor(rng.standard_normal((L, 64)), dtype=torch.float32,
                     device=cuda_device)
    bad = [300, 301, 1100]
    d[bad] = float("nan")
    v = torch.tensor(rng.standard_normal(len(cols)), dtype=torch.float32,
                     device=cuda_device)
    rows = torch.tensor(np.repeat(np.arange(L), np.diff(row_ptr)),
                        device=cuda_device)
    c = torch.tensor(cols, dtype=torch.int32, device=cuda_device)
    got = sp.csr_spmm_torch(v, rows, c, d, L,
                            row_ptr=torch.tensor(row_ptr, device=cuda_device),
                            plan=plan.to(cuda_device))
    holds = np.zeros(L, dtype=bool)
    holds[np.repeat(np.arange(L), np.diff(row_ptr))[np.isin(cols, bad)]] = True
    assert holds.any() and not holds.all()
    nan_rows = got.isnan().any(dim=1).cpu().numpy()
    assert np.array_equal(nan_rows, holds)
    assert got[torch.tensor(~holds, device=cuda_device)].isfinite().all()


def _shared_entries(rng, m, n_keys, order):
    """(rows, keys) int32 of clustered rows: groups of 8 rows draw 70 % of
    a common set of 40 keys; every 7th row is empty; rows shuffled, and the
    entries in CSR order ("sorted") or shuffled ("unsorted")."""
    rows, keys = [], []
    perm = rng.permutation(m)
    for g0 in range(0, m, 8):
        common = rng.choice(n_keys, 40, replace=False)
        for r in perm[g0:g0 + 8]:
            if r % 7 == 0:
                continue
            k = np.sort(common[rng.random(40) < 0.7])
            rows.append(np.full(len(k), r))
            keys.append(k)
    rows, keys = np.concatenate(rows), np.concatenate(keys)
    o = (np.lexsort((keys, rows)) if order == "sorted"
         else rng.permutation(len(rows)))
    return rows[o].astype(np.int32), keys[o].astype(np.int32)


def _gather_case(rng, G, C, storage, heads, K, order, device):
    kc = K // C
    m, ng = 600, 300
    rows, keys = _shared_entries(rng, m, ng * G, order)
    gids, member = keys // G, keys % G
    a = _u02(rng, (heads, m + 1, K), device, storage[0])
    b = _u02(rng, (heads, C, ng + 1, G * kc), device, storage[1])
    t = [torch.tensor(x, device=device) for x in (rows, gids, member)]
    return a, b, t[0], t[1], (t[2] if G > 1 else None), rows, keys


@pytest.mark.parametrize("plan_rows", [None, 2, 16], ids=["entries", "GR2",
                                                         "GR16"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("storage", hy.GATHER_STORAGE,
                         ids=lambda p: "_".join(str(d)[6:] for d in p))
def test_gather_dot_plan_matches_plain(storage, C, G, plan_rows,
                                       cuda_device):
    """The gather-dot walking a plan (groups of 2 or 16 rows) or the
    entries in their order, sorted and unsorted, for 3 heads in one
    launch: each head within GATHER_REL of the plain version."""
    rng = np.random.default_rng(G * 10 + C)
    for order in ("sorted", "unsorted"):
        a, b, rows, gids, member, r_np, k_np = _gather_case(
            rng, G, C, storage, 3, 128, order, cuda_device)
        plan = (None if plan_rows is None else
                gather_plan(r_np, k_np, group_rows=plan_rows).to(cuda_device))
        name = _kernels.gather_dot_entry(*storage)
        n = _kernels.launches[name]
        got = hy.residual_gather_dot(a, b, rows, gids, member, plan=plan)
        assert _kernels.launches[name] == n + 1
        torch.cuda.synchronize()
        for h in range(3):
            want = hy.residual_gather_dot_plain(a[h], b[h], rows, gids,
                                                member)
            assert _rel(got[h], want) <= GATHER_REL, (order, h)


@pytest.mark.parametrize("K,C", [(24, 2), (40, 1), (256, 1), (1024, 1)])
@pytest.mark.parametrize("plan_rows", [None, 8], ids=["entries", "GR8"])
def test_gather_dot_any_k(K, C, plan_rows, cuda_device):
    """kc off the 8-element loads (scalar lanes), kc below one step,
    K = 256 (32 lanes) and K = 1024 (slices past the registers' cache)."""
    rng = np.random.default_rng(K)
    a, b, rows, gids, member, r_np, k_np = _gather_case(
        rng, 1, C, (torch.float32, torch.float32), 2, K, "sorted",
        cuda_device)
    plan = (None if plan_rows is None else
            gather_plan(r_np, k_np, group_rows=plan_rows).to(cuda_device))
    got = hy.residual_gather_dot(a, b, rows, gids, member, plan=plan)
    torch.cuda.synchronize()
    for h in range(2):
        want = hy.residual_gather_dot_plain(a[h], b[h], rows, gids, member)
        assert _rel(got[h], want) <= GATHER_REL


def test_gather_dot_one_launch_for_heads(cuda_device):
    """The hybrid's residual over 3 heads (a G=2, C=2 packing) is one
    gather-dot launch, equal to each head's own call."""
    csr = _quick_clustered()
    t = from_params(csr, 64, alpha=0.3, delta=0.05, group_size=2,
                    k_chunks=2)
    assert t.packed.nnz_res
    r = hy.HybridSDDMM(t.packed, compute_dtype="float32", k_chunks=2,
                       device=cuda_device)
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.uniform(0, 2, (3, csr.m + 1, 64)),
                     dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rng.uniform(0, 2, (3, csr.n + 1, 64)),
                     dtype=torch.float32, device=cuda_device)
    name = "sddmm_gather_dot_float32_float32"
    n = _kernels.launches[name]
    got = bt.BatchedHybridSDDMM(r).run_padded(a, b, order="csr")
    torch.cuda.synchronize()
    assert _kernels.launches[name] == n + 1
    for h in range(3):
        one = r.run_padded(*r.device_prepare(a[h], b[h]), order="csr")
        assert torch.equal(got[h], one)


def _softmax_case(rng, heads, device):
    """Rows of 0..700 entries (every 7th empty, row 5 with 200,000 and
    some past SOFTMAX_LONG_ROW), packed scores with spare slots, and the
    CSR-order scores."""
    m = 3000
    deg = rng.integers(0, 700, m)
    deg[::7] = 0
    deg[5] = 200000
    row_ptr = np.r_[0, np.cumsum(deg)]
    nnz = int(row_ptr[-1])
    inv = rng.permutation(nnz + 1000)[:nnz]
    flat = torch.tensor(rng.standard_normal((heads, nnz + 1000)) * 4,
                        dtype=torch.float32, device=device)
    return (torch.tensor(row_ptr, device=device),
            torch.tensor(inv, dtype=torch.int32, device=device), flat, deg)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "csr"])
def test_softmax_kernel_matches_plain(packed, heads, cuda_device):
    """The segment softmax kernel against its plain version, from packed
    scores through inv_idx and from CSR-order scores, short rows in
    registers and long rows as blocks; the same on every run."""
    rng = np.random.default_rng(heads)
    row_ptr, inv, flat, deg = _softmax_case(rng, heads, cuda_device)
    if not packed:
        flat, inv = flat[:, inv.long()].contiguous(), None
    scale = 0.125
    n = _kernels.launches[_kernels.SOFTMAX_ENTRY]
    got = sm.segment_softmax_torch(flat, row_ptr, scale, inv)
    again = sm.segment_softmax_torch(flat, row_ptr, scale, inv)
    assert _kernels.launches[_kernels.SOFTMAX_ENTRY] == n + 2
    want = sm.segment_softmax_plain(flat, row_ptr, scale, inv)
    torch.cuda.synchronize()
    assert got.shape == (heads, int(deg.sum()))
    assert torch.equal(got, again)
    assert ((got - want).abs() / want).max().item() <= SOFTMAX_REL


def _boundary_case(rng, heads, device):
    """Rows about the kernel's class boundaries (8-lane groups up to 128
    entries, a warp up to 640, a block up to 4096, a cluster of 8 blocks
    above), each after 0 to 3 empty rows, and one 200,000-entry row:
    (row_ptr, inv_idx, packed scores, lengths)."""
    lens = []
    for n in (1, 3, 4, 5, 127, 128, 129, 130, 639, 640, 641, 642, 4095,
              4096, 4097, 4098):
        for pad in range(4):
            lens += [pad, n]
    lens += [200000, 7]
    deg = np.array(lens)
    row_ptr = np.r_[0, np.cumsum(deg)]
    nnz = int(row_ptr[-1])
    inv = rng.permutation(nnz + 1000)[:nnz]
    flat = torch.tensor(rng.standard_normal((heads, nnz + 1000)) * 4,
                        dtype=torch.float32, device=device)
    return (torch.tensor(row_ptr, device=device),
            torch.tensor(inv, dtype=torch.int32, device=device), flat, deg)


@pytest.mark.parametrize("heads", [1, 12])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "csr"])
def test_softmax_class_boundaries_match_plain(packed, heads, cuda_device,
                                              monkeypatch):
    """Forward and backward at the row classes' boundaries: kernel against
    the plain versions (the split rows also against the split-row
    combine's plain counterpart; the backward entry by entry, each to the
    size of its terms, and 0 in the padding slots), one launch each, two
    runs bit-equal, and any grouping of the heads bit-equal; the plan's
    classes as the wrapper builds them."""
    rng = np.random.default_rng(30 + heads)
    row_ptr, inv, flat, deg = _boundary_case(rng, heads, cuda_device)
    if not packed:
        flat, inv = flat[:, inv.long()].contiguous(), None
    plan = sm.softmax_plan(row_ptr.cpu().numpy(), cuda_device)
    assert plan.n_split == int((deg > sm.SOFTMAX_BLOCK_ROW).sum())
    assert plan.n_block == int(((deg > sm.SOFTMAX_LONG_ROW)
                                & (deg <= sm.SOFTMAX_BLOCK_ROW)).sum())
    assert plan.n_sub == int(((deg > 0)
                              & (deg <= sm.SOFTMAX_SUB_ROW)).sum())
    n = dict(_kernels.launches)
    got = sm.segment_softmax_torch(flat, row_ptr, 0.125, inv, plan)
    again = sm.segment_softmax_torch(flat, row_ptr, 0.125, inv, plan)
    g = torch.randn(got.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device)
    d = sm.segment_softmax_backward(got, g, row_ptr, 0.125, inv,
                                    flat.shape[1], plan)
    d2 = sm.segment_softmax_backward(got, g, row_ptr, 0.125, inv,
                                     flat.shape[1], plan)
    assert _launched(n) == {_kernels.SOFTMAX_ENTRY: 2,
                            _kernels.SOFTMAX_BWD_ENTRY: 2}
    want = sm.segment_softmax_plain(flat, row_ptr, 0.125, inv)
    split = sm.segment_softmax_split_plain(flat, row_ptr, 0.125, inv)
    want_d = sm.segment_softmax_backward_plain(got, g, row_ptr, 0.125, inv,
                                               flat.shape[1])
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(d, d2)
    # any grouping of the heads computes each head alike, bit for bit,
    # the block rows' blocks taking any number of a group's heads
    for hg, bh in ((2, 1), (5, 2), (heads, 3), (heads, heads)):
        monkeypatch.setattr(sm, "head_group",
                            lambda heads, backward, hg=hg: min(hg, heads))
        monkeypatch.setattr(sm, "block_head_group",
                            lambda heads, backward, bh=bh: min(bh, heads))
        assert torch.equal(sm.segment_softmax_torch(flat, row_ptr, 0.125,
                                                    inv, plan), got)
        assert torch.equal(sm.segment_softmax_backward(
            got, g, row_ptr, 0.125, inv, flat.shape[1], plan), d)
    assert ((got - want).abs() / want).max().item() <= SOFTMAX_REL
    assert ((got - split).abs() / split).max().item() <= SOFTMAX_REL
    if inv is None:
        assert sm.backward_rel_err(d, want_d, got, g, row_ptr,
                                   0.125) <= SOFTMAX_REL
    else:
        slots = inv.long()
        assert sm.backward_rel_err(d[:, slots], want_d[:, slots], got, g,
                                   row_ptr, 0.125) <= SOFTMAX_REL
        d[:, slots] = 0
        assert not d.any()


def _block_case(rng, heads, device):
    """Block rows (641 to 4096 entries: the edges and lengths at random)
    after 0 to 2 empty rows each, a few warp and short rows, and a
    5000-entry hub past the block rows in the same plan: (row_ptr,
    inv_idx into packed scores with spare slots, packed scores,
    lengths)."""
    lens = [641, 642, 4095, 4096, 5000, 300, 7]
    lens += rng.integers(641, 4097, 24).tolist()
    deg = []
    for i, n in enumerate(lens):
        deg += [0] * (i % 3) + [n]
    deg = np.array(deg)
    row_ptr = np.r_[0, np.cumsum(deg)]
    nnz = int(row_ptr[-1])
    inv = rng.permutation(nnz + 1000)[:nnz]
    flat = torch.tensor(rng.standard_normal((heads, nnz + 1000)) * 4,
                        dtype=torch.float32, device=device)
    return (torch.tensor(row_ptr, device=device),
            torch.tensor(inv, dtype=torch.int32, device=device), flat, deg)


@pytest.mark.parametrize("sink", [False, True], ids=["plain", "sink"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "csr"])
def test_softmax_block_rows_match_plain(packed, sink, cuda_device):
    """The block rows (641 to 4096 entries) against the plain versions,
    forward and backward, with and without inv_idx and the sink, 40 heads
    (the block rows' blocks take 16, 16 and 8 of the forward's 40 and 16
    and 4 of each backward group's 20): within SOFTMAX_REL of the plain
    softmax and of the block's order of sums (``block_softmax_plain`` and
    its backward), bit-equal on a second run, one launch each; the output
    written exactly on its entries, the packed gradient 0 in the padding
    slots; the sink's p_sink and gradient against the plain route's."""
    heads, scale = 40, 0.125
    rng = np.random.default_rng(50 + 2 * packed + sink)
    row_ptr, inv, flat, deg = _block_case(rng, heads, cuda_device)
    if not packed:
        flat, inv = flat[:, inv.long()].contiguous(), None
    plan = sm.softmax_plan(row_ptr.cpu().numpy(), cuda_device)
    assert (plan.n_block, plan.n_split) == (int(((deg > 640)
                                                 & (deg <= 4096)).sum()), 1)
    nnz = int(deg.sum())
    logits = (torch.randn(heads, device=cuda_device,
                          generator=torch.Generator(cuda_device).manual_seed(
                              5)) * 2 if sink else None)
    g = torch.randn((heads, nnz), generator=torch.Generator(
        device=cuda_device).manual_seed(6), device=cuda_device)
    runs, n = [], dict(_kernels.launches)
    for _ in range(2):
        x = flat.clone().requires_grad_()
        s = None if logits is None else logits.clone().requires_grad_()
        p = sm.segment_softmax_sink(x, s, row_ptr, scale, inv, plan)
        p.backward(g)
        runs.append((p.detach(), x.grad, None if s is None else s.grad))
    assert _launched(n) == {_kernels.SOFTMAX_ENTRY: 2,
                            _kernels.SOFTMAX_BWD_ENTRY: 2}
    for a, b in zip(*runs):
        assert a is None or torch.equal(a, b)
    p, d, d_sink = runs[0]
    x = flat.clone().requires_grad_()
    s = None if logits is None else logits.clone().requires_grad_()
    want = sm.segment_softmax_sink(x, s, row_ptr, scale, inv, plan,
                                   plain=True)
    want.backward(g)
    torch.cuda.synchronize()
    assert ((p - want).abs() / want).max().item() <= SOFTMAX_REL
    size = flat.shape[1]
    slots = (inv.long() if inv is not None
             else torch.arange(nnz, device=cuda_device))
    assert sm.backward_rel_err(d[:, slots], x.grad[:, slots], p, g, row_ptr,
                               scale) <= SOFTMAX_REL
    if inv is not None:
        pad = torch.ones(size, dtype=torch.bool, device=cuda_device)
        pad[slots] = False
        assert pad.any() and not d[:, pad].any()
    if sink:
        assert float((d_sink - s.grad).norm() / s.grad.norm()) \
            <= SOFTMAX_REL
        return
    order = sm.segment_softmax_split_plain(flat, row_ptr, scale, inv)
    assert ((p - order).abs() / order).max().item() <= SOFTMAX_REL
    order_d = sm.segment_softmax_backward_split_plain(p, g, row_ptr, scale,
                                                      inv, size)
    assert sm.backward_rel_err(d[:, slots], order_d[:, slots], p, g,
                               row_ptr, scale) <= SOFTMAX_REL
    # the forward writes exactly its entries
    buf = torch.full((heads, nnz + 7), -7.0, device=cuda_device)
    sm.segment_softmax_torch(flat, row_ptr, scale, inv, plan,
                             out=buf[:, 3:3 + nnz])
    torch.cuda.synchronize()
    assert (buf[:, :3] == -7.0).all() and (buf[:, 3 + nnz:] == -7.0).all()
    assert torch.equal(buf[:, 3:3 + nnz], p)


def test_softmax_refused_launch_raises(cuda_device):
    """A plan whose grid the card cannot take (over 2^31 - 1 blocks): the
    C entry refuses the launch, the wrapper raises and counts nothing."""
    rng = np.random.default_rng(4)
    row_ptr, inv, flat, _ = _softmax_case(rng, 1, cuda_device)
    out = torch.empty((1, inv.numel()), device=cuda_device)
    plan = sm.softmax_plan(row_ptr.cpu().numpy(), cuda_device)
    n = _kernels.launches[_kernels.SOFTMAX_ENTRY]
    with pytest.raises(RuntimeError, match="cudaError"):
        _kernels.launch(_kernels.SOFTMAX_ENTRY, flat.data_ptr(),
                        flat.stride(0), inv.data_ptr(), row_ptr.data_ptr(),
                        plan.rows.data_ptr(), 0, 0, 0, 2 ** 31, 1.0,
                        out.data_ptr(), out.stride(0), 1, 1, 1, None, None,
                        0, torch.cuda.current_stream().cuda_stream)
    # and a block row's 2^31 blocks
    with pytest.raises(RuntimeError, match="cudaError"):
        _kernels.launch(_kernels.SOFTMAX_ENTRY, flat.data_ptr(),
                        flat.stride(0), inv.data_ptr(), row_ptr.data_ptr(),
                        plan.rows.data_ptr(), 0, 0, 2 ** 30, 0, 1.0,
                        out.data_ptr(), out.stride(0), 2, 2, 1, None, None,
                        0, torch.cuda.current_stream().cuda_stream)
    assert _kernels.launches[_kernels.SOFTMAX_ENTRY] == n
    with pytest.raises(TypeError, match="SoftmaxPlan"):
        sm.segment_softmax_torch(flat, row_ptr, 1.0, inv,
                                 torch.zeros(1, dtype=torch.int64,
                                             device=cuda_device))


def test_softmax_empty_rows_write_nothing(cuda_device):
    """Empty rows (every 7th, and a run at the end) write nothing: the
    output, a view into a sentinel-filled buffer, is written exactly on
    its nnz slots; a pattern with no entries launches nothing."""
    rng = np.random.default_rng(2)
    row_ptr, inv, flat, deg = _softmax_case(rng, 2, cuda_device)
    nnz = int(deg.sum())
    row_ptr = torch.cat([row_ptr, row_ptr[-1:].repeat(50)])
    buf = torch.full((2, nnz + 7), -7.0, device=cuda_device)
    out = buf[:, 3:3 + nnz]
    sm.segment_softmax_torch(flat, row_ptr, 1.0, inv, out=out)
    torch.cuda.synchronize()
    assert (buf[:, :3] == -7.0).all() and (buf[:, 3 + nnz:] == -7.0).all()
    assert (out > 0).all()
    n = _kernels.launches[_kernels.SOFTMAX_ENTRY]
    empty = sm.segment_softmax_torch(
        flat[:, :0], torch.zeros(9, dtype=torch.int64, device=cuda_device))
    assert empty.shape == (2, 0)
    assert _kernels.launches[_kernels.SOFTMAX_ENTRY] == n


def test_one_softmax_launch_per_forward(cuda_device):
    """Each forward of the two models: one tile launch, at most one
    gather-dot launch (all heads), one softmax launch and one SpMM
    launch; the block-sparse layer's projections two split and two GEMM
    launches."""
    adj = generate.powerlaw_graph(1500, avg_degree=10, seed=3)
    graph = GraphAttentionLayer(adj, 32, 32, device=cuda_device)
    graph.init(torch.Generator().manual_seed(0))
    mask = make_attention_mask(320, window=16, num_global=2)
    block = BlockSparseAttention(mask, 48, 3, 16, device=cuda_device)
    block.init(torch.Generator().manual_seed(1))
    for model, x in ((graph, torch.as_tensor(generate.make_dense(
            adj.m, 32, seed=1), device=cuda_device)),
                     (block, torch.as_tensor(generate.make_dense(
                         320, 48, seed=2), device=cuda_device))):
        before = dict(_kernels.launches)
        with torch.inference_mode():
            got = model(x)
            torch.cuda.synchronize()
            counts = {n: c - before.get(n, 0)
                      for n, c in _kernels.launches.items()
                      if c > before.get(n, 0)}
            plain = model(x, plain=True)
        want = {"sddmm_tile_dot_float32": 1, _kernels.SPMM_ENTRY: 1,
                _kernels.SOFTMAX_ENTRY: 1}
        if model.runner.packed.nnz_res:
            want["sddmm_gather_dot_float32_float32"] = 1
        if model is block:   # Q, K, V and the output projection
            want.update({_kernels.PROJ_SPLIT_ENTRY: 2,
                         _kernels.PROJ_GEMM_ENTRY: 2})
        assert counts == want
        assert ((got - plain).abs().max() / plain.abs().max()).item() \
            <= MODEL_PLAIN


# -- the backward passes (B1-B4) and the trainer --

# a backward kernel vs its plain version on U[0,2) data (no cancellation):
# the same fp32 products summed in another order (the SpMM row by row in a
# fixed order, the plain index_add_ with atomics), as max |kernel - plain|
# / |plain| over the nonzero gradients
BACKWARD_REL = 1e-5


def _rel_nonzero(got, want):
    """max |got - want| / |want| where want != 0; got must be 0 where want
    is."""
    nz = want != 0
    assert not got[~nz].any()
    return ((got[nz] - want[nz]).abs() / want[nz].abs()).max().item()


def _launched(before):
    """The launches since ``before`` (a copy of the counts), by entry."""
    return {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
            if c > before.get(n, 0)}


def _backward_launches(runner):
    """B1's launches a backward: the tile-grad kernel and its reduction,
    and the residual's two SpMMs where the packing has one."""
    want = {_kernels.TILE_GRAD_ENTRY: 1, _kernels.TILE_GRAD_REDUCE_ENTRY: 1}
    if runner.packed.nnz_res:
        want[_kernels.SPMM_ENTRY] = 2
    return want


#: the hybrid backward's packings: from_params keywords, A layout
GRAD_CASES = {
    "G1 panels": (dict(alpha=0.2, delta=0.05, b_cost_scale=2.0), "panels"),
    "G2 residual": (dict(alpha=0.3, delta=0.05, group_size=2), "rows"),
    "G4": (dict(alpha=0.3, delta=0.0, group_size=4, merge_superpanels=False),
           "rows"),
    "slabs C2": (dict(alpha=0.1, delta=0.05, group_size=2, k_chunks=2,
                      hub_cols=256, hot_rows=128, hot_rows_pre=True),
                 "panels"),
}


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_hybrid_backward_on_card(name, cuda_device):
    """B1 on the card, 2 heads through BatchedHybridSDDMM: a backward is
    one tile-grad launch and one reduction (all heads and chunks), and two
    SpMM launches where the packing has a residual; no read pattern is
    built; the gradients of a cotangent on every packed slot equal the
    plain Function's (tile_table_grad_plain, plain SpMM) within
    BACKWARD_REL and are bit-equal on a second backward; with a cotangent
    on the real slots they pass the contract against the fp64 (G ⊙ S)·B
    and (G ⊙ S)^T·A."""
    kw, layout = GRAD_CASES[name]
    csr = (generate.powerlaw_graph(2048, avg_degree=16, seed=44)
           if "slabs" in name else _quick_clustered())
    K, H = 64, 2
    t = from_params(csr, K, **kw)
    r = hy.HybridSDDMM(t.packed, compute_dtype="float32",
                       k_chunks=t.k_chunks, a_layout=layout,
                       device=cuda_device)
    batched = bt.BatchedHybridSDDMM(r)
    rng = np.random.default_rng(3)
    a = _u02(rng, (H, csr.m, K), cuda_device)
    b = _u02(rng, (H, csr.n, K), cuda_device)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 1))  # noqa: E731

    def grads(g, order, plain=False, launched=None):
        a_t, b_t = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = batched.run_padded(pad(a_t), pad(b_t), order=order,
                                 plain=plain)
        before = dict(_kernels.launches)
        out.backward(g)
        if launched is not None:
            launched.update(_launched(before))
        return a_t.grad, b_t.grad

    g_all = _u02(rng, (H, t.packed.packed_size), cuda_device)
    ka, kb = grads(g_all, "packed")
    launched = {}
    ka2, kb2 = grads(g_all, "packed", launched=launched)
    assert launched == _backward_launches(r)
    assert r._read_grad is None
    pa, pb = grads(g_all, "packed", plain=True)
    torch.cuda.synchronize()
    assert r.grad_pattern_seconds is not None
    assert torch.equal(ka, ka2) and torch.equal(kb, kb2)
    assert _rel_nonzero(ka, pa) <= BACKWARD_REL
    assert _rel_nonzero(kb, pb) <= BACKWARD_REL
    g = _u02(rng, (H, csr.nnz), cuda_device)
    ka, kb = grads(g, "csr")
    rows = torch.as_tensor(csr.row_indices(), device=cuda_device)
    cols = torch.as_tensor(csr.col_idx, dtype=torch.int64,
                           device=cuda_device)
    for h in range(H):
        gd = torch.zeros((csr.m, csr.n), dtype=torch.float64,
                         device=cuda_device)
        gd[rows, cols] = g[h].double()
        for got, want in ((ka[h], gd @ b[h].double()),
                          (kb[h], gd.T @ a[h].double())):
            res = check_values(want.cpu().numpy(), got.cpu().numpy())
            assert res.passed and res.num_errors == 0, str(res)


@pytest.mark.parametrize("K", [32, 64, 128, 256, 40])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_tile_grad_kernel_matches_plain(name, K, cuda_device):
    """The tile-grad kernel and its reduction (tile_table_grad) against
    tile_table_grad_plain on U[0,2) operands and cotangent, at G 1/2/4, C
    1/2, both slabs, 1 and 12 heads (12 at K = 64), K 32-256 and K = 40
    (off the 16-step: zero-padded): within BACKWARD_REL, exactly one launch
    of each a call, bit-equal on a repeat, and ``accumulate`` adds to what
    is there; the pads' rows and lanes stay 0."""
    kw, layout = GRAD_CASES[name]
    csr = (generate.powerlaw_graph(2048, avg_degree=16, seed=44)
           if "slabs" in name else _quick_clustered())
    H = 12 if K == 64 else 1
    t = from_params(csr, K, **kw)
    p = t.packed
    r = hy.HybridSDDMM(p, compute_dtype="float32", k_chunks=t.k_chunks,
                       a_layout=layout, device=cuda_device)
    C, G = t.k_chunks, p.group_size
    kc = K // C
    rng = np.random.default_rng(K + len(name))
    a = _u02(rng, (H, p.m + 1, K), cuda_device)
    b = _u02(rng, (H, C, p.num_col_groups + 1, G * kc), cuda_device)
    g = _u02(rng, (H, p.packed_size), cuda_device)
    real = dict(real_rows=p.m, real_lanes=p.num_col_groups * G)

    def run(fn, accumulate=False, da=None, dbt=None):
        da = torch.empty_like(a) if da is None else da
        dbt = torch.empty_like(b) if dbt is None else dbt
        fn(a, b, g, r.table, da, dbt, accumulate=accumulate, **real)
        return da, dbt

    before = dict(_kernels.launches)
    ka, kb = run(td.tile_table_grad)
    assert _launched(before) == {_kernels.TILE_GRAD_ENTRY: 1,
                                 _kernels.TILE_GRAD_REDUCE_ENTRY: 1}
    ka2, kb2 = run(td.tile_table_grad)
    pa, pb = run(td.tile_table_grad_plain)
    torch.cuda.synchronize()
    assert torch.equal(ka, ka2) and torch.equal(kb, kb2)
    assert _rel_nonzero(ka, pa) <= BACKWARD_REL
    assert _rel_nonzero(kb, pb) <= BACKWARD_REL
    assert not ka[:, p.m].any() and not kb[:, :, -1].any()
    base_a, base_b = _u02(rng, a.shape, cuda_device), _u02(rng, b.shape,
                                                          cuda_device)
    sa, sb = run(td.tile_table_grad, True, base_a.clone(), base_b.clone())
    torch.cuda.synchronize()
    # the same partial sums in the same order, added to what was there
    assert torch.equal(sa, base_a + ka) and torch.equal(sb, base_b + kb)


def test_spmm_batch_strides_match_plain(cuda_device):
    """One SpMM launch for 2 heads x 2 chunks: values per head shared by
    the chunks, dense and out column slices of wider rows (chunk c is
    columns c*kc.. of a (rows, 2*kc) matrix), out's rows strided."""
    rng = np.random.default_rng(5)
    m, n, kc = 3000, 2000, 48
    deg = rng.integers(0, 60, m)
    deg[::7] = 0
    deg[3] = 3000
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, n, len(rows))
    pat = sp.SpmmPattern(rows, cols, m, cuda_device)
    vals = _u02(rng, (2, len(rows)), cuda_device)
    dense = _u02(rng, (2, n, 2 * kc), cuda_device)
    d4 = dense.view(2, n, 2, kc).transpose(1, 2)
    out = torch.zeros((2, m, 2 * kc), device=cuda_device)
    o4 = out.view(2, m, 2, kc).transpose(1, 2)
    cnt = _kernels.launches[_kernels.SPMM_ENTRY]
    pat(vals, d4, o4)
    assert _kernels.launches[_kernels.SPMM_ENTRY] == cnt + 1
    want = torch.zeros_like(o4)
    pat(vals, d4, want, plain=True)
    torch.cuda.synchronize()
    assert _rel_nonzero(o4, want) <= BACKWARD_REL
    assert not out[:, torch.as_tensor(deg == 0, device=cuda_device)].any()


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "csr"])
def test_softmax_backward_matches_plain(packed, heads, cuda_device):
    """B2 on the card: the backward entry of the softmax kernel against its
    plain version (short rows in registers, long rows as blocks), written
    at inv_idx into a zeroed packed gradient (padding slots exactly 0),
    bit-equal on a second call, one launch; the autograd op's gradient is
    the same."""
    rng = np.random.default_rng(heads + 10)
    row_ptr, inv, flat, _ = _softmax_case(rng, heads, cuda_device)
    if not packed:
        flat, inv = flat[:, inv.long()].contiguous(), None
    x = flat.clone().requires_grad_()
    p = sm.segment_softmax_torch(x, row_ptr, 0.125, inv)
    g = torch.randn(p.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    size = flat.shape[1]
    n = _kernels.launches[_kernels.SOFTMAX_BWD_ENTRY]
    got = sm.segment_softmax_backward(p.detach(), g, row_ptr, 0.125, inv,
                                      size)
    again = sm.segment_softmax_backward(p.detach(), g, row_ptr, 0.125, inv,
                                        size)
    assert _kernels.launches[_kernels.SOFTMAX_BWD_ENTRY] == n + 2
    want = sm.segment_softmax_backward_plain(p.detach(), g, row_ptr, 0.125,
                                             inv, size)
    p.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(x.grad, got)
    assert ((got - want).abs().max() / want.abs().max()).item() \
        <= SOFTMAX_REL
    if packed:
        pad = torch.ones(size, dtype=torch.bool, device=cuda_device)
        pad[inv.long()] = False
        assert pad.any() and not got[:, pad].any()


def test_csr_sddmm_and_spmm_backward_on_card(cuda_device):
    """B4 (csr_sddmm_torch: dA and dB^T, one SpMM launch each) and B3
    (csr_spmm_torch: d values one gather-dot launch, d dense one SpMM
    launch) against fp64 products under the contract."""
    csr = _quick_clustered()
    K = 64
    rng = np.random.default_rng(8)
    a = _u02(rng, (csr.m, K), cuda_device).requires_grad_()
    b = _u02(rng, (csr.n, K), cuda_device).requires_grad_()
    rows = torch.as_tensor(csr.row_indices(), dtype=torch.int32,
                           device=cuda_device)
    cols = torch.as_tensor(csr.col_idx, dtype=torch.int32,
                           device=cuda_device)
    g = _u02(rng, csr.nnz, cuda_device)
    before = dict(_kernels.launches)
    csr_sddmm_torch(a, b, rows, cols, csr_plan(csr).to(cuda_device)
                    ).backward(g)
    assert (_kernels.launches[_kernels.SPMM_ENTRY]
            - before.get(_kernels.SPMM_ENTRY, 0)) == 2
    gd = torch.zeros((csr.m, csr.n), dtype=torch.float64, device=cuda_device)
    gd[rows.long(), cols.long()] = g.double()
    for got, want in ((a.grad, gd @ b.detach().double()),
                      (b.grad, gd.T @ a.detach().double())):
        res = check_values(want.cpu().numpy(), got.cpu().numpy())
        assert res.passed and res.num_errors == 0, str(res)
    vals = _u02(rng, csr.nnz, cuda_device).requires_grad_()
    dense = _u02(rng, (csr.n, K), cuda_device).requires_grad_()
    dout = _u02(rng, (csr.m, K), cuda_device)
    row_ptr = torch.as_tensor(csr.row_ptr, device=cuda_device)
    plan = sp.spmm_plan(csr.row_ptr, csr.col_idx).to(cuda_device)
    before = dict(_kernels.launches)
    sp.csr_spmm_torch(vals, rows.long(), cols, dense, csr.m, row_ptr=row_ptr,
                      plan=plan).backward(dout)
    got = {k: c - before.get(k, 0) for k, c in _kernels.launches.items()
           if c > before.get(k, 0)}
    assert got == {_kernels.SPMM_ENTRY: 2,
                   "sddmm_gather_dot_float32_float32": 1}
    assert plan.grads is not None
    want_v = (dout.double()[rows.long()]
              * dense.detach().double()[cols.long()]).sum(1)
    sd = torch.zeros((csr.m, csr.n), dtype=torch.float64, device=cuda_device)
    sd[rows.long(), cols.long()] = vals.detach().double()
    for got, want in ((vals.grad, want_v), (dense.grad, sd.T @ dout.double())):
        res = check_values(want.cpu().numpy(), got.cpu().numpy())
        assert res.passed and res.num_errors == 0, str(res)


def test_longformer_layer_aggregates_in_one_launch(cuda_device):
    """A Longformer-base-shaped layer (4096 positions, window 256, 1 global
    token, 12 heads of 64): its forward is one SpMM launch for all heads
    over the one copy of the mask, and that head-strided launch's output
    equals 12 one-head launches of the same plan, bit for bit."""
    mask = make_attention_mask(4096, window=256, num_global=1)
    block = BlockSparseAttention(mask, 768, 12, 64, device=cuda_device)
    block.init(torch.Generator().manual_seed(2))
    x = torch.randn((4096, 768), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    before = dict(_kernels.launches)
    with torch.inference_mode():
        block(x)
    torch.cuda.synchronize()
    assert _launched(before)[_kernels.SPMM_ENTRY] == 1
    agg = block.core.agg
    assert agg.cols.shape == (mask.nnz,)
    gen = torch.Generator(cuda_device).manual_seed(4)
    p = torch.rand((12, mask.nnz), device=cuda_device, generator=gen)
    v = torch.randn((12, 4096, 64), device=cuda_device, generator=gen)
    with torch.inference_mode():
        got = sp.head_spmm(p, v, agg)
        one = torch.stack([sp.head_spmm(p[h:h + 1], v[h:h + 1], agg)[0]
                           for h in range(12)])
    assert torch.equal(got, one)


def test_model_backward_launches(cuda_device):
    """A backward of each model after its forward: one softmax-backward
    launch, one gather-dot launch (the attention's cotangent), one SpMM
    launch (V's cotangent) and the SDDMM's backward (the tile-grad kernel,
    its reduction and, with a residual, two SpMM launches), all heads
    together, and the block-sparse layer's projections' (two split
    launches, three GEMMs); its weight gradients match the plain path's."""
    adj = generate.powerlaw_graph(1500, avg_degree=10, seed=3)
    graph = GraphAttentionLayer(adj, 32, 32, device=cuda_device)
    graph.init(torch.Generator().manual_seed(0))
    mask = make_attention_mask(320, window=16, num_global=2)
    block = BlockSparseAttention(mask, 48, 3, 16, device=cuda_device)
    block.init(torch.Generator().manual_seed(1))
    for model, x in ((graph, torch.as_tensor(generate.make_dense(
            adj.m, 32, seed=1), device=cuda_device)),
                     (block, torch.as_tensor(generate.make_dense(
                         320, 48, seed=2), device=cuda_device))):
        model.zero_grad()
        loss = model(x).square().sum()
        torch.cuda.synchronize()
        before = dict(_kernels.launches)
        loss.backward()
        torch.cuda.synchronize()
        counts = {n: c - before.get(n, 0)
                  for n, c in _kernels.launches.items()
                  if c > before.get(n, 0)}
        want = _backward_launches(model.runner)
        want[_kernels.SPMM_ENTRY] = want.get(_kernels.SPMM_ENTRY, 0) + 1
        want.update({_kernels.SOFTMAX_BWD_ENTRY: 1,
                     "sddmm_gather_dot_float32_float32": 1})
        if model is block:   # x needs no gradient: dW of Q, K, V alone
            want.update({_kernels.PROJ_SPLIT_ENTRY: 2,
                         _kernels.PROJ_GEMM_ENTRY: 3})
        assert counts == want
        kernel = [w.grad.clone() for w in model.parameters()]
        model.zero_grad()
        model(x, plain=True).square().sum().backward()
        for g_k, w in zip(kernel, model.parameters()):
            assert ((g_k - w.grad).abs().max()
                    / w.grad.abs().max()).item() <= MODEL_PLAIN


def test_factorization_trains_on_card(cuda_device):
    """The trainer on the card: the loss falls; a step launches the tile
    kernel once, the gather-dot once (a residual) and B1's kernels."""
    csr = _quick_clustered()
    model = SparseFactorizationModel.from_csr(csr, 32, device=cuda_device)
    model.init(torch.Generator().manual_seed(0))
    step = model.make_train_step()
    tp = model.pack_targets(csr.values)
    losses = [float(step(tp))]
    before = dict(_kernels.launches)
    losses.append(float(step(tp)))
    counts = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
              if c > before.get(n, 0)}
    want = {"sddmm_tile_dot_float32": 1, **_backward_launches(model.runner)}
    if model.packed.nnz_res:
        want["sddmm_gather_dot_float32_float32"] = 1
    assert counts == want
    losses += [float(step(tp)) for _ in range(18)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_gather_dot_k4096_csr_baseline(cuda_device):
    """clustered128's CSR baseline plans groups of 16 rows, whose block
    would need 282 KB of shared memory at K = 4096: the launch takes the
    entry walk of the same kernel, one launch, and its values match the
    fp64 dots (on a sample of entries)."""
    csr = generate.block_clustered(128, 128, group_rows=128, group_cols=128,
                                   block_prob=0.025, block_density=0.3,
                                   noise_density=0.00001, seed=43)
    plan = csr_plan(csr)
    K = 4096
    assert plan.group_rows == 16 and not hy.planned_walk(plan, K)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.rand((csr.m, K), generator=gen, device=cuda_device)
    b = torch.rand((csr.n, K), generator=gen, device=cuda_device)
    rows = torch.as_tensor(csr.row_indices(), dtype=torch.int32,
                           device=cuda_device)
    cols = torch.as_tensor(csr.col_idx, dtype=torch.int32,
                           device=cuda_device)
    n = _kernels.launches["sddmm_gather_dot_float32_float32"]
    got = csr_sddmm_torch(a, b, rows, cols, plan.to(cuda_device))
    torch.cuda.synchronize()
    assert _kernels.launches["sddmm_gather_dot_float32_float32"] == n + 1
    s = torch.randint(0, csr.nnz, (8192,), generator=gen, device=cuda_device)
    want = (a[rows[s].long()].double() * b[cols[s].long()].double()).sum(1)
    assert _rel(got[s].double(), want) <= GATHER_REL


def test_runner_gr16_residual_plan_at_k4096(cuda_device):
    """A runner whose residual plan groups 16 rows, called at K = 4096:
    the launch takes the entry walk (it used to be refused by
    cudaFuncSetAttribute), and CSR order passes the contract."""
    csr = _quick_clustered()
    K = 4096
    t = from_params(csr, K, alpha=0.3, delta=0.05)
    p = t.packed
    assert p.nnz_res
    r = hy.HybridSDDMM(p, compute_dtype="float32", device=cuda_device)
    r.res_plan = gather_plan(p.res_rows, p.res_gids.astype(np.int64),
                             hy.packing_row_order(p), 16).to(cuda_device)
    assert not hy.planned_walk(r.res_plan, K)
    a = generate.make_dense(csr.m, K, seed=1)
    b = generate.make_dense(K, csr.n, seed=2)
    got = r(a, b)
    torch.cuda.synchronize()
    res = check_values(sddmm_reference(a, b, csr), got.cpu().numpy())
    assert res.passed and res.num_errors == 0, str(res)


@pytest.mark.parametrize("kind", ["hybrid", "dense"])
def test_measure_kernel_ms_agrees_with_cuda_time_ms(kind, cuda_device):
    """The runners' ``measure_kernel_ms`` (the median of sessions of event
    medians) lies within the spread of ``cuda_time_ms`` of the same
    ``run_padded`` call (10 % each side: two sets of samples)."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    csr = _quick_clustered()
    if kind == "dense":
        runner = DenseSDDMM.from_csr(csr, device=cuda_device)
    else:
        runner = hy.HybridSDDMM(from_params(csr, 128, 0.3, 0.05).packed,
                                device=cuda_device)
    ops = runner.prepare_operands(generate.make_dense(csr.m, 128, seed=1),
                                  b=generate.make_dense(128, csr.n, seed=2))
    got = runner.measure_kernel_ms(*ops, iterations=30, repeats=3)
    t = cuda_time_ms(lambda: runner.run_padded(*ops), 30)
    assert 0.9 * t["min_ms"] <= got <= 1.1 * t["max_ms"], (got, t)


def test_bench_quick_on_card(cuda_device, capsys):
    """``python -m sddmm_tpu_torch.bench --quick`` on the card: one JSON
    line, the retuned (shoot-out) configs, every cell timed."""
    from sddmm_tpu_torch import bench
    out = bench.main(["--quick", "--sessions", "1", "--iterations", "5"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["backend"] == "torch-cuda" and out["stream_gbps"] > 0
    assert sorted(out["per_matrix"]) == ["clustered16", "powerlaw"]
    assert all(v > 0 for v in out["per_matrix"].values())
    assert all(v > 0 for v in out["per_matrix_csr_order"].values())
    assert all(v is not None for v in out["sol_fraction"].values())
    assert all(v is None for v in out["roofline_fraction"].values())


def test_shootout_times_every_finalist_on_card(cuda_device):
    """``autotune(measure=True)`` builds every finalist on the card and
    times it; the winner is the fastest and delivers correct values."""
    from sddmm_tpu_torch.bench import config_of
    from sddmm_tpu_torch.reorder.autotune import autotune
    csr = _quick_clustered()
    win = autotune(csr, k=64, measure=True, measure_iterations=5,
                   device=cuda_device)
    assert len(win.shootout) >= 3
    assert all(f.measured_ms > 0 and f.setup_s >= 0 for f in win.shootout)
    assert win.measured_ms == min(f.measured_ms for f in win.shootout)
    assert win is win.shootout[0]
    if win.dense:
        runner = DenseSDDMM.from_csr(csr, device=cuda_device)
    else:
        runner = hy.HybridSDDMM(win.packed, k_chunks=win.k_chunks,
                                a_layout=win.a_layout, device=cuda_device)
    a = generate.make_dense(csr.m, 64, seed=1)
    b = generate.make_dense(64, csr.n, seed=2)
    res = check_values(sddmm_reference(a, b, csr),
                       runner(a, b).cpu().numpy())
    assert res.passed and res.num_errors == 0, (config_of(win, "tf32"),
                                                 str(res))


def _calibrate_module():
    import sys
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import torch_calibrate
    return torch_calibrate


@pytest.mark.parametrize("mode", ["tf32", "bfloat16", "float32"])
def test_calibration_dot_probe_agrees_with_tile_table(mode, cuda_device):
    """The calibration's dot probe rate (M 16-row groups/s, calls queued
    behind a held stream) is within 2x of the rate from ``tile_table``
    event times taken directly, one call at a time, on a batch 16x larger
    (long enough that the host's enqueue does not set the pace); the probe
    itself raises unless every call launched the kernel."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms
    calib = _calibrate_module()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    m = 64
    rate = calib.probe_dot(cuda_device, gen, mode, m, 1, 50, 3)
    nb = 16 * calib.DOT_TILES // (m // 16)
    adt, bdt = td.STORAGE[mode]
    a = torch.rand((1, nb * m, 128), device=cuda_device).to(adt)
    b = torch.rand((1, 1, nb * 128, 128), device=cuda_device).to(bdt)
    out = torch.empty((1, nb * m * 128), device=cuda_device)
    table = td.identity_table(nb, m, 128, m, 128, m * 128, 128, cuda_device)
    ms = cuda_time_ms(lambda: td.tile_table(a, b, table, mode, out),
                      20)["median_ms"]
    direct = nb * (m // 16) / ms / 1e3
    assert 0.5 <= rate / direct <= 2.0, (rate, direct)


def test_queued_time_reads_the_device(cuda_device):
    """``queued_time_ms`` agrees with per-call events on a copy long enough
    to hide the host, and reads less than they do on a call whose host
    wrapper is slower than its kernel."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms, queued_time_ms
    src = torch.ones(1 << 28, dtype=torch.uint8, device=cuda_device)
    dst = torch.empty_like(src)
    big = queued_time_ms(lambda: dst.copy_(src), 20)
    per_call = cuda_time_ms(lambda: dst.copy_(src), 20)["median_ms"]
    assert 0.9 * per_call <= big <= 1.1 * per_call, (big, per_call)
    x = torch.ones(8, device=cuda_device)

    def slow_host():
        for _ in range(20):
            x.add_(0.0)

    assert queued_time_ms(slow_host, 50) < cuda_time_ms(
        slow_host, 50)["median_ms"]


def test_committed_calibration_on_card(cuda_device):
    """``load_calibration`` of the committed ``calibration_h100.json``
    changes ``estimate_ms`` on a bench packing, and the calibrated
    shoot-out's winner has 0 errors against fp64; the shipped constants are
    put back."""
    import copy
    from sddmm_tpu_torch import bench
    from sddmm_tpu_torch.reorder import autotune as at
    names = ("STREAM_GBPS", "_ROW_RATE_8MB", "_SRC_MB", "_SRC_F",
             "_DOT_G16_MS")
    saved = {n: copy.copy(getattr(at, n)) for n in names}
    path = ROOT / "sddmm_tpu_torch" / "calibration_h100.json"
    cal = json.loads(path.read_text())
    assert cal["platform"] == "gpu" and "H100" in cal["card"]
    csr = bench.suite(quick=True)["clustered16"]()
    t = bench.fold_config(csr, 128, bench.load_tuned_config(
        "clustered16", 128) or {"alpha": 0.3, "delta": 0.05}, "tf32")
    shipped = at.estimate_ms(t.packed, 128, "tf32", t.k_chunks)
    try:
        at.load_calibration(path)
        assert at.estimate_ms(t.packed, 128, "tf32", t.k_chunks) != shipped
        win = at.autotune(csr, k=128, measure=True, measure_iterations=5,
                          device=cuda_device)
        if win.dense:
            runner = DenseSDDMM.from_csr(csr, device=cuda_device)
        else:
            runner = hy.HybridSDDMM(win.packed, k_chunks=win.k_chunks,
                                    use_pallas=win.use_pallas,
                                    a_layout=win.a_layout,
                                    device=cuda_device)
        a = generate.make_dense(csr.m, 128, seed=1)
        b = generate.make_dense(128, csr.n, seed=2)
        res = check_values(sddmm_reference(a, b, csr),
                           runner(a, b, order="csr").cpu().numpy())
        assert res.passed and res.num_errors == 0, str(res)
    finally:
        for n, v in saved.items():
            if isinstance(v, dict):
                getattr(at, n).clear()
                getattr(at, n).update(v)
            else:
                setattr(at, n, v)
    assert at.STREAM_GBPS == saved["STREAM_GBPS"]


def _cluster_args(csr, col_block_size=16):
    from sddmm_tpu_torch.reorder import rows
    bp, bi, bc, nb = rows.row_encodings(csr, col_block_size)
    disp = rows.dispersion_scores(csr, bp, bc, col_block_size)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]
    return order, bp, bi, bc, nb


def test_cluster_round_kernel_matches_plain(cuda_device):
    """The clustering kernel K9 against its plain round on the card and the
    host batched clustering at fp32: the same clusters exactly, two
    launches a round."""
    from sddmm_tpu_torch.reorder import device_cluster as dc
    from sddmm_tpu_torch.reorder import rows
    csr = generate.block_clustered(256, 256, block_prob=0.01,
                                   block_density=0.6, noise_density=1e-4,
                                   seed=72)
    args = _cluster_args(csr)
    _kernels.launches.clear()
    record = {}
    got = dc.batched_cluster_device(*args, 0.3, device=cuda_device,
                                    record=record)
    launches = dict(_kernels.launches)
    plain = dc.batched_cluster_device(*args, 0.3, device=cuda_device,
                                      plain=True)
    host = rows._batched_cluster(*args, 0.3, hat_dtype=np.float32)
    assert got[1] == plain[1] == host[1]
    assert np.array_equal(got[0], plain[0])
    assert np.array_equal(got[0], host[0])
    # two launches a round enqueued (rounds past the end return at once)
    n = record["rounds_enqueued"]
    assert n >= record["rounds"] and record["fetches"] >= 1
    assert launches == {_kernels.CLUSTER_LEADERS_ENTRY: n,
                        _kernels.CLUSTER_ASSIGN_ENTRY: n}


@pytest.mark.parametrize("per_fetch", [1, 5, 64])
@pytest.mark.parametrize("case", ["bail", "max_rounds", "L=64"])
def test_cluster_round_device_loop_matches_plain(case, per_fetch,
                                                 cuda_device, monkeypatch):
    """The bail, max_rounds and the kernel's largest L tested on the card
    inside the rounds: the same clusters, rounds and clusters a round as
    the plain rounds, at any batch size; a second run bit-equal."""
    from sddmm_tpu_torch.reorder import device_cluster as dc
    if case == "bail":
        csr = generate.powerlaw_graph(2048, avg_degree=6, seed=55)
        kw = dict(leaders_per_round=8, bail_after=3, bail_yield=4.0)
    elif case == "max_rounds":
        csr = generate.banded(512, 512, bandwidth=12, fill=0.6, seed=52)
        kw = dict(leaders_per_round=4, max_rounds=5)
    else:
        csr = generate.hypersparse_dense_mix(512, 4096, density=2e-3,
                                             num_dense_rows=6,
                                             num_dense_cols=4, seed=57)
        kw = dict(leaders_per_round=dc.MAX_LEADERS)
    args = _cluster_args(csr)
    rec_k, rec_p = {}, {}
    monkeypatch.setattr(dc, "ROUNDS_PER_FETCH", per_fetch)
    got = dc.batched_cluster_device(*args, 0.5, device=cuda_device,
                                    record=rec_k, **kw)
    again = dc.batched_cluster_device(*args, 0.5, device=cuda_device, **kw)
    plain = dc.batched_cluster_device(*args, 0.5, device=cuda_device,
                                      plain=True, record=rec_p, **kw)
    assert got[1] == plain[1] == again[1]
    assert np.array_equal(got[0], plain[0])
    assert np.array_equal(got[0], again[0])
    assert rec_k["rounds"] == rec_p["rounds"]
    assert rec_k["clusters"] == rec_p["clusters"]


@pytest.mark.parametrize("L", [65, 96, 256])
def test_cluster_round_many_leaders_matches_plain(L, cuda_device):
    """More than 64 candidates a round (the accepted mask over several
    32-bit words, the rows' pass over several warp-wide chunks of
    candidates): the same cluster_of, rounds and clusters a round as the
    plain round on the card, on dense rows and on a power law."""
    from sddmm_tpu_torch.reorder import device_cluster as dc
    for csr in (generate.hypersparse_dense_mix(512, 4096, density=2e-3,
                                               num_dense_rows=6,
                                               num_dense_cols=4, seed=57),
                generate.powerlaw_graph(4096, avg_degree=8, seed=58)):
        args = _cluster_args(csr)
        rec_k, rec_p = {}, {}
        got = dc.batched_cluster_device(*args, 0.3, leaders_per_round=L,
                                        device=cuda_device, record=rec_k)
        plain = dc.batched_cluster_device(*args, 0.3, leaders_per_round=L,
                                          device=cuda_device, plain=True,
                                          record=rec_p)
        assert got[1] == plain[1]
        assert np.array_equal(got[0], plain[0])
        assert rec_k["rounds"] == rec_p["rounds"]
        assert rec_k["clusters"] == rec_p["clusters"]


def test_cluster_round_refuses_what_it_cannot_take(cuda_device):
    """More candidates a round than the kernel's accepted mask holds
    (MAX_LEADERS / 32 words): the wrapper raises naming the limit, and the
    C entry refuses the launch (cudaErrorInvalidValue), which raises;
    nothing falls back."""
    from sddmm_tpu_torch.reorder import device_cluster as dc
    csr = generate.block_clustered(16, 16, block_prob=0.1, seed=3)
    args = _cluster_args(csr)
    L = dc.MAX_LEADERS + 1
    with pytest.raises(ValueError, match="MAX_LEADERS"):
        dc.batched_cluster_device(*args, 0.3, leaders_per_round=L,
                                  device=cuda_device)
    enc = dc.encodings(*args, cuda_device)
    st = dc.RoundState.start(enc, L)
    n = _kernels.launches[_kernels.CLUSTER_LEADERS_ENTRY]
    with pytest.raises(RuntimeError, match="cudaError"):
        _kernels.launch(
            _kernels.CLUSTER_LEADERS_ENTRY, enc.ptr.data_ptr(),
            enc.idx.data_ptr(), enc.hat.data_ptr(), enc.hat_sum.data_ptr(),
            st.cluster.data_ptr(), st.state.data_ptr(), st.lead.data_ptr(),
            st.cand_pos.data_ptr(), st.made.data_ptr(), enc.n, L, 0.3, 48,
            1.5, -1, torch.cuda.current_stream().cuda_stream)
    assert _kernels.launches[_kernels.CLUSTER_LEADERS_ENTRY] == n


def test_two_rank_mesh_bit_equal(cuda_device):
    """Two ranks on the one card (gloo over CUDA tensors), mesh (2, 1):
    every real slot of each rank's packed output equals the single-device
    runner's bit for bit; each rank one tile and one gather-dot launch and
    one all-reduce."""
    import torch_parallel_worker as worker
    from sddmm_tpu_torch.parallel import launch
    _kernels.load()      # built once here, not by both ranks at once
    csr = generate.block_clustered(48, 48, block_prob=0.08,
                                   block_density=0.6, noise_density=0.002,
                                   seed=3)
    packed = from_params(csr, 64, alpha=0.3, delta=0.3).packed
    a = generate.make_dense(csr.m, 64, seed=1)
    b = generate.make_dense(64, csr.n, seed=2)
    ranks = launch.spawn(2, worker.card_rows_mesh, (packed, a, b),
                         backend="gloo", timeout_s=300)
    single = hy.HybridSDDMM(packed, "float32", device=cuda_device)
    flat_1 = single.run_padded(*single.prepare_operands(a, b=b)).cpu().numpy()
    from sddmm_tpu_torch.parallel.dist import _ShardPlan
    plan = _ShardPlan(packed, 2)
    n_real = 0
    for r in ranks:
        dest = plan.csr_dest[r["row"]]
        real = dest < packed.nnz
        want = flat_1[packed.inv_idx[dest[real]]]
        assert np.array_equal(want.view(np.uint32),
                              r["flat"][real].view(np.uint32))
        n_real += int(real.sum())
        assert r["launches"]["sddmm_tile_dot_float32"] == 1
        assert [e["kind"] for e in r["log"]] == ["all_reduce"]
    assert n_real == packed.nnz


def _script(name):
    """The module of ``scripts/<name>.py``."""
    import importlib
    import sys
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def test_probe_winner_folds_and_validates_on_card(cuda_device, tmp_path,
                                                  monkeypatch, capsys):
    """``torch_probe_configs`` on the quick clustered16 at K=64 over the
    card file's entry and two other configs, timed by events and by
    ``queued_time_ms``, the tile kernel launched; ``torch_autofold
    --validate`` folds into a copy of the card's configs file the entry its
    rule picks (the winner if its margin beats the spreads, else the
    file's), at 0 errors against fp64, and the file names the card."""
    import shutil
    from sddmm_tpu_torch import bench
    quick = bench.suite(True)
    monkeypatch.setattr(bench, "suite", lambda q: quick)
    probe, fold, utc = (_script(n) for n in (
        "torch_probe_configs", "torch_autofold",
        "torch_update_tuned_configs"))
    logs = tmp_path / "logs"
    logs.mkdir()
    cfgs = tmp_path / "tuned_configs_h100.json"
    shutil.copy(bench.H100_CONFIGS, cfgs)
    entry = bench.load_tuned_config("clustered16", 64, cfgs)
    _kernels.launches.clear()
    rc = probe.main(["--matrix", "clustered16", "--k", "64", "--rounds", "2",
                     "--iterations", "5", "--configs",
                     fold.cfg_to_spec(entry)
                     + ";a=0.3,d=0.0,apanels=1;a=0.1,d=0.05,g=2"])
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    assert rc == 0 and _kernels.launches.get("sddmm_tile_dot_tf32")
    assert out.count("contract PASS") == 3 and out.count(" device ") == 6
    assert "device winner: [" in out
    log = logs / "probe_configs_clustered16_k64.log"
    log.write_text(out)
    want, _ = fold.choose(log, utc.winner_of(log), entry)
    assert want in (entry, utc.parse_tag(utc.winner_of(log)))
    assert fold.main([str(logs), "--validate", "--configs", str(cfgs)]) == 0
    assert "contract PASS errors=0/" in capsys.readouterr().out
    data = json.loads(cfgs.read_text())
    assert data["k64"]["clustered16"] == want
    assert torch.cuda.get_device_name(0) in data["_comment"]
    assert bench.validate_tuned_configs(cfgs) == []


def test_dense_arbitration_on_card(cuda_device, tmp_path, monkeypatch,
                                   capsys):
    """``torch_probe_dense_dlmc`` at dlmc density on 1024 x 1024, K=64:
    every candidate timed on the card; the fold's arbitration reads its
    dense class against its hybrid by JAX's rule, and a dense entry
    validates at 0 errors against fp64."""
    import re
    from sddmm_tpu_torch import bench
    small = {"dlmc": lambda: generate.random_sparse(1024, 1024, density=0.2,
                                                    seed=46)}
    monkeypatch.setattr(bench, "suite", lambda q: small)
    dense, fold = _script("torch_probe_dense_dlmc"), _script("torch_autofold")
    assert dense.main(["--m", "1024", "--n", "1024", "--k", "64",
                       "--iterations", "5"]) == 0
    out = capsys.readouterr().out
    for key in ("hybrid: ", "dense class: ", "einsum tile-major: ",
                "plain dot: ", "dot+extract: "):
        assert f"\n{key}" in out, key
    log = tmp_path / "probe_dense_dlmc_k64.log"
    log.write_text(out)
    d = float(re.search(r"dense class: ([\d.]+) ms", out).group(1))
    h = float(re.search(r"hybrid: nS=\d+ res=\d+ ([\d.]+) ms", out).group(1))
    assert fold.dense_decision(log) == (d < fold.DENSE_MARGIN * h)
    assert fold.Validator(cuda_device).check("dlmc", 64, {"dense": True})


def test_spans_on_card_time_the_stages_and_parent_the_backward(
        cuda_device):
    """A two-layer attention step under a capture of the device alone
    records nothing; under one of host and device the outermost spans of
    each thread (the layer's forward, the backward spans run on autograd's
    device thread) have a device time and the layer's start a queue wait,
    the stages nested in a layer's forward none; the backward spans have
    their forward stage as parent, and the hand-kernel launches are
    counted."""
    from sddmm_tpu_torch.utils import profiling
    mask = make_attention_mask(512, window=32, num_global=1)
    gen = torch.Generator().manual_seed(0)
    layers = []
    for _ in range(2):
        layer = BlockSparseAttention(mask, feature_dim=64, num_heads=2,
                                     head_dim=32, compute_dtype="float32",
                                     device=cuda_device)
        layer.init(gen)
        layers.append(layer)
    x = torch.randn((512, 64), generator=gen).to(cuda_device)

    def step():
        y = x
        for layer in layers:
            y = y + layer(y)
        (y ** 2).mean().backward()

    step()
    torch.cuda.synchronize()
    profiling.clear()
    # a capture of the device alone: no span, no launch counted
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]):
        step()
        torch.cuda.synchronize()
    assert profiling.summary() == {"spans": {}, "launch": {
        "count": 0, "host_ms": 0.0}, "spmm": {
        "launches": 0, "panel_entries": 0, "entries": 0,
        "panel_share": None}, "softmax": {
        "launches": 0, "entries": 0, "block_entries": 0,
        "split_entries": 0, "block_share": None}, "dropped": 0}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        step()
        torch.cuda.synchronize()
    recs = {r["id"]: r for r in profiling.records()}
    spans = profiling.summary()
    profiling.clear()
    outermost = ("attention.forward", "hybrid.sddmm.backward",
                 "softmax.backward", "spmm.backward")
    nested = ("attention.project", "hybrid.prepare", "hybrid.sddmm",
              "attention.softmax", "attention.spmm", "attention.out")
    for name in outermost + nested:
        s = spans["spans"][name]
        assert s["count"] == 2, (name, s)
        assert (s["device_ms"] is not None) == (name in outermost), (name, s)
    assert "plan.build" not in spans["spans"]
    assert spans["spans"]["attention.forward"]["queue_ms"] is not None
    forward_of = {"softmax.backward": "attention.softmax",
                  "spmm.backward": "attention.spmm",
                  "hybrid.sddmm.backward": "hybrid.sddmm"}
    for r in recs.values():
        if r["name"] in forward_of:
            up = recs[r["parent"]]
            assert up["name"] == forward_of[r["name"]], (r, up)
            assert recs[up["parent"]]["name"] == "attention.forward"
    # forward: tile, gather-dot, softmax, SpMM; backward: softmax, dP
    # gather-dot, dV SpMM, tile-grad and its reduction
    assert spans["launch"]["count"] >= 2 * 9
    assert spans["launch"]["host_ms"] > 0


def test_sddmm_stage_spans_sum_to_the_call(cuda_device):
    """The benchmark's powerlaw512k cell through ``perfbench/trace.py``:
    the device times of the runner's stage spans ``hybrid.prepare``,
    ``hybrid.sddmm`` and ``hybrid.to_csr`` (medians a call, from the
    sub-window traced with the host, the only one in which spans record)
    sum to within 3 % of the device-busy time of a call in the same run
    (from the device-only sub-window)."""
    import statistics
    import sys
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from perfbench import cells, trace
    from sddmm_tpu_torch.utils import profiling
    cell = cells.cell("sddmm.powerlaw512k.k128")
    system_mod = cells.system(cell.config["system"])
    pat = system_mod.pattern(cell.config, cell.traffic)
    system = system_mod.build(cell.config, cell.traffic, pat, cuda_device)
    loop = cells.loop(cell.traffic["loop"]).Loop(
        system, pat, cell.config, cell.traffic, cuda_device, 2 ** 31 + 3)
    profiling.clear()
    records = trace.Records(kind=loop.kind)
    trace.profile(loop.traced_call, int(cell.traffic["profile_calls"]),
                  records)
    stages = {}
    for r in profiling.records():
        stages.setdefault(r["name"], []).append(r["device_ms"])
    profiling.clear()
    assert {n: len(v) for n, v in stages.items()} == {
        n: records.calls
        for n in ("hybrid.prepare", "hybrid.sddmm", "hybrid.to_csr")}
    staged = sum(statistics.median(v) for v in stages.values())
    busy = records.busy_s() / records.calls * 1e3
    print(f"stages {staged:.4f} ms a call against busy {busy:.4f} ms: "
          + ", ".join(f"{n} {statistics.median(v):.4f}"
                      for n, v in stages.items()))
    assert abs(staged - busy) <= 0.03 * busy


# -- the attention projections' GEMM (ops/project.py, csrc/proj_gemm.cu) --

#: the GEMM's max |err| / max |exact| against fp64 over torch.matmul fp32's
#: (TF32 off) on the same operands: cuBLAS sums K by rounded FFMAs, the
#: kernel a rounded fp32 add a 32-deep stage; at K = 2304 on U[0,2) data it
#: reads 1.27x on an H100, elsewhere below 1
PROJ_VS_MATMUL = 1.5
#: mean signed error over the mean |exact|: the tensor cores' truncating
#: accumulation shrinks every product by 4.2-5.1e-8 uncorrected; the
#: kernel's correction leaves +-3.4e-9, and cuBLAS reads about 1e-10
PROJ_BIAS = 1.5e-8
#: the Longformer layer's (L, F, H, D): its projections run six products,
#: each (M, N, K) = Q, K, V (4096, 2304, 768); the output projection and dX
#: of it, the heads' cotangent (4096, 768, 768); dX of Q, K, V (4096, 768,
#: 2304); dW of Q, K, V (768, 2304, 4096); dW of the output (768, 768, 4096)
PROJ_LAYER = (4096, 768, 12, 64)
PROJ_PRODUCTS = ["qkv", "out", "dheads", "dx_qkv", "dw_qkv", "dw_out"]
_proj_readings = {}


def _proj_layer_products(kind, device):
    """The layer's projections forward and backward on the kernel path, on
    inputs, weights and cotangents of ``kind``: each product's
    (kernel, fp64, torch.matmul fp32), as C = A . B^T from the operands the
    layer hands the GEMM."""
    L, F, H, D = PROJ_LAYER
    g = torch.Generator(device=device).manual_seed(L + F)

    def draw(*shape):
        if kind == "normal":
            return torch.randn(shape, generator=g, device=device)
        return torch.rand(shape, generator=g, device=device) * 2

    x = draw(L, F).requires_grad_()
    ws = [draw(H, F, D).requires_grad_() for _ in range(3)]
    heads = draw(H, L, D).requires_grad_()
    w_o = draw(H * D, F).requires_grad_()
    outs = pj.qkv_project(x, *ws)
    gqkv = [draw(*o.shape) for o in outs]
    out = pj.out_project(heads, w_o)
    gout = draw(L, F)
    torch.autograd.backward([*outs, out], [*gqkv, gout])
    torch.cuda.synchronize()

    def cols(parts):   # (3, H, R, D) -> (R, 3*H*D), columns (which, h, d)
        return torch.stack(parts).permute(2, 0, 1, 3).reshape(
            parts[0].shape[1], -1)

    w_rows = cols([w.detach() for w in ws]).T   # (3*H*D, F)
    gy = cols([gqkv[0][:, :L], gqkv[1][:, :L], gqkv[2].view(H, L, D)])
    h_cat = heads.detach().permute(1, 0, 2).reshape(L, H * D)
    q, k, v = (o.detach() for o in outs)
    runs = {   # name: (kernel's C, A, B)
        "qkv": (cols([q[:, :L], k[:, :L], v.view(H, L, D)]), x.detach(),
                w_rows),
        "out": (out.detach(), h_cat, w_o.detach().T),
        "dheads": (heads.grad.permute(1, 0, 2).reshape(L, H * D), gout,
                   w_o.detach()),
        "dx_qkv": (x.grad, gy, w_rows.T),
        "dw_qkv": (cols([w.grad for w in ws]), x.detach().T, gy.T),
        "dw_out": (w_o.grad, h_cat.T, gout.T),
    }
    res = {}
    for name, (got, a, b) in runs.items():
        exact = a.double() @ b.double().T
        with td.full_fp32_matmul():
            lib = a @ b.T
        res[name] = (got, exact, lib)
    return res


def _proj_reading(kind, name, device):
    """max |err| / max |exact| of the kernel and of torch.matmul fp32, and
    the kernel's mean signed error over the mean |exact|, mean((C - exact)
    * sign(exact)) / mean |exact|, at product ``name`` (one run a kind)."""
    if kind not in _proj_readings:
        read = {}
        for n, (got, exact, lib) in _proj_layer_products(kind,
                                                         device).items():
            err = {who: ((t.double() - exact).abs().max()
                         / exact.abs().max()).item()
                   for who, t in (("kernel", got), ("matmul", lib))}
            bias = (((got.double() - exact) * exact.sign()).mean()
                    / exact.abs().mean()).item()
            read[n] = (err, bias)
        _proj_readings[kind] = read
    return _proj_readings[kind][name]


@pytest.mark.parametrize("kind", ["normal", "u02"])
@pytest.mark.parametrize("product", PROJ_PRODUCTS)
def test_projection_gemm_error_within_matmul_fp32(product, kind,
                                                  cuda_device):
    """At each of the Longformer layer's six products, as its projections'
    forward and backward run them, the kernel's error against fp64 is
    within PROJ_VS_MATMUL of torch.matmul fp32's (TF32 off) on the same
    operands, and its mean signed error, the bias a norm or a loss reads,
    within PROJ_BIAS."""
    err, bias = _proj_reading(kind, product, cuda_device)
    print(f"{kind} {product}: {err}, bias {bias:+.2e}")
    assert err["kernel"] <= PROJ_VS_MATMUL * err["matmul"], err
    assert abs(bias) <= PROJ_BIAS, bias


@pytest.mark.parametrize("L,F,H", [(256, 768, 12), (128, 256, 4)],
                         ids=["256x12x64", "128x4x64"])
def test_projection_short_sequences(L, F, H, cuda_device):
    """Short sequences of wide layers, whose Q, K, V product has so few
    tiles that the split-K cost model would split it: the layer runs
    forward and backward, q_pad's and k_pad's sentinel rows are zero, and
    its output and gradients match the plain path's."""
    mask = make_attention_mask(L, window=32, num_global=1)
    layer = BlockSparseAttention(mask, F, H, 64, device=cuda_device)
    layer.init(torch.Generator().manual_seed(4))
    x = torch.as_tensor(generate.make_dense(L, F, seed=6),
                        device=cuda_device).requires_grad_()
    q_pad, k_pad, _ = pj.qkv_project(x, layer.w_q, layer.w_k, layer.w_v)
    torch.cuda.synchronize()
    assert not q_pad[:, L].any() and not k_pad[:, L].any()
    got = {}
    for plain in (False, True):
        layer.zero_grad()
        x.grad = None
        out = layer(x, plain=plain)
        out.square().sum().backward()
        torch.cuda.synchronize()
        got[plain] = [out.detach(), x.grad.clone(),
                      *(w.grad.clone() for w in layer.parameters())]
    for k, p in zip(got[False], got[True]):
        assert ((k - p).abs().max() / p.abs().max()).item() <= MODEL_PLAIN


@pytest.mark.parametrize("need_x", [True, False], ids=["dx", "first_layer"])
def test_projection_launches_per_layer(need_x, cuda_device):
    """One block-sparse layer's forward and backward: Q, K, V and the output
    projection are one split and one GEMM launch each; their backward one
    split launch each and a GEMM for each gradient, with Q, K, V's dX
    skipped where x needs no gradient (a first layer)."""
    mask = make_attention_mask(512, window=32, num_global=1)
    layer = BlockSparseAttention(mask, 96, 3, 32, device=cuda_device)
    layer.init(torch.Generator().manual_seed(2))
    x = torch.as_tensor(generate.make_dense(512, 96, seed=4),
                        device=cuda_device).requires_grad_(need_x)
    proj = (_kernels.PROJ_SPLIT_ENTRY, _kernels.PROJ_GEMM_ENTRY)
    before = dict(_kernels.launches)
    out = layer(x)
    torch.cuda.synchronize()
    fwd = {n: c for n, c in _launched(before).items() if n in proj}
    before = dict(_kernels.launches)
    out.square().sum().backward()
    torch.cuda.synchronize()
    bwd = {n: c for n, c in _launched(before).items() if n in proj}
    assert fwd == {proj[0]: 2, proj[1]: 2}
    assert bwd == {proj[0]: 2, proj[1]: 4 if need_x else 3}
    assert (x.grad is not None) == need_x


def test_projection_layer_runs_no_library_gemm(cuda_device):
    """A device trace of one Longformer-wide layer's forward and backward
    holds the projection GEMM and no cuBLAS or CUTLASS GEMM kernel."""
    mask = make_attention_mask(1024, window=64, num_global=1)
    layer = BlockSparseAttention(mask, 768, 12, 64, device=cuda_device)
    layer.init(torch.Generator().manual_seed(3))
    x = torch.as_tensor(generate.make_dense(1024, 768, seed=5),
                        device=cuda_device).requires_grad_()
    layer(x).square().sum().backward()   # warm: plans, the first backward
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        layer(x).square().sum().backward()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if getattr(e, "device_time_total", 0) > 0}
    assert any("proj_gemm_kernel" in n for n in names), names
    library = [n for n in names if "proj_gemm" not in n and any(
        w in n.lower() for w in ("gemm", "cutlass", "cublas", "xmma"))]
    assert not library, library
