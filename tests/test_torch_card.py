"""Tests of the port's CUDA kernels on the card.  They skip where there is no
CUDA card; on a machine with one (where jax need not be installed) run them
with

    python -m pytest tests/test_torch_card.py --noconftest -q

This file imports nothing of JAX."""

import numpy as np
import pytest
import torch

from sddmm_tpu_torch import _kernels
from sddmm_tpu_torch.data import generate
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops import tile_dot as td
from sddmm_tpu_torch.ops.csr_sddmm import csr_sddmm
from sddmm_tpu_torch.ops.dense import DenseSDDMM
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.reorder.autotune import from_params
from sddmm_tpu_torch.utils.check import check_values

pytestmark = pytest.mark.cuda

# kernel vs plain version: the same bf16 products (exact in fp32), summed by
# the tensor cores in another order than bmm's
TILE_REL = 1e-4
# gather-dot vs plain: both exact fp32 products, another sum order
GATHER_REL = 1e-6
# "float32" vs the fp64 product, max abs err / min |exact| on positive data:
# about one fp32 rounding ("tf32" errs by up to 3 * 2^-18 per product)
F32_EXACT = 1e-6


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
