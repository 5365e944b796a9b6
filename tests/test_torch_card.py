"""Tests of the port's CUDA kernels on the card.  They skip where there is no
CUDA card; on a machine with one (where jax need not be installed) run them
with

    python -m pytest tests/test_torch_card.py --noconftest -q

This file imports nothing of JAX."""

import numpy as np
import pytest
import torch

from sddmm_tpu_torch.data import generate
from sddmm_tpu_torch.ops import hybrid as hy
from sddmm_tpu_torch.ops import tile_dot as td
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.reorder.autotune import from_params
from sddmm_tpu_torch.utils.check import check_values

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _u02(rng, shape, device):
    return torch.tensor(rng.uniform(0, 2, shape), dtype=torch.float32,
                        device=device)


@pytest.mark.parametrize("R", [16, 32, 64, 128])
def test_tile_dot_kernel_matches_plain(R, cuda_device):
    rng = np.random.default_rng(R)
    a, b = _u02(rng, (37, R, 128), cuda_device), _u02(rng, (37, 384, 128),
                                                      cuda_device)
    n = td.tile_dot_bf16x3.launches
    got = td.tile_dot_bf16x3(a, b)
    want = td.tile_dot_bf16x3_plain(a, b)
    torch.cuda.synchronize()
    assert td.tile_dot_bf16x3.launches == n + 1
    # tensor-core fp32 accumulation runs in another order than bmm's
    assert ((got - want).abs() / want.abs()).max().item() <= 1e-4


def test_tile_dot_kernel_ragged_window(cuda_device):
    """R=80 and L=144 leave partial 64-wide windows in both directions."""
    rng = np.random.default_rng(5)
    a, b = _u02(rng, (3, 80, 48), cuda_device), _u02(rng, (3, 144, 48),
                                                     cuda_device)
    got = td.tile_dot_bf16x3(a, b)
    want = td.tile_dot_bf16x3_plain(a, b)
    torch.cuda.synchronize()
    assert ((got - want).abs() / want.abs()).max().item() <= 1e-4


def test_gather_dot_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(1)
    a, bt = _u02(rng, (1025, 128), cuda_device), _u02(rng, (2049, 128),
                                                      cuda_device)
    rows = torch.tensor(rng.integers(0, 1025, 5000), dtype=torch.int32,
                        device=cuda_device)
    gids = torch.tensor(rng.integers(0, 2049, 5000), dtype=torch.int32,
                        device=cuda_device)
    got = hy.residual_gather_dot(a, bt, rows, gids)
    want = hy.residual_gather_dot_plain(a, bt, rows, gids)
    torch.cuda.synchronize()
    assert ((got - want).abs() / want.abs()).max().item() <= 1e-6


def test_slice_on_card(cuda_device):
    csr = generate.block_clustered(64, 64, block_prob=0.08,
                                   block_density=0.7, noise_density=0.0005,
                                   seed=42)
    t = from_params(csr, 128, alpha=0.2, delta=0.05, b_cost_scale=2.0)
    a = generate.make_dense(csr.m, 128, seed=1)
    b = generate.make_dense(128, csr.n, seed=2)
    r = hy.HybridSDDMM(t.packed, a_layout="panels", device=cuda_device)
    ops = r.prepare_operands(a, b=b)
    n1, n2 = td.tile_dot_bf16x3.launches, hy.residual_gather_dot.launches
    got = r.run_padded(*ops, order="csr")
    plain = r.run_padded(*ops, order="csr", plain=True)
    torch.cuda.synchronize()
    assert td.tile_dot_bf16x3.launches > n1
    assert hy.residual_gather_dot.launches > n2
    res = check_values(sddmm_reference(a, b, csr), got.cpu().numpy())
    assert res.passed and res.num_errors == 0, str(res)
    assert ((got - plain).abs() / plain.abs()).max().item() <= 1e-4
