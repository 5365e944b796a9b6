"""The port's tile dot (``sddmm_tpu_torch.ops.tile_dot``) against the Pallas
kernel it replaces, run in interpret mode as the JAX package's own tests
run it on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.ops import pallas_tiles
from sddmm_tpu_torch.ops import tile_dot as td

# Contract of the reference (abs 1e-5 or rel 1e-3, utils/check.py).
ABS_TOL, REL_TOL = 1e-5, 1e-3
# Port vs Pallas interpret: the same bf16 hi/lo split and three fp32
# products, summed in another order (measured <= 1e-6).
PARITY_REL = 1e-5


def _tiles(nT, R, L, K, seed):
    rng = np.random.default_rng(seed)
    # U[0,2): the reference's data distribution (no cancellation)
    a = rng.uniform(0, 2, (nT, R, K)).astype(np.float32)
    b = rng.uniform(0, 2, (nT, L, K)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("R", [16, 64, 128])
@pytest.mark.parametrize("K", [32, 128, 256])
def test_tile_dot_matches_pallas_interpret(R, K):
    nT = 3 if R == 128 else 5     # odd: the Pallas side pads, the port not
    a, b = _tiles(nT, R, 128, K, seed=R * 1000 + K)
    want = np.asarray(pallas_tiles.tile_dot_padded(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = td.tile_dot_bf16x3(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (nT, R, 128) and got.dtype == torch.float32
    got = got.numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= PARITY_REL, rel.max()

    exact = np.einsum("tik,tjk->tij", a.astype(np.float64),
                      b.astype(np.float64))
    err = np.abs(got - exact)
    assert ((err < ABS_TOL) | (err / np.abs(exact) < REL_TOL)).all()


@pytest.mark.parametrize("shape", [(4, 16, 32), (2, 64, 128), (1, 128, 256)])
def test_split_bit_equal_to_pallas(shape):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)
         ).astype(np.float32)
    hi_j, lo_j = pallas_tiles._split_hi_lo(jnp.asarray(x))
    hi_t, lo_t = td.split_hi_lo(torch.from_numpy(x))

    def bits(v):
        return v.view(torch.int16).numpy().view(np.uint16)

    assert np.array_equal(bits(hi_t), np.asarray(hi_j).view(np.uint16))
    assert np.array_equal(bits(lo_t), np.asarray(lo_j).view(np.uint16))


def test_tile_dot_writes_into_out_view():
    a, b = _tiles(3, 32, 256, 64, seed=1)
    buf = torch.full((3 * 32 * 256 + 7,), -1.0)
    view = buf[:3 * 32 * 256].view(3, 32, 256)
    ret = td.tile_dot_bf16x3(torch.from_numpy(a), torch.from_numpy(b),
                             out=view)
    assert ret is view
    assert torch.equal(view, td.tile_dot_bf16x3_plain(torch.from_numpy(a),
                                                      torch.from_numpy(b)))
    assert (buf[3 * 32 * 256:] == -1.0).all()


def test_tile_dot_cpu_path_counts_no_launch():
    before = td.tile_dot_bf16x3.launches
    a, b = _tiles(2, 16, 128, 32, seed=2)
    td.tile_dot_bf16x3(torch.from_numpy(a), torch.from_numpy(b))
    assert td.tile_dot_bf16x3.launches == before


@pytest.mark.parametrize("case", ["R", "L", "K", "dtype", "contig", "device",
                                  "batch", "out_shape"])
def test_tile_dot_rejects(case):
    a = torch.ones(2, 16, 32)
    b = torch.ones(2, 128, 32)
    out = None
    err = ValueError
    if case == "R":
        a = torch.ones(2, 24, 32)
    elif case == "L":
        b = torch.ones(2, 120, 32)
    elif case == "K":
        a, b = torch.ones(2, 16, 40), torch.ones(2, 128, 40)
    elif case == "dtype":
        a, err = a.double(), TypeError
    elif case == "contig":
        a = torch.ones(2, 32, 16).transpose(1, 2)
    elif case == "device":
        b = torch.ones(2, 128, 32, device="meta")
    elif case == "batch":
        b = torch.ones(3, 128, 32)
    elif case == "out_shape":
        out = torch.empty(2, 16, 64)
    with pytest.raises(err):
        td.tile_dot_bf16x3(a, b, out=out)


def test_plain_restores_tf32_flags():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with td.full_fp32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
