"""The port's tile dot (``sddmm_tpu_torch.ops.tile_dot``) against the Pallas
kernel it replaces, run in interpret mode as the JAX package's own tests
run it on the CPU, and each compute mode against the JAX package's dot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddmm_tpu.ops import hybrid as jhy
from sddmm_tpu.ops import pallas_tiles
from sddmm_tpu_torch import _kernels
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
    got = td.tile_dot(torch.from_numpy(a), torch.from_numpy(b), "tf32")
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
    hi_t, lo_t = td.split_bf16(torch.from_numpy(x), 2)

    def bits(v):
        return v.view(torch.int16).numpy().view(np.uint16)

    assert np.array_equal(bits(hi_t), np.asarray(hi_j).view(np.uint16))
    assert np.array_equal(bits(lo_t), np.asarray(lo_j).view(np.uint16))


def test_tile_dot_writes_into_out_view():
    a, b = _tiles(3, 32, 256, 64, seed=1)
    buf = torch.full((3 * 32 * 256 + 7,), -1.0)
    view = buf[:3 * 32 * 256].view(3, 32, 256)
    ret = td.tile_dot(torch.from_numpy(a), torch.from_numpy(b), out=view)
    assert ret is view
    assert torch.equal(view, td.tile_dot_plain(torch.from_numpy(a),
                                               torch.from_numpy(b)))
    assert (buf[3 * 32 * 256:] == -1.0).all()


def test_tile_dot_accumulates_chunks_into_strided_view():
    """Two K chunks as column views, added into a strided output at an odd
    offset, give the one-shot product; cells outside the view stay."""
    a, b = _tiles(2, 37, 150, 96, seed=4)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    buf = torch.full((1 + 2 * 37 * 151,), -1.0)
    out = buf[1:].view(2, 37, 151)[:, :, :150]
    td.tile_dot(at[:, :, :48], bt[:, :, :48], "float32", out=out)
    td.tile_dot(at[:, :, 48:], bt[:, :, 48:], "float32", out=out,
                accumulate=True)
    want = np.einsum("tik,tjk->tij", a.astype(np.float64),
                     b.astype(np.float64))
    assert np.abs(out.numpy() - want).max() / want.min() <= 1e-6
    assert buf[0] == -1.0 and (buf[1:].view(2, 37, 151)[:, :, 150]
                               == -1.0).all()


def _jax_mode_dot(a, b, mode):
    """The JAX package's dot of each mode (``_hybrid_packed_jit``'s
    ``dot`` without Pallas), on its storage dtypes."""
    adt, bdt = jhy._storage_dtypes(mode)
    aj, bj = jnp.asarray(a).astype(adt), jnp.asarray(b).astype(bdt)
    dn = (((2,), (2,)), ((0,), (0,)))
    if mode in ("tf32", "float16"):
        return jhy._dot3(aj, bj, dn)
    if mode == "mixed":
        ah, al = jhy._split_bf16(aj)
        return sum(jax.lax.dot_general(x, bj, dn,
                                       preferred_element_type=jnp.float32)
                   for x in (ah, al))
    return jax.lax.dot_general(aj, bj, dn, preferred_element_type=jnp.float32,
                               precision=jhy._PRECISION[mode])


@pytest.mark.parametrize("mode", list(td.MODES))
def test_modes_match_jax_dots(mode):
    """Each mode's plain version (the CPU path) on ragged R and L against
    the JAX package's dot; "float32" (bf16x6 here, exact fp32 on JAX's CPU
    backend) agrees within about one fp32 rounding."""
    a, b = _tiles(3, 37, 150, 64, seed=9)
    adt, bdt = td.STORAGE[mode]
    got = td.tile_dot(torch.from_numpy(a).to(adt), torch.from_numpy(b).to(bdt),
                      mode)
    want = np.asarray(_jax_mode_dot(a, b, mode))
    rel = np.abs(got.numpy() - want) / np.abs(want)
    assert rel.max() <= PARITY_REL, rel.max()


@pytest.mark.parametrize("planes", [1, 2, 3])
def test_split_planes_sum_to_x(planes):
    """hi, hi/lo and hi/mid/lo carry 8, 16 and 24 significant bits: each
    round to nearest bf16 (8 significant bits) errs by at most 2^-8 of what
    it rounds."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-2, 2, 4096).astype(np.float32))
    parts = td.split_bf16(x, planes)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    back = sum(p.double() for p in parts)
    rel = ((back - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** (-8 * planes)


@pytest.mark.parametrize("K", [32, 256])
def test_split_probe_separates_float32_from_tf32(K):
    """split_probe's planes are exactly s, s*2^-9 and s*2^-18, so "tf32"
    misses 3*2^-18 (1.1e-5) of every product and "float32" stays within
    1e-6 (max abs err / min |exact|) of the fp64 product."""
    rng = np.random.default_rng(K)
    a, b = td.split_probe(rng, (3, 37, K)), td.split_probe(rng, (3, 150, K))
    s = a.double() / (1.0 + 2.0 ** -9 + 2.0 ** -18)
    for plane, scale in zip(td.split_bf16(a, 3), (1.0, 2.0 ** -9,
                                                  2.0 ** -18)):
        assert torch.equal(plane.double(), s * scale)
    exact = torch.bmm(a.double(), b.double().transpose(1, 2))
    err = {mode: ((td.tile_dot(a, b, mode).double() - exact).abs().max()
                  / exact.abs().min()).item() for mode in ("float32", "tf32")}
    assert err["float32"] <= 1e-6, err
    assert err["tf32"] >= 1e-5, err


def test_tile_dot_cpu_path_counts_no_launch():
    before = dict(_kernels.launches)
    a, b = _tiles(2, 16, 128, 32, seed=2)
    for mode in td.MODES:
        adt, bdt = td.STORAGE[mode]
        td.tile_dot(torch.from_numpy(a).to(adt), torch.from_numpy(b).to(bdt),
                    mode)
    assert dict(_kernels.launches) == before


@pytest.mark.parametrize("case", ["R", "L", "K", "dtype", "contig", "device",
                                  "batch", "out_shape", "mode", "align",
                                  "accumulate"])
def test_tile_dot_rejects(case):
    a = torch.ones(2, 16, 32)
    b = torch.ones(2, 128, 32)
    out = None
    mode = "tf32"
    accumulate = False
    err = ValueError
    if case == "R":
        a = torch.ones(2, 0, 32)
    elif case == "L":
        b = torch.ones(2, 0, 32)
    elif case == "K":
        # any K >= 1 is taken (padded to the kernel's step); K = 0 is not
        a, b = torch.ones(2, 16, 0), torch.ones(2, 128, 0)
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
    elif case == "mode":
        mode = "tf16"
    elif case == "align":
        # fp16 rows 36 elements apart: 72 bytes, not a 16-byte multiple
        mode = "float16"
        a = torch.ones(2, 16, 36, dtype=torch.float16)[:, :, :32]
        b = torch.ones(2, 128, 32, dtype=torch.float16)
    elif case == "accumulate":
        accumulate = True
    with pytest.raises(err):
        td.tile_dot(a, b, mode, out=out, accumulate=accumulate)


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
