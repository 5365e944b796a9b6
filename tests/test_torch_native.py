"""The port's native library and its numpy fallback greedy: the fallback
(``rows._greedy_cluster`` in its native arithmetic) returns the C++
greedy's cluster ids and count exactly, so the port's packing is one
result with or without ``g++``; the routing sample keeps the JAX
package's arithmetic; and the library is built from the port's own source
under a name that tracks its bytes.  Tolerances: ids, counts, packings and
scores exactly."""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sddmm_tpu import native as jnative
from sddmm_tpu.reorder import rows as jrows
from sddmm_tpu_torch import native
from sddmm_tpu_torch.data import generate as tgen
from sddmm_tpu_torch.reorder import autotune as ta
from sddmm_tpu_torch.reorder import rows
from torch_native_ready import reference_native_loaded  # noqa: F401

from test_torch_pack_parity import CONFIGS, assert_same_packing  # noqa

ROOT = Path(__file__).resolve().parents[1]

#: matrices whose rows fall near alpha for the greedy's similarity: with
#: fp64 hats and pairwise sums 6 of the 20 (matrix, alpha) cases below
#: give other clusters than the C++ greedy
MATRICES = {
    "powerlaw2500": ("powerlaw_graph", (2500,),
                     {"avg_degree": 16, "seed": 44}),
    "powerlaw2048": ("powerlaw_graph", (2048,),
                     {"avg_degree": 16, "seed": 44}),
    "random3000": ("random_sparse", (3000, 3000, 0.01), {"seed": 5}),
    "clustered64": ("block_clustered", (64, 64),
                    {"block_prob": 0.08, "block_density": 0.7,
                     "noise_density": 0.0005, "seed": 42}),
    "clustered24": ("block_clustered", (24, 24),
                    {"block_prob": 0.1, "seed": 33}),
}
ALPHAS = (0.1, 0.2, 0.3, 0.5)
CASES = [(name, alpha) for name in MATRICES for alpha in ALPHAS]


@functools.lru_cache(maxsize=None)
def _csr(name):
    fn, args, kw = MATRICES[name]
    return getattr(tgen, fn)(*args, **kw)


def _encode(csr, col_block_size=16):
    """(order, block_ptr, block_idx, block_cnt, num_blocks) as
    ``row_reordering`` builds them."""
    bp, bi, bc, nb = rows.row_encodings(csr, col_block_size)
    disp = rows.dispersion_scores(csr, bp, bc, col_block_size)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]
    return order, bp, bi, bc, nb


@functools.lru_cache(maxsize=None)
def _encoded(name):
    return _encode(_csr(name))


def _native(m, args, alpha, lib=native):
    order, bp, bi, bc, nb = args
    got = lib.greedy_cluster(bp, bi, bc, order, m, nb, alpha)
    assert got is not None, f"{lib.__name__}: the library did not load"
    return got


def _assert_same(got, want):
    assert got[1] == want[1]
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("name,alpha", CASES)
def test_fallback_equals_native(name, alpha):
    """The fallback's ids and count are the port's C++ greedy's, and those
    are the JAX package's C++ greedy's."""
    args = _encoded(name)
    m = _csr(name).m
    want = _native(m, args, alpha)
    _assert_same(rows._greedy_cluster(*args, alpha, arith="native"), want)
    _assert_same(_native(m, args, alpha, lib=jnative), want)


#: alphas that similarities meet exactly in real arithmetic, where the
#: roundings decide (a drawn float rarely falls within them)
ROUND_ALPHAS = (0.1, 0.2, 0.25, 0.3, 0.4, 0.5, 0.6, 0.75)


@settings(max_examples=100, deadline=None, database=None, derandomize=True)
@given(m=st.integers(1, 300), n=st.integers(16, 256),
       density=st.floats(0.01, 0.5), seed=st.integers(0, 2 ** 31 - 1),
       alpha=st.one_of(st.sampled_from(ROUND_ALPHAS),
                       st.floats(0.05, 0.95)))
def test_fallback_equals_native_drawn(m, n, density, seed, alpha):
    csr = tgen.random_sparse(m, n, density, seed=seed)
    args = _encode(csr)
    _assert_same(rows._greedy_cluster(*args, alpha, arith="native"),
                 _native(m, args, alpha))


@pytest.mark.parametrize("name,alpha", CASES)
def test_sample_arithmetic_is_jax(name, alpha):
    """The routing sample's arithmetic is the JAX package's numpy greedy,
    so both packages route a matrix alike."""
    args = _encoded(name)
    _assert_same(rows._greedy_cluster(*args, alpha, arith="jax"),
                 jrows._greedy_cluster(*args, alpha))


def test_unknown_arithmetic_raises():
    with pytest.raises(ValueError, match="arith"):
        rows._greedy_cluster(*_encoded("clustered24"), 0.3, arith="fp16")


def _without_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()


@pytest.mark.parametrize("name,alpha", CASES)
def test_row_reordering_one_result_whatever_the_build(name, alpha,
                                                      monkeypatch):
    csr = _csr(name)
    assert native.available()
    with_lib = rows.row_reordering(csr, alpha, method="greedy")
    _without_library(monkeypatch)
    without = rows.row_reordering(csr, alpha, method="greedy")
    for f in dataclasses.fields(with_lib):
        x, y = getattr(with_lib, f.name), getattr(without, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("cfg_name", ["clustered16", "clustered128",
                                      "banded"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_from_params_one_result_whatever_the_build(name, cfg_name,
                                                   monkeypatch):
    csr = _csr(name)
    cfg = CONFIGS[cfg_name]
    kw = dict(alpha=cfg["alpha"], delta=cfg["delta"],
              group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
              merge_superpanels=cfg.get("merge", True),
              sort_runs=cfg.get("sort_runs", "cid"),
              b_cost_scale=cfg.get("b_cost_scale", 1.0))
    assert np.count_nonzero(csr.row_nnz()) < 8192
    with_lib = ta.from_params(csr, 128, **kw)
    _without_library(monkeypatch)
    without = ta.from_params(csr, 128, **kw)
    assert_same_packing(with_lib.packed, without.packed)
    assert with_lib.est_ms == without.est_ms


def test_library_built_from_the_ports_source(tmp_path):
    assert native._SRC.is_relative_to(ROOT / "sddmm_tpu_torch")
    assert native._SRC.exists()
    path = native.lib_path()
    assert path.parent == ROOT / "sddmm_tpu_torch" / "_build"
    assert native.available()
    assert Path(native._lib._name) == path
    # the name follows the source's bytes, not its place
    copy = tmp_path / "native.cpp"
    copy.write_bytes(native._SRC.read_bytes())
    assert native.lib_path(copy) == path
    copy.write_bytes(native._SRC.read_bytes() + b"\n")
    assert native.lib_path(copy) != path

