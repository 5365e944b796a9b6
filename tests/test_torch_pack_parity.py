"""The port's host layers (its copies of data/, native/, reorder/) against the
JAX package's: the same generators give the same arrays, and
``from_params`` on a committed config gives the identical ``PackedMatrix``."""

import copy
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.data import io as jio
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu_torch.data import generate as tgen
from sddmm_tpu_torch.data import io as tio
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.reorder.autotune import from_params as t_from_params
from sddmm_tpu_torch.reorder.pack import PackedMatrix
from sddmm_tpu_torch.reorder.validate import check_pack
from torch_native_ready import reference_native_loaded  # noqa: F401

CONFIGS = json.loads((Path(__file__).resolve().parents[1] / "results"
                      / "tuned_configs.json").read_text())["k128"]

#: the layout model's measured constants (``autotune.load_calibration``
#: replaces them)
_LAYOUT_MODEL = ("STREAM_GBPS", "TAKE_PAYLOAD_CAP_GBPS", "_ROW_RATE_8MB",
                 "_SRC_MB", "_SRC_F", "_REPEAT_COST", "_DOT_G16_MS")


def _shipped_jax_autotune():
    """A fresh load of the JAX package's ``autotune.py`` under a private
    name: its constants as shipped, whatever a test did to the imported
    module."""
    path = (Path(__file__).resolve().parents[1] / "sddmm_tpu" / "reorder"
            / "autotune.py")
    spec = importlib.util.spec_from_file_location("_shipped_autotune", path)
    module = importlib.util.module_from_spec(spec)
    # its dataclasses look their module up in sys.modules while it loads
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules[spec.name]
    return module


_SHIPPED = _shipped_jax_autotune()


def _put(module, name, value):
    """Set a module constant to a copy of ``value`` (a dict in place)."""
    if isinstance(value, dict):
        getattr(module, name).clear()
        getattr(module, name).update(value)
    else:
        setattr(module, name, copy.copy(value))


@pytest.fixture(autouse=True)
def _shipped_layout_model():
    """The JAX package's ``from_params`` on its shipped layout model.  A
    test that loads a calibration into it earlier in the same process
    (``tests/test_reorder.py``'s restores three of the constants, not
    ``_SRC_F``, ``_SRC_MB`` or the rate keys it adds) would otherwise leave
    another ``est_ms`` there; the module's values are put back as they were
    after each test."""
    from sddmm_tpu.reorder import autotune as ja
    saved = {name: copy.copy(getattr(ja, name)) for name in _LAYOUT_MODEL}
    for name in _LAYOUT_MODEL:
        _put(ja, name, getattr(_SHIPPED, name))
    yield
    for name, value in saved.items():
        _put(ja, name, value)


@pytest.mark.parametrize("name", _LAYOUT_MODEL)
def test_layout_model_constants_identical(name):
    """The port's layout model is the JAX package's as shipped."""
    from sddmm_tpu_torch.reorder import autotune as ta
    x, y = getattr(_SHIPPED, name), getattr(ta, name)
    if isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    else:
        assert type(x) is type(y) and x == y


GENERATORS = {
    "random_sparse": ("random_sparse", (300, 200, 0.03), {"seed": 5}),
    "powerlaw_graph": ("powerlaw_graph", (500, 8), {"seed": 6}),
    "banded": ("banded", (200, 180, 7), {"seed": 7, "fill": 0.6}),
    "block_clustered": ("block_clustered", (12, 10),
                        {"block_prob": 0.2, "seed": 8}),
    "hypersparse_dense_mix": ("hypersparse_dense_mix", (400, 300),
                              {"density": 1e-3, "seed": 9}),
}

# bench.py --quick matrices (bench.py:46-53): under 8192 non-empty rows,
# so row clustering's auto routing takes the same branch in both packages
QUICK = {
    "clustered16_quick": ("block_clustered", (64, 64),
                          {"block_prob": 0.08, "block_density": 0.7,
                           "noise_density": 0.0005, "seed": 42}),
    "powerlaw_quick": ("powerlaw_graph", (2048,),
                       {"avg_degree": 16, "seed": 44}),
}


def _pair_csr(name, conftest_csrs):
    """(JAX-package CSR, port CSR) for a named test matrix."""
    if name in conftest_csrs:
        c = conftest_csrs[name]
        return c, TCSR(c.shape, c.row_ptr.copy(), c.col_idx.copy(),
                       c.values.copy())
    fn, args, kw = QUICK[name]
    return getattr(jgen, fn)(*args, **kw), getattr(tgen, fn)(*args, **kw)


def _assert_same_csr(a, b):
    assert a.shape == b.shape
    for f in ("row_ptr", "col_idx", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_identical(name):
    fn, args, kw = GENERATORS[name]
    _assert_same_csr(getattr(jgen, fn)(*args, **kw),
                     getattr(tgen, fn)(*args, **kw))


@pytest.mark.parametrize("shape,seed", [((33, 128), 1), ((128, 47), 2)])
def test_make_dense_identical(shape, seed):
    a = jgen.make_dense(*shape, seed=seed)
    b = tgen.make_dense(*shape, seed=seed)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_mtx_roundtrip_across_packages(tmp_path, use_native):
    csr = tgen.block_clustered(6, 5, block_prob=0.3, seed=11)
    path = tmp_path / "m.mtx"
    tio.save_mtx(path, csr)
    _assert_same_csr(jio.load_mtx(path, use_native=use_native),
                     tio.load_mtx(path, use_native=use_native))
    _assert_same_csr(csr, tio.load_mtx(path, use_native=use_native))


def assert_same_packing(pj, pt):
    """Every field of the two packages' PackedMatrix is equal."""
    assert isinstance(pt, PackedMatrix)
    for f in dataclasses.fields(pt):
        x, y = getattr(pj, f.name), getattr(pt, f.name)
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), f.name
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert pj.packed_size == pt.packed_size


@pytest.fixture
def conftest_csrs(small_random_csr, clustered_csr):
    return {"small_random": small_random_csr, "clustered": clustered_csr}


@pytest.mark.parametrize("cfg_name", ["clustered16", "banded"])
@pytest.mark.parametrize("name", ["small_random", "clustered",
                                  "clustered16_quick", "powerlaw_quick"])
def test_from_params_identical_packing(name, cfg_name, conftest_csrs):
    csr_j, csr_t = _pair_csr(name, conftest_csrs)
    _assert_same_csr(csr_j, csr_t)
    assert np.count_nonzero(csr_t.row_nnz()) < 8192
    cfg = CONFIGS[cfg_name]
    kw = dict(alpha=cfg["alpha"], delta=cfg["delta"],
              group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
              merge_superpanels=cfg.get("merge", True),
              b_cost_scale=cfg.get("b_cost_scale", 1.0))
    tj = j_from_params(csr_j, 128, **kw)
    tt = t_from_params(csr_t, 128, **kw)
    assert_same_packing(tj.packed, tt.packed)
    assert tj.est_ms == tt.est_ms
    check_pack(csr_t, tt.bsmr, tt.packed)
