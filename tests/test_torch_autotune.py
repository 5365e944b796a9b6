"""The port's configuration search against the JAX package's, on matrices
made by both generators from the same seeds: the candidate layouts, hub
widths and dense-class score, the estimate-only winner (``est_ms`` within
rel 1e-9: the same float arithmetic, summed in the same order), the
multi-K search and the shoot-out's finalists; and the measured mode on
the CPU."""

import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.reorder import autotune as ja
from sddmm_tpu_torch.data import generate as tgen
from sddmm_tpu_torch.reorder import autotune as ta
from torch_native_ready import reference_native_loaded  # noqa: F401

# the JAX package's layout model as shipped around each test (a calibration
# test earlier in the same worker would leave another)
from test_torch_pack_parity import _shipped_layout_model  # noqa: F401

EST_REL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MATRICES = {
    "block_clustered": ("block_clustered", (24, 24),
                        {"block_prob": 0.1, "seed": 33}),
    "block_clustered_sparse": ("block_clustered", (48, 48),
                               {"block_prob": 0.03, "seed": 33}),
    # 2500 rows: hub candidates and the hot-row slab candidate's test
    "powerlaw": ("powerlaw_graph", (2500,), {"avg_degree": 16, "seed": 44}),
    # tests/test_cli_harness.py's dense-class densities
    "dlmc_96x128": ("random_sparse", (96, 128, 0.35), {"seed": 5}),
    "sparse_512": ("random_sparse", (512, 512, 0.002), {"seed": 5}),
    "dlmc_64": ("random_sparse", (64, 64, 0.35), {"seed": 7}),
}


def _pair(name):
    fn, args, kw = MATRICES[name]
    return getattr(tgen, fn)(*args, **kw), getattr(jgen, fn)(*args, **kw)


def _describe(t, use_pallas=None, a_layout=None):
    """A TunedConfig's choice, in either package."""
    return (t.alpha, t.delta, t.merge_superpanels, t.group_size, t.k_chunks,
            t.hub_cols, t.hot_rows, t.dense,
            t.use_pallas if use_pallas is None else use_pallas,
            t.a_layout if a_layout is None else a_layout)


@pytest.mark.parametrize("dtype", ["tf32", "float32", "mixed", "bfloat16"])
@pytest.mark.parametrize("k", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("n", [100, 30000, 200000])
def test_candidate_layouts(n, k, dtype):
    assert ta._candidate_layouts(n, k, dtype) == ja._candidate_layouts(
        n, k, dtype)


@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("name", ["block_clustered", "powerlaw",
                                  "dlmc_96x128"])
def test_hub_candidates(name, k):
    t, j = _pair(name)
    assert ta.hub_candidates(t, k) == ja.hub_candidates(j, k)
    if name == "powerlaw":
        assert ta.hub_candidates(t, k)


@pytest.mark.parametrize("dtype", ["tf32", "float16"])
@pytest.mark.parametrize("shape", [(96, 128, 64), (4096, 4096, 128),
                                   (100, 30000, 256)])
def test_estimate_dense_ms(shape, dtype):
    assert ta.estimate_dense_ms(*shape, dtype) == ja.estimate_dense_ms(
        *shape, dtype)


def _assert_same_choice(got, want):
    assert _describe(got) == _describe(want)
    assert got.est_ms == pytest.approx(want.est_ms, rel=EST_REL)
    assert (got.packed is None) == (want.packed is None)
    if got.packed is not None:
        assert got.packed.packed_size == want.packed.packed_size
        assert got.packed.nnz_res == want.packed.nnz_res


@pytest.mark.parametrize("name", list(MATRICES))
def test_autotune_estimate_only_matches_jax(name):
    t, j = _pair(name)
    got, want = ta.autotune(t, k=64), ja.autotune(j, k=64)
    _assert_same_choice(got, want)
    # the winner is packed again with full metadata, as in JAX
    if got.packed is not None:
        assert got.packed.packed_rows is not None
    assert got.measured_ms is None


@pytest.mark.parametrize("name", ["block_clustered", "powerlaw",
                                  "dlmc_96x128"])
def test_autotune_multi_matches_jax(name):
    t, j = _pair(name)
    got = ta.autotune_multi(t, ks=(32, 64))
    want = ja.autotune_multi(j, ks=(32, 64))
    assert sorted(got) == sorted(want) == [32, 64]
    for k in (32, 64):
        _assert_same_choice(got[k], want[k])


def _jax_finalists(monkeypatch, csr, k):
    """JAX's ``_shootout`` finalists, in order: its runners replaced by
    fakes that record what each finalist builds (its packing, C and the
    twins' flags) and time nothing."""
    import sddmm_tpu.ops.dense as jd
    import sddmm_tpu.ops.hybrid as jh
    built, cands = [], []

    class Fake:
        def __init__(self, packed, compute_dtype="tf32", k_chunks=1,
                     use_pallas=False, a_layout="rows"):
            built.append((packed, k_chunks, use_pallas, a_layout))

        @classmethod
        def from_csr(cls, csr, compute_dtype="tf32"):
            return cls(None)

        def prepare_operands(self, a, b=None):
            return None, None

        def measure_kernel_ms(self, *args, **kw):
            return float(len(built))

    monkeypatch.setattr(jh, "HybridSDDMM", Fake)
    monkeypatch.setattr(jd, "DenseSDDMM", Fake)
    shootout = ja._shootout

    def record(csr, k, candidates, *args):
        cands[:] = candidates
        return shootout(csr, k, candidates, *args)

    monkeypatch.setattr(ja, "_shootout", record)
    ja.autotune(csr, k=k, measure=True)
    out = []
    for packed, c, pallas, layout in built:
        cand = next(x for x in cands if (
            x.dense if packed is None
            else x.packed is packed and x.k_chunks == c))
        out.append(_describe(cand, pallas, layout))
    return out


@pytest.mark.parametrize("name", ["block_clustered", "powerlaw",
                                  "dlmc_96x128", "sparse_512"])
def test_shootout_finalists_match_jax(name, monkeypatch):
    """``shootout_finalists`` picks JAX's finalists, twins included."""
    t, j = _pair(name)
    want = _jax_finalists(monkeypatch, j, 64)
    got = []

    def record(csr, k, candidates, compute_dtype, measure_top, *args):
        got[:] = ta.shootout_finalists(candidates, compute_dtype,
                                       measure_top)
        return candidates[0]

    monkeypatch.setattr(ta, "_shootout", record)
    ta.autotune(t, k=64, measure=True, device="cpu")
    assert [_describe(f) for f in got] == want
    assert len(want) >= 3


def test_measured_mode_times_a_dense_finalist_on_cpu():
    """measure=True with device="cpu": every finalist built and timed (the
    host clock), the dense class among them, the fastest wins."""
    t, _ = _pair("dlmc_64")
    win = ta.autotune(t, k=32, alphas=(0.3,), deltas=(0.0,), merges=(False,),
                      measure=True, measure_iterations=2, device="cpu")
    assert any(f.dense for f in win.shootout)
    assert all(f.measured_ms > 0 and f.setup_s >= 0 for f in win.shootout)
    assert win.measured_ms == min(f.measured_ms for f in win.shootout)
    assert [f.measured_ms for f in win.shootout] == sorted(
        f.measured_ms for f in win.shootout)


def test_measured_winner_runs_correctly_on_cpu():
    """The measured winner of a hybrid matrix delivers the golden values."""
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    from sddmm_tpu_torch.ops.reference import sddmm_reference
    from sddmm_tpu_torch.utils.check import check_values
    t, _ = _pair("block_clustered_sparse")
    win = ta.autotune(t, k=32, measure=True, measure_iterations=2,
                      device="cpu")
    assert len(win.shootout) >= 3
    if win.dense:
        runner = DenseSDDMM.from_csr(t, device="cpu")
    else:
        runner = HybridSDDMM(win.packed, k_chunks=win.k_chunks,
                             a_layout=win.a_layout, device="cpu")
    a = tgen.make_dense(t.m, 32, seed=1)
    b = tgen.make_dense(32, t.n, seed=2)
    res = check_values(sddmm_reference(a, b, t), np.asarray(runner(a, b)))
    assert res.passed and res.num_errors == 0, str(res)
