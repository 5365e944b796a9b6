"""The port's timers on the CPU (host clock; the card's event path is in
``tests/test_torch_card.py``): ``gflops`` equal to the JAX package's, the
timers' shapes and counts, and ``cuda_time_ms`` refusing to run without a
card."""

import pytest
import torch

from sddmm_tpu.utils import timing as jt
from sddmm_tpu_torch.utils import timing as tt
from torch_native_ready import reference_native_loaded  # noqa: F401


@pytest.mark.parametrize("nnz, k, ms", [(5000, 128, 2.0), (1, 32, 1e-3),
                                        (10, 64, 0.0), (10, 64, -1.0)])
def test_gflops_matches_jax(nnz, k, ms):
    assert tt.gflops(nnz, k, ms) == jt.gflops(nnz, k, ms)


def test_timer_measures_the_block():
    with tt.Timer() as t:
        sum(range(10000))
    assert t.ms > 0 and t.ms == t._elapsed_ms


def test_time_fn_on_cpu_tensors():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    ms, out = tt.time_fn(fn, torch.ones(4), iterations=5, warmup=2)
    assert ms > 0 and len(calls) == 7
    assert torch.equal(out, torch.full((4,), 2.0))


def test_call_times_and_sessions_on_cpu():
    calls = []
    t = tt.call_times_ms(lambda: calls.append(1), "cpu", iterations=7)
    assert t["n"] == 7 and len(calls) == 7 + 3
    assert 0 <= t["min_ms"] <= t["median_ms"] <= t["max_ms"]
    calls.clear()
    assert tt.session_median_ms(lambda: calls.append(1), "cpu",
                                iterations=4, repeats=3) >= 0
    assert len(calls) == 3 * (4 + 3)
    with pytest.raises(ValueError):
        tt.call_times_ms(lambda: None, "cpu", iterations=0)


def test_cuda_time_ms_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.cuda_time_ms(lambda: None)


def test_queued_time_ms_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.queued_time_ms(lambda: None)


def test_runner_measure_kernel_ms_on_cpu():
    """Both runners' ``measure_kernel_ms`` time ``run_padded`` in either
    order (the host clock on a CPU runner)."""
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    from sddmm_tpu_torch.reorder.autotune import from_params
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=1)
    a = generate.make_dense(csr.m, 32, seed=1)
    b = generate.make_dense(32, csr.n, seed=2)
    for runner in (HybridSDDMM(from_params(csr, 32, 0.3, 0.05).packed,
                               device="cpu"),
                   DenseSDDMM.from_csr(csr, device="cpu")):
        ops = runner.prepare_operands(a, b=b)
        for order in ("packed", "csr"):
            assert runner.measure_kernel_ms(*ops, iterations=3, repeats=2,
                                            order=order) > 0
