"""Element-wise numerical comparison with the reference's tolerance contract.

Reference: include/checkData.hpp:14-79 — an element passes if
|a - b| < 1e-5, or else if the relative error < 1e-3.  Reports error count,
error rate, and the first few offending indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sddmm_tpu_torch import config


@dataclasses.dataclass
class CheckResult:
    passed: bool
    num_errors: int
    num_checked: int
    max_abs_err: float
    max_rel_err: float
    first_errors: list  # [(index, expected, actual)]

    @property
    def error_rate(self) -> float:
        return self.num_errors / self.num_checked if self.num_checked else 0.0

    def __str__(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        return (f"[{status}] errors: {self.num_errors}/{self.num_checked} "
                f"(rate {self.error_rate:.2e}), max_abs {self.max_abs_err:.3e},"
                f" max_rel {self.max_rel_err:.3e}")


def check_values(expected, actual, abs_tol: float = config.ABS_TOL,
                 rel_tol: float = config.REL_TOL,
                 num_first_errors: int = 10) -> CheckResult:
    expected = np.asarray(expected, dtype=np.float64).ravel()
    actual = np.asarray(actual, dtype=np.float64).ravel()
    if expected.shape != actual.shape:
        raise ValueError(
            f"shape mismatch: {expected.shape} vs {actual.shape}")
    abs_err = np.abs(expected - actual)
    denom = np.maximum(np.abs(expected), np.finfo(np.float64).tiny)
    rel_err = abs_err / denom
    bad = (abs_err >= abs_tol) & (rel_err >= rel_tol)
    idx = np.nonzero(bad)[0]
    first = [(int(i), float(expected[i]), float(actual[i]))
             for i in idx[:num_first_errors]]
    return CheckResult(
        passed=not len(idx),
        num_errors=int(len(idx)),
        num_checked=int(expected.size),
        max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
        max_rel_err=float(rel_err.max()) if rel_err.size else 0.0,
        first_errors=first,
    )
