"""Batched SDDMM and batched transpose.

Counterpart of ``sddmm_tpu/ops/batch.py`` (``batched_csr_sddmm``,
``BatchedHybridSDDMM``, ``batched_transpose``, ``batch_overlap_report``).
The JAX package batches with ``jax.vmap`` over the single-instance paths.
Here ``BatchedHybridSDDMM`` passes the batch to the runner's
``run_heads``: the tiles of every batch element are one tile-kernel launch
with a head stride on A, B^T and the output (the vmapped batch, K12), and
so is the residual's gather-dot.  ``batched_csr_sddmm`` is one gather-dot
launch for the batch, walking the pattern's plan (``csr_plan``).  Both differentiate
through the runner's autograd op and ``csr_sddmm_torch``'s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.csr_sddmm import csr_plan, csr_sddmm_torch
from sddmm_tpu_torch.ops.hybrid import (HybridSDDMM, check_device,
                                        storage_cast)
from sddmm_tpu_torch.ops.tile_dot import STORAGE
from sddmm_tpu_torch.utils import profiling


def batched_csr_sddmm(a_batch, b_batch, s: CSR, device="cuda"
                      ) -> np.ndarray:
    """(B, M, K) x (B, K, N) -> (B, nnz) values at the shared pattern of S,
    in CSR entry order (numpy in, numpy out)."""
    dev = check_device(device)
    rows = torch.as_tensor(s.row_indices(), dtype=torch.int32, device=dev)
    cols = torch.as_tensor(s.col_idx, dtype=torch.int32, device=dev)
    a_batch = torch.as_tensor(np.asarray(a_batch, dtype=np.float32),
                              device=dev)
    bt_batch = batched_transpose(torch.as_tensor(
        np.asarray(b_batch, dtype=np.float32), device=dev))
    plan = csr_plan(s).to(dev)
    return csr_sddmm_torch(a_batch, bt_batch, rows, cols,
                           plan).cpu().numpy()


def _pad_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, M, K) -> (B, M+1, K) with a zero sentinel row."""
    return torch.nn.functional.pad(x, (0, 0, 0, 1))


class BatchedHybridSDDMM:
    """The hybrid path over a batch of (A, B) operand pairs sharing one
    sparsity pattern (the reference's batch mode semantics).

    Any packing (G > 1, C > 1, column clustering, ``a_layout="panels"``):
    the batch's B^T goes through ``runner.device_bt`` in one set of torch
    ops, and the runner's work table reads A rows (and panel rows) straight
    from the padded A, so no per-element layout is built."""

    def __init__(self, runner: HybridSDDMM):
        self.runner = runner

    def run_padded(self, a_pad: torch.Tensor, bt_pad: torch.Tensor,
                   order: Optional[str] = None, plain: bool = False
                   ) -> torch.Tensor:
        """Padded A (B, M+1, K) and B^T (B, N+1, K) on the runner's device
        -> (B, packed_size), or (B, nnz) with ``order="csr"`` (None: the
        runner's ``default_order``): one tile-kernel launch for the whole
        batch.  ``plain`` as in ``HybridSDDMM.run_padded``; differentiable
        in both operands.  Grouped-query attention: B^T of fewer heads
        (Bkv, N+1, K), query head h reading key head ``h >> head_shift(B,
        Bkv)`` in place (``HybridSDDMM.run_heads``)."""
        if a_pad.dim() != 3 or bt_pad.dim() != 3 or (
                a_pad.shape[0] % bt_pad.shape[0]):
            raise ValueError(f"want a_pad (B, M+1, K) and bt_pad (B, N+1, K),"
                             f" got {tuple(a_pad.shape)} and "
                             f"{tuple(bt_pad.shape)}")
        r = self.runner
        adt, bdt = STORAGE[r.compute_dtype]
        with profiling.span("hybrid.prepare"):
            a_pad = storage_cast(a_pad, adt)
            bt_phys = r.device_bt(storage_cast(bt_pad, bdt))
        return r.run_heads(a_pad, bt_phys, order=order, plain=plain)

    def __call__(self, a_batch, b_batch) -> np.ndarray:
        """numpy A (B, M, K) and B (B, K, N) -> (B, packed_size) numpy in
        the packed layout (non-nnz slots hold garbage), or (B, nnz) in CSR
        order for a runner whose ``default_order`` is "csr"."""
        dev = self.runner.device
        a = torch.as_tensor(np.asarray(a_batch, dtype=np.float32), device=dev)
        b = torch.as_tensor(np.asarray(b_batch, dtype=np.float32), device=dev)
        return self.run_padded(_pad_rows(a),
                               _pad_rows(batched_transpose(b))).cpu().numpy()


def batched_transpose(x: torch.Tensor) -> torch.Tensor:
    """(B, M, N) -> (B, N, M), contiguous (the reference hand-writes a 32x32
    shared-memory transpose kernel; here it is one torch copy)."""
    return torch.as_tensor(x).transpose(-1, -2).contiguous()


def batch_overlap_report(runner: HybridSDDMM, a_batch, b_batch,
                         iterations: int = 20) -> dict:
    """Batched-vs-sequential efficiency on the card, the analogue of the
    reference's batch-overlap printout (src/sddmmKernel.cu:2834-2844).

    Returns {batch_size, batch_ms, serial_ms, overlap_efficiency}, where
    serial_ms is batch_size times one element's call and overlap_efficiency
    = serial_ms / batch_ms (1.0: batching is free; above 1.0 the one
    tile-kernel launch of the batch does better than its calls one by
    one).  Times are CUDA-event medians (``utils.timing.cuda_time_ms``):
    the runner must be on a CUDA device."""
    from sddmm_tpu_torch.utils.timing import cuda_time_ms

    if runner.device.type != "cuda":
        raise RuntimeError("batch_overlap_report times on the card: build "
                           "the runner with device='cuda'")
    batched = BatchedHybridSDDMM(runner)
    dev = runner.device
    a = _pad_rows(torch.as_tensor(np.asarray(a_batch, dtype=np.float32),
                                  device=dev))
    bt = _pad_rows(batched_transpose(torch.as_tensor(
        np.asarray(b_batch, dtype=np.float32), device=dev)))
    bsz = a.shape[0]
    with torch.inference_mode():
        batch_ms = cuda_time_ms(lambda: batched.run_padded(a, bt),
                                iterations)["median_ms"]
        single_ms = cuda_time_ms(lambda: runner.run_padded(
            *runner.device_prepare(a[0], bt[0])), iterations)["median_ms"]
    serial_ms = single_ms * bsz
    return {"batch_size": bsz,
            "batch_ms": batch_ms,
            "serial_ms": serial_ms,
            "overlap_efficiency": serial_ms / batch_ms if batch_ms else 0.0}
