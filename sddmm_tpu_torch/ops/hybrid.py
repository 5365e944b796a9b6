"""Hybrid dense-tile + sparse-residual SDDMM on the card.

Counterpart of ``sddmm_tpu/ops/hybrid.py`` (``HybridSDDMM``,
``_hybrid_packed_jit``, ``build_bt_phys``, ``to_csr_order``) for the
configurations the port runs so far: gather-group size G = 1, one K chunk
(C = 1), no hub slab, no hot-row slab, ``compute_dtype`` ``"tf32"`` (and
``"float32"`` on CPU tensors, for the parity tests), ``a_layout`` ``"rows"``
or ``"panels"``.  Everything else raises ``NotImplementedError`` naming the
ROADMAP Queue 1 item that will bring it.

The packed flat vector has the JAX package's layout exactly:
``[super ++ quad ++ pair ++ group segments ++ residual]``, each segment
run-major ``(n_runs, R, b*128)``.  It is allocated once per call and each
segment's tile dot writes straight into its view of it.  Per segment:

- the run rows are every b-th row of the family's row array (or, under
  ``a_layout="panels"``, the run's R/16 consecutive A panels, clamped to
  the zero sentinel panel), gathered from A with torch indexing;
- the b*128 B^T rows are gathered by group id;
- ``tile_dot_bf16x3`` (the CUDA port of the Pallas tile dot) computes the
  ``(n_runs, R, b*128)`` block.  In ``"tf32"`` mode every dense tile goes
  through it, whether or not ``use_pallas`` is set: XLA's
  ``Precision.HIGH`` is the same 3-pass bf16 product.

The residual is one exact fp32 dot per entry (``residual_gather_dot``, a
CUDA kernel on the card).  Slots that are not nnz hold garbage, as in the
reference; compare real slots only, or CSR order.  CSR order is one gather,
``flat[inv_idx]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from sddmm_tpu_torch import _kernels, config
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.tile_dot import (full_fp32_matmul,
                                          tile_dot_bf16x3,
                                          tile_dot_bf16x3_plain)
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import GROUP_LANES, PackedMatrix, pack

PANEL_ROWS = config.ROW_PANEL_SIZE  # 16-row panels (pack.py carve unit)
COMPUTE_DTYPES = ("tf32", "float32")
_FAMILIES = ("super", "quad", "pair", "group")


def residual_gather_dot_plain(a_pad: torch.Tensor, bt_rows: torch.Tensor,
                              rows: torch.Tensor,
                              gids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index, then an fp32 row-wise dot."""
    return (a_pad[rows.long()] * bt_rows[gids.long()]).sum(dim=-1)


def residual_gather_dot(a_pad: torch.Tensor, bt_rows: torch.Tensor,
                        rows: torch.Tensor, gids: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = a_pad[rows[i]] . bt_rows[gids[i]]`` in exact fp32.

    a_pad (M+1, K) and bt_rows (NG+1, K) float32 contiguous; rows and gids
    (nR,) int32.  CUDA tensors go through the gather-dot kernel
    (``csrc/gather_dot.cu``) or raise; CPU tensors through
    ``residual_gather_dot_plain``."""
    if a_pad.dim() != 2 or bt_rows.dim() != 2 \
            or a_pad.shape[1] != bt_rows.shape[1]:
        raise ValueError(f"gather_dot: a_pad {tuple(a_pad.shape)} and "
                         f"bt_rows {tuple(bt_rows.shape)} disagree")
    n = rows.shape[0]
    if rows.shape != (n,) or gids.shape != (n,):
        raise ValueError("gather_dot: rows and gids must be (nR,)")
    tensors = [("a_pad", a_pad, torch.float32),
               ("bt_rows", bt_rows, torch.float32),
               ("rows", rows, torch.int32), ("gids", gids, torch.int32)]
    if out is not None:
        tensors.append(("out", out, torch.float32))
        if out.shape != (n,):
            raise ValueError(f"gather_dot: out {tuple(out.shape)} != ({n},)")
    for name, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"gather_dot: {name} is {t.dtype}, want {dt}")
        if not t.is_contiguous():
            raise ValueError(f"gather_dot: {name} is not contiguous")
        if t.device != a_pad.device:
            raise ValueError(f"gather_dot: {name} is on {t.device}, a_pad "
                             f"on {a_pad.device}")
    if a_pad.device.type == "cpu":
        res = residual_gather_dot_plain(a_pad, bt_rows, rows, gids)
        if out is None:
            return res
        out.copy_(res)
        return out
    if a_pad.device.type != "cuda":
        raise ValueError(f"gather_dot: unsupported device {a_pad.device}")
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=a_pad.device)
    if n == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(a_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sddmm_gather_dot(
            ctypes.c_void_p(a_pad.data_ptr()),
            ctypes.c_void_p(bt_rows.data_ptr()),
            ctypes.c_void_p(rows.data_ptr()),
            ctypes.c_void_p(gids.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, a_pad.shape[1],
            ctypes.c_void_p(stream))
    _kernels.check(rc, "residual_gather_dot")
    residual_gather_dot.launches += 1
    return out


#: kernel launches made by ``residual_gather_dot`` (CUDA path only)
residual_gather_dot.launches = 0


def build_bt_phys(bt_pad: np.ndarray, packed: PackedMatrix,
                  k_chunks: int = 1) -> np.ndarray:
    """Host-side grouped/chunked B^T layout: (C, NG+1, G*Kc), as the JAX
    package's ``build_bt_phys``.

    bt_pad: (N+1, K) with zero sentinel row.  Physical group row g of
    chunk c holds [K-chunk c of col_order[g*G+0], ..., of col_order[g*G+
    G-1]]; the sentinel group row NG is all zeros (col_order sentinels
    point at bt_pad's zero row N).
    """
    G, NG = packed.group_size, packed.num_col_groups
    n_sent = bt_pad.shape[0] - 1
    k = bt_pad.shape[1]
    C = int(k_chunks)
    kc = k // C
    assert kc * C == k, f"K={k} not divisible by k_chunks={C}"
    order = np.where(packed.col_order < n_sent, packed.col_order, n_sent)
    arr = bt_pad[order]                              # (NG*G, K)
    arr = arr.reshape(NG, G, C, kc).transpose(2, 0, 1, 3)
    arr = np.ascontiguousarray(arr.reshape(C, NG, G * kc))
    sent = np.zeros((C, 1, G * kc), dtype=arr.dtype)
    return np.concatenate([arr, sent], axis=1)


def check_slice(packed: PackedMatrix, compute_dtype: str,
                k_chunks: int) -> None:
    """Raise NotImplementedError for a configuration the port does not run
    yet, naming the ROADMAP Queue 1 item that brings it."""
    todo = []
    if packed.group_size != 1:
        todo.append(f"gather groups G={packed.group_size} (ROADMAP Queue 1: "
                    "'G>1 and C>1')")
    if int(k_chunks) != 1:
        todo.append(f"K chunks C={k_chunks} (ROADMAP Queue 1: "
                    "'G>1 and C>1')")
    if packed.hub_cols:
        todo.append(f"hub slab H={packed.hub_cols} (ROADMAP Queue 1: "
                    "'Hub and hot-row slabs')")
    if packed.rowslab_rows is not None:
        todo.append("hot-row slab (ROADMAP Queue 1: 'Hub and hot-row "
                    "slabs')")
    if compute_dtype not in COMPUTE_DTYPES:
        todo.append(f"compute_dtype {compute_dtype!r} (ROADMAP Queue 1: "
                    "'Other compute modes')")
    if todo:
        raise NotImplementedError(
            "sddmm_tpu_torch.HybridSDDMM does not run " + "; ".join(todo)
            + " yet")


@dataclasses.dataclass
class _Segment:
    """One (family, bucket) segment of the packed flat vector."""
    offset: int          # start in the flat vector
    n_runs: int
    rows: int            # R, the run height
    lanes: int           # b*128
    a_idx: torch.Tensor  # (n_runs, R) A rows, or (n_runs, R/16) A panels
    gids: torch.Tensor   # (n_runs, b*128) grouped-B^T rows

    @property
    def size(self) -> int:
        return self.n_runs * self.rows * self.lanes


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"HybridSDDMM(device={str(device)!r}): CUDA is not "
                           "available (torch.cuda.is_available() is False)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"HybridSDDMM: unsupported device {dev}")
    return dev


class HybridSDDMM:
    """Reusable hybrid SDDMM for a fixed sparsity packing, on one device.

    Holds the packed index arrays on ``device`` (given explicitly), so a
    call only ships A and B.  Output layouts (``order``): ``"packed"``, the
    flat vector of length ``packed.packed_size`` in which non-nnz slots hold
    garbage; ``"csr"``, the values in CSR entry order of the input matrix.
    """

    def __init__(self, packed: PackedMatrix, compute_dtype: str = "tf32",
                 k_chunks: int = 1, use_pallas: bool = False,
                 a_layout: str = "rows", device="cpu"):
        check_slice(packed, compute_dtype, k_chunks)
        if a_layout not in ("rows", "panels"):
            raise ValueError(f"unknown a_layout {a_layout!r}")
        if a_layout == "panels" and packed.cont_panel_off is None:
            raise ValueError("a_layout='panels' needs container topology "
                             "(packed.cont_panel_off)")
        self.device = _device(device)
        if self.device.type == "cuda" and compute_dtype != "tf32":
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} on the card (ROADMAP "
                "Queue 1: 'Other compute modes'); it runs on CPU tensors "
                "only")
        self.packed = packed
        self.compute_dtype = compute_dtype
        self.k_chunks = int(k_chunks)
        # accepted for config compatibility: every tf32 dense tile goes
        # through the tile-dot kernel either way
        self.use_pallas = bool(use_pallas)
        self.a_layout = a_layout

        def put(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        if a_layout == "panels":
            # containers span consecutive panels (the DP carve), so run
            # i's A block is panels [pst[i], pst[i] + R/16), clamped to
            # the zero sentinel panel
            first_panel = packed.cont_panel_ids[packed.cont_panel_off[:-1]]
            self._a_panel_gather = np.where(
                packed.a_row_gather < packed.m, packed.a_row_gather,
                packed.m)
            sentinel_panel = len(self._a_panel_gather) // PANEL_ROWS
        self._segments = []
        offset = 0
        for fam in _FAMILIES:
            rows_arr = getattr(packed, fam + "_rows")
            gids_arr = getattr(packed, fam + "_gids")
            R = rows_arr.shape[1]
            if a_layout == "panels":
                run_cont = getattr(packed, fam + "_run_cont")
                pst = (first_panel[run_cont] if len(run_cont)
                       else np.zeros(0, np.int64))
            run_off = 0
            for (b, start, n_runs) in getattr(packed, fam + "_buckets"):
                if a_layout == "panels":
                    pids = (pst[run_off:run_off + n_runs, None]
                            + np.arange(R // PANEL_ROWS))
                    a_idx = np.minimum(pids, sentinel_panel)
                else:
                    a_idx = rows_arr[start:start + n_runs * b:b]
                run_off += n_runs
                gids = gids_arr[start:start + n_runs * b].reshape(
                    n_runs, b * GROUP_LANES)
                seg = _Segment(offset, n_runs, R, b * GROUP_LANES,
                               put(a_idx), put(gids))
                self._segments.append(seg)
                offset += seg.size
        self._res_offset = offset
        self._res_rows = put(packed.res_rows, torch.int32)
        self._res_gids = put(packed.res_gids, torch.int32)
        if offset + len(packed.res_rows) != packed.packed_size:
            raise ValueError(
                f"packing layout mismatch: segments {offset} + residual "
                f"{len(packed.res_rows)} != packed_size {packed.packed_size}")
        self._inv_idx = (put(packed.inv_idx)
                         if packed.inv_idx is not None else None)
        self._packed_rows = (put(packed.packed_rows)
                             if packed.packed_rows is not None else None)
        self._packed_cols = (put(packed.packed_cols)
                             if packed.packed_cols is not None else None)

    @property
    def packed_rows(self) -> torch.Tensor:
        """(F,) original row id per packed slot (sentinel = m)."""
        if self._packed_rows is None:
            raise ValueError("light packing (full_metadata=False) has no "
                             "packed_rows; re-pack with full metadata")
        return self._packed_rows

    @property
    def packed_cols(self) -> torch.Tensor:
        """(F,) original col id per packed slot (sentinel = n)."""
        return self._packed_cols

    def prepare_operands(self, a, b):
        """numpy A (M, K) and B (K, N) -> the runner's operands on its
        device: ``(a_pad, bt_phys)``, with ``a_pad`` the pair
        ``(a_pad, a_panels)`` under ``a_layout="panels"``."""
        a = np.asarray(a, dtype=np.float32)
        bt = np.ascontiguousarray(np.asarray(b, dtype=np.float32).T)
        a_pad = np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)])
        bt_pad = np.concatenate([bt, np.zeros((1, bt.shape[1]), bt.dtype)])
        bt_phys = build_bt_phys(bt_pad, self.packed, self.k_chunks)

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=self.device)

        a_dev = put(a_pad)
        if self.a_layout == "panels":
            k = a_pad.shape[1]
            ap = a_pad[self._a_panel_gather]
            ap = np.concatenate([ap.reshape(-1, PANEL_ROWS, k),
                                 np.zeros((1, PANEL_ROWS, k), a_pad.dtype)])
            a_dev = (a_dev, put(ap))
        return a_dev, put(bt_phys)

    def __call__(self, a, b, order: str = "csr"):
        """Host convenience: numpy in, CSR order out by default."""
        a_ops, bt_phys = self.prepare_operands(a, b)
        return self.run_padded(a_ops, bt_phys, order=order)

    def _dot(self, a_run, bg, out, plain):
        if self.compute_dtype == "tf32":
            if plain:
                return out.copy_(tile_dot_bf16x3_plain(a_run, bg))
            return tile_dot_bf16x3(a_run, bg, out=out)
        # "float32": exact fp32, on CPU tensors only (checked in __init__)
        with full_fp32_matmul():
            return torch.bmm(a_run, bg.transpose(1, 2), out=out)

    def _operands(self, a_ops, bt_phys: torch.Tensor):
        """(a_pad, a_panels or None, bt_rows) from run_padded's operands."""
        if isinstance(a_ops, (tuple, list)):
            a_pad, a_panels = a_ops
        else:
            a_pad, a_panels = a_ops, None
        if self.a_layout == "panels" and a_panels is None:
            raise ValueError("a_layout='panels' operands must come from "
                             "prepare_operands (need the panel-major A)")
        if bt_phys.dim() == 3:
            if bt_phys.shape[0] != 1:
                raise NotImplementedError("K chunks C>1 (ROADMAP Queue 1: "
                                          "'G>1 and C>1')")
            bt_phys = bt_phys[0]
        return a_pad, a_panels, bt_phys

    def dense_inputs(self, a_ops, bt_phys: torch.Tensor):
        """Yield ``(segment, a_run, bg)`` for every dense segment in packed
        order: the gathered A block (n, R, K) and B^T rows (n, b*128, K)
        of its tile dot.  One segment's gathers are live at a time."""
        a_pad, a_panels, bt_rows = self._operands(a_ops, bt_phys)
        k = a_pad.shape[1]
        for seg in self._segments:
            if a_panels is not None:
                a_run = a_panels[seg.a_idx].reshape(seg.n_runs, seg.rows, k)
            else:
                a_run = a_pad[seg.a_idx]
            yield seg, a_run, bt_rows[seg.gids]

    def residual_inputs(self, a_ops, bt_phys: torch.Tensor):
        """``(a_pad, bt_rows, rows, gids)``, the residual gather-dot's
        arguments."""
        a_pad, _, bt_rows = self._operands(a_ops, bt_phys)
        return a_pad, bt_rows, self._res_rows, self._res_gids

    def run_padded(self, a_ops, bt_phys: torch.Tensor,
                   order: str = "packed",
                   plain: bool = False) -> torch.Tensor:
        """Compute from operands already in the runner's layout
        (``prepare_operands``).  ``order`` is ``"packed"`` or ``"csr"``.

        ``plain=True`` runs the plain PyTorch versions of the kernels on
        any device: the reference the kernels are timed against on the
        card.  It is only ever chosen explicitly."""
        if order not in ("packed", "csr"):
            raise ValueError(f"unknown order {order!r}")
        residual = self.residual_inputs(a_ops, bt_phys)
        flat = torch.empty(self.packed.packed_size, dtype=torch.float32,
                           device=residual[0].device)
        for seg, a_run, bg in self.dense_inputs(a_ops, bt_phys):
            view = flat[seg.offset:seg.offset + seg.size].view(
                seg.n_runs, seg.rows, seg.lanes)
            self._dot(a_run, bg, view, plain)
        res = flat[self._res_offset:]
        if plain:
            res.copy_(residual_gather_dot_plain(*residual))
        else:
            residual_gather_dot(*residual, out=res)
        if order == "csr":
            return self.to_csr_order(flat)
        return flat

    def to_csr_order(self, flat: torch.Tensor) -> torch.Tensor:
        """Packed-order flat vector -> CSR entry order: one gather."""
        if self._inv_idx is None:
            raise ValueError("light packing (full_metadata=False) has no "
                             "CSR-order metadata; re-pack with full "
                             "metadata")
        return flat[self._inv_idx]

    @staticmethod
    def from_csr(csr: CSR, alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA,
                 compute_dtype: str = "tf32", method: str = "auto",
                 device="cpu") -> "HybridSDDMM":
        bsmr = BSMR(alpha, delta, csr, method=method)
        return HybridSDDMM(pack(csr, bsmr), compute_dtype=compute_dtype,
                           device=device)
