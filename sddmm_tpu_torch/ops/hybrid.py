"""Hybrid dense-tile + sparse-residual SDDMM on the card.

Counterpart of ``sddmm_tpu/ops/hybrid.py`` (``HybridSDDMM``,
``_hybrid_packed_jit``, ``device_bt_phys``, ``sddmm_hybrid``) for every
packing the JAX package builds: any gather-group size G, any number C of K
chunks, the hub slab and the hot-row slab, the five compute modes
(``tile_dot.MODES``) and ``a_layout`` ``"rows"`` or ``"panels"``.  Device
row clustering (``method="device"``) is not ported yet and raises
``NotImplementedError`` naming its ROADMAP item (``check_slice``).

The packed flat vector has the JAX package's layout exactly:
``[super ++ quad ++ pair ++ group segments ++ hub ++ hot-row slab ++
residual]``.  It is allocated once per call.  All its dense tiles are one
launch of the tile kernel (``tile_dot.tile_table``) over a work table built
once in ``__init__``, one entry per (at most) 64-row by 128-lane output
block:

- per dense (family, bucket) segment and run, the run's R A rows (every
  b-th row of the family's row array; under ``a_layout="panels"`` the rows
  of the run's R/16 consecutive A panels, ``_a_panel_gather[16p + r]``, or
  the zero row for the sentinel panel, so the per-call panel relayout is
  not needed) against its b*128 lanes, lane ``l`` being member ``l % G``
  of group row ``gids[l // G]``: the packed lane order, at any G;
- the hub slab: ``a_pad[:m]`` against group rows ``0..H/G-1``;
- the hot-row slab: the ``rowslab_rows`` against all NG group rows; the
  slot of a hot entry is ``hot_index*NG*G + rank``;
- the C chunks loop inside the kernel, each summed apart and added in the
  order c = 0..C-1, as JAX's ``acc = acc + dot(c)``.

The kernel runs whether or not ``use_pallas`` is set: XLA's
``Precision.HIGH`` is the same 3-pass bf16 product as the Pallas kernel.
A batch of heads over one packing (``run_heads``) is the same one launch
with a head stride.  ``plain=True`` runs the per-segment route
(``tile_calls``: torch gathers and ``tile_dot_plain`` per segment and
chunk), the reference the kernel is held to.  The residual is one exact
fp32 dot per entry over all chunks (``residual_gather_dot``, a CUDA kernel
on the card, one launch for all heads), walking a plan built once in
``__init__`` (``res_plan``: residual rows that share group rows read each
of them once).  Slots that are not nnz hold garbage, as in the reference;
compare real slots only, or CSR order.  CSR order is one gather,
``flat[inv_idx]``.

``run_padded`` and ``run_heads`` are an autograd op (B1, the VJP of
``_hybrid_packed_jit`` that ``jax.value_and_grad`` builds): the cotangent
of the packed flat vector reaches A and the grouped B^T through what the
forward read for each slot, garbage slots included, as JAX differentiates
through them.  The dense tiles' share walks the same work table
(``tile_dot.tile_table_grad``: per entry ``dA_rows += dO . B^T_lanes`` and
``dB^T_lanes += dO^T . A_rows`` on the tensor cores, two launches for all
heads and chunks); the residual's entries are one SpMM launch each for dA
and dB^T over a pattern of the residual alone (``grad_state``, built at
the first backward and kept).  Everything sums in fp32 in a fixed order.
The earlier route, two SpMMs over the *read pattern* of every packed slot
(``read_pattern``, ``grad_patterns``, ``vjp_read_pattern``), stays as an
explicit call, the yardstick the new route is timed against.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from sddmm_tpu_torch import _kernels, config
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.gather_plan import GatherPlan, gather_plan
from sddmm_tpu_torch.ops.tile_dot import (STORAGE, TileTable, table_blocks,
                                          tile_dot, tile_table,
                                          tile_table_grad,
                                          tile_table_grad_plain)
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import GROUP_LANES, PackedMatrix, pack

PANEL_ROWS = config.ROW_PANEL_SIZE  # 16-row panels (pack.py carve unit)
COMPUTE_DTYPES = tuple(STORAGE)
_FAMILIES = ("super", "quad", "pair", "group")
#: (A, B) storage pairs the gather-dot takes: those of the compute modes
GATHER_STORAGE = tuple(dict.fromkeys(STORAGE.values()))


def _gather_shape(a_pad, bt_phys, member):
    """(C, G, kc) of a gather-dot call, checked: a_pad (..., M+1, K) and
    bt_phys (..., C, NG+1, G*kc) with the same leading dimensions."""
    if a_pad.dim() < 2 or bt_phys.dim() != a_pad.dim() + 1 or (
            a_pad.shape[:-2] != bt_phys.shape[:-3]):
        raise ValueError(f"gather_dot: want a_pad ([H,] M+1, K) and bt_phys "
                         f"([H,] C, NG+1, G*kc), got {tuple(a_pad.shape)} "
                         f"and {tuple(bt_phys.shape)}")
    C, k = bt_phys.shape[-3], a_pad.shape[-1]
    kc = k // C if C else 0
    if kc < 1 or kc * C != k or bt_phys.shape[-1] % kc:
        raise ValueError(f"gather_dot: a_pad {tuple(a_pad.shape)} and "
                         f"bt_phys {tuple(bt_phys.shape)} disagree on K")
    G = bt_phys.shape[-1] // kc
    if G > 1 and member is None:
        raise ValueError(f"gather_dot: G={G} needs member")
    return C, G, kc


def residual_gather_dot_plain(a_pad: torch.Tensor, bt_phys: torch.Tensor,
                              rows: torch.Tensor, gids: torch.Tensor,
                              member: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version, the JAX residual's formula: per chunk, take
    the group rows, select the member with a one-hot and take the fp32
    row-wise dot.  A 2-D ``bt_phys`` is one chunk of G = 1."""
    if bt_phys.dim() == 2:
        bt_phys = bt_phys[None]
    C, G, kc = _gather_shape(a_pad, bt_phys, member)
    n = rows.shape[0]
    a_res = a_pad[rows.long()]
    res = torch.zeros(n, dtype=torch.float32, device=a_pad.device)
    if G > 1:
        onehot = (member.long()[:, None]
                  == torch.arange(G, device=a_pad.device)[None, :])
    for c in range(C):
        br = bt_phys[c][gids.long()]
        if G > 1:
            br = (br.reshape(n, G, kc).to(torch.float32)
                  * onehot[:, :, None]).sum(dim=1)
        a_r = a_res[:, c * kc:(c + 1) * kc]
        res = res + (a_r.to(torch.float32)
                     * br.to(torch.float32)).sum(dim=-1)
    return res


def gather_dot_plan_plain(a_pad: torch.Tensor, bt_phys: torch.Tensor,
                          plan: GatherPlan) -> torch.Tensor:
    """The kernel's walk of a grouped plan in PyTorch ops: per group row,
    the items that hold it, each dotted (fp32 products and sums, per chunk,
    the chunks added in order) with the group's A row and written to its
    entry.  One head: a_pad (M+1, C*kc), bt_phys (C, NG+1, G*kc)."""
    C, k = bt_phys.shape[0], a_pad.shape[1]
    kc = k // C
    G = bt_phys.shape[2] // kc
    dev = a_pad.device
    groups = torch.as_tensor(plan.groups, device=dev).long()
    items = torch.as_tensor(plan.items, device=dev).long()
    item_group = torch.repeat_interleave(
        torch.arange(len(groups), device=dev), groups[:, 1] - groups[:, 0])
    out = torch.zeros(plan.n, dtype=torch.float32, device=dev)
    for r in range(plan.group_rows):
        has = items[:, 1 + r] >= 0
        ent, key = items[has, 1 + r], items[has, 0]
        rows = groups[item_group[has], 2 + r]
        gid, member = key // G, key % G
        lanes = member[:, None] * kc + torch.arange(kc, device=dev)
        res = torch.zeros(len(ent), dtype=torch.float32, device=dev)
        for c in range(C):
            b = bt_phys[c][gid[:, None], lanes]
            a = a_pad[rows, c * kc:(c + 1) * kc]
            res = res + (a.to(torch.float32) * b.to(torch.float32)).sum(
                dim=-1)
        out[ent] = res
    return out


def _gather_vec(kc, a_pad, bt_phys, *strides) -> int:
    """8 where the kernel's 16-byte loads fit: kc, the row, chunk and head
    strides multiples of 8 elements and both pointers 16-byte aligned;
    else 1 (scalar loads)."""
    ok = (kc % 8 == 0 and all(st % 8 == 0 for st in strides)
          and a_pad.data_ptr() % 16 == 0 and bt_phys.data_ptr() % 16 == 0)
    return 8 if ok else 1


def _gather_lanes(vec, kc, C) -> int:
    """Lanes of a dot in the entry-order walk: the fewest of 8, 16, 32
    whose 8-element loads cover the C chunks of kc in at most two slices a
    lane (the slices it keeps in registers); 32 at scalar loads."""
    if vec == 1:
        return 32
    return next((n for n in (8, 16) if C * -(-kc // (8 * n)) <= 2), 32)


#: shared memory one block may take on the card (bytes): an H100's 227 KB
GATHER_SMEM_LIMIT = 227 * 1024


def plan_smem_bytes(group_rows: int, k: int) -> int:
    """Shared memory of a planned gather-dot block at group size GR and K
    (``csrc/gather_dot.cu`` launch_plan: the group's A rows, K + 32 floats
    each, and 4 warps' staging of 32 B^T slices at its widest)."""
    return 4 * (group_rows * (k + 32) + 4 * 32 * 36)


def planned_walk(plan: Optional[GatherPlan], k: int) -> bool:
    """Whether a gather-dot call at K = ``k`` walks ``plan``: a grouped
    plan whose block fits ``GATHER_SMEM_LIMIT`` at that K.  Otherwise the
    same kernel walks the entries in their order, which takes any K: the
    walk is chosen at launch, from the call's K, on both devices."""
    return (plan is not None and plan.grouped
            and plan_smem_bytes(plan.group_rows, k) <= GATHER_SMEM_LIMIT)


def residual_gather_dot(a_pad: torch.Tensor, bt_phys: torch.Tensor,
                        rows: torch.Tensor, gids: torch.Tensor,
                        member: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None,
                        plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """``out[i] = sum_c a_pad[rows[i], c*kc:(c+1)*kc] .
    bt_phys[c, gids[i], member[i]*kc:(member[i]+1)*kc]`` in exact fp32,
    for one head or for H heads at once.

    a_pad (M+1, C*kc) or (H, M+1, C*kc), rows contiguous; bt_phys
    (C, NG+1, G*kc) or (H, C, NG+1, G*kc) contiguous (a 2-D (NG+1, K) is
    one chunk of G = 1); the two stored as one of the ``GATHER_STORAGE``
    pairs (fp32/fp32, fp32/bf16, fp16/fp16, bf16/bf16).  rows, gids and
    member (nR,) int32 and in range (the packing guarantees it); member
    None means G = 1.  ``out`` (nR,) or (H, nR) fp32, its last dimension
    contiguous (a head stride is taken as it is).  ``plan``: the entries'
    ``GatherPlan`` on this device (``gather_plan(rows, gids * G + member)
    .to(device)``), or None to walk the entries in their order; a plan
    whose block would not fit in shared memory at this K is not walked
    (``planned_walk``).  CUDA tensors go through the gather-dot kernel
    (``csrc/gather_dot.cu``, one launch for all heads) or raise; CPU tensors
    through the plain versions (``gather_dot_plan_plain`` where the plan is
    walked, else ``residual_gather_dot_plain``), head by head."""
    one = a_pad.dim() == 2
    if one:
        if out is not None and out.dim() != 1:
            raise ValueError(f"gather_dot: out {tuple(out.shape)} for one "
                             "head")
        a_pad = a_pad.unsqueeze(0)
        bt_phys = (bt_phys.unsqueeze(0) if bt_phys.dim() == 3
                   else bt_phys[None, None])
        out = None if out is None else out.unsqueeze(0)
    if a_pad.dim() != 3:
        raise ValueError(f"gather_dot: want a_pad (H, M+1, K), got "
                         f"{tuple(a_pad.shape)}")
    C, _, kc = _gather_shape(a_pad, bt_phys, member)
    heads, k = a_pad.shape[0], a_pad.shape[2]
    n = rows.shape[0]
    dev = a_pad.device
    index = (("rows", rows), ("gids", gids)) + (
        () if member is None else (("member", member),))
    for name, t in index:
        if t.dtype != torch.int32:
            raise TypeError(f"gather_dot: {name} is {t.dtype}, want "
                            "torch.int32")
        if t.shape != (n,) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"gather_dot: {name} {tuple(t.shape)} on "
                             f"{t.device} must be a contiguous ({n},) on "
                             f"{dev}")
    if (a_pad.dtype, bt_phys.dtype) not in GATHER_STORAGE:
        raise TypeError(f"gather_dot: a_pad/bt_phys are {a_pad.dtype}/"
                        f"{bt_phys.dtype}, want one of {GATHER_STORAGE}")
    if bt_phys.device != dev or a_pad.stride(2) != 1 or (
            not bt_phys.is_contiguous()):
        raise ValueError("gather_dot: bt_phys must be contiguous and a_pad's "
                         "rows too, both on one device")
    if out is not None and (out.shape != (heads, n) or out.dtype
                            != torch.float32 or out.device != dev
                            or (n > 1 and out.stride(1) != 1)):
        raise ValueError(f"gather_dot: out {tuple(out.shape)} {out.dtype}, "
                         f"want ({heads}, {n}) float32 rows on {dev}")
    if plan is not None and plan.n != n:
        raise ValueError(f"gather_dot: the plan covers {plan.n} entries, "
                         f"not {n}")
    grouped = planned_walk(plan, k)
    if dev.type == "cpu":
        res = torch.stack([
            gather_dot_plan_plain(a_pad[h], bt_phys[h], plan) if grouped
            else residual_gather_dot_plain(a_pad[h], bt_phys[h], rows, gids,
                                           member)
            for h in range(heads)]) if heads else torch.zeros((0, n))
        res = res if out is None else out.copy_(res)
        return res[0] if one else res
    if dev.type != "cuda":
        raise ValueError(f"gather_dot: unsupported device {dev}")
    if out is None:
        out = torch.empty((heads, n), dtype=torch.float32, device=dev)
    if grouped:
        for name, t in (("tasks", plan.tasks), ("groups", plan.groups),
                        ("items", plan.items)):
            if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"gather_dot: plan.{name} must be "
                                 "gather_plan's, int32, contiguous, on "
                                 "a_pad's device (GatherPlan.to)")
    _gather_launch(a_pad, bt_phys, rows, gids, member, out, plan)
    return out[0] if one else out


#: C entry point of the gather-dot per (A, B) storage pair
_GATHER_ENTRY = {pair: _kernels.gather_dot_entry(*pair)
                 for pair in GATHER_STORAGE}


def _gather_launch(a_pad, bt_phys, rows, gids, member, out, plan):
    """One gather-dot launch on checked CUDA operands: a_pad (H, M+1, K),
    bt_phys (H, C, NG+1, G*kc), out (H, n) (the callers' checks; the
    runner's are made once in ``__init__`` and ``_operands``); the walk
    is ``planned_walk``'s choice at this K."""
    heads, n = out.shape
    C = bt_phys.shape[1]
    kc = a_pad.shape[2] // C
    if n == 0 or heads == 0:
        return
    grouped = planned_walk(plan, a_pad.shape[2])
    vec = _gather_vec(kc, a_pad, bt_phys, a_pad.stride(1), a_pad.stride(0),
                      bt_phys.stride(1), bt_phys.stride(2), bt_phys.stride(0))
    with torch.cuda.device(a_pad.device):
        _kernels.launch(
            _GATHER_ENTRY[(a_pad.dtype, bt_phys.dtype)],
            a_pad.data_ptr(), a_pad.stride(1), a_pad.stride(0),
            bt_phys.data_ptr(), bt_phys.stride(1), bt_phys.stride(2),
            bt_phys.stride(0), rows.data_ptr(), gids.data_ptr(),
            None if member is None else member.data_ptr(),
            plan.tasks.data_ptr() if grouped else None,
            plan.tasks.shape[0] if grouped else 0,
            plan.groups.data_ptr() if grouped else None,
            plan.items.data_ptr() if grouped else None,
            plan.group_rows if grouped else 1, bt_phys.shape[3] // kc,
            out.data_ptr(), out.stride(0), n, heads, C, kc, vec,
            _gather_lanes(vec, kc, C),
            torch.cuda.current_stream().cuda_stream)


def packing_row_order(packed) -> np.ndarray:
    """The rows in a packing's clustered order (its A-row slots, first
    occurrence), then any row it leaves out: rows that share columns come
    together, which is what the row groups of the SpMM's and the
    gather-dot's plans want."""
    slots = np.asarray(packed.a_row_gather, dtype=np.int64)
    slots = slots[slots < packed.m]
    _, first = np.unique(slots, return_index=True)
    slots = slots[np.sort(first)]
    return np.concatenate([slots, np.setdiff1d(np.arange(packed.m), slots)])


def device_bt_phys(bt_pad: torch.Tensor, col_order: torch.Tensor, g: int,
                   ng: int, k_chunks: int = 1) -> torch.Tensor:
    """Grouped/chunked B^T layout (..., C, NG+1, G*Kc) from the padded
    (..., N+1, K) B^T on its device (any leading batch dimensions), as the
    JAX package's ``device_bt_phys``: physical group row j of chunk c holds
    [K-chunk c of col_order[j*G+0], ..., of col_order[j*G+G-1]]; the
    sentinel group row NG is zero.  ``col_order`` (NG*G,) int64 with its
    sentinels clamped to bt_pad's zero row N."""
    k = bt_pad.shape[-1]
    kc = k // k_chunks
    if kc * k_chunks != k:
        raise ValueError(f"K={k} not divisible by k_chunks={k_chunks}")
    lead = bt_pad.shape[:-2]
    arr = bt_pad.index_select(-2, col_order)             # (..., NG*G, K)
    arr = arr.reshape(*lead, ng, g, k_chunks, kc).movedim(-2, -4)
    arr = arr.reshape(*lead, k_chunks, ng, g * kc)
    sent = torch.zeros((*lead, k_chunks, 1, g * kc), dtype=arr.dtype,
                       device=arr.device)
    return torch.cat([arr, sent], dim=-2)


def check_slice(compute_dtype: str, k_chunks: int,
                method: str = "auto") -> None:
    """Raise ValueError for an unknown compute mode or chunk count, and
    NotImplementedError for what the port does not run yet, naming the
    ROADMAP Queue 1 item that brings it."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; one of "
                         f"{COMPUTE_DTYPES}")
    if int(k_chunks) < 1:
        raise ValueError(f"k_chunks={k_chunks} must be >= 1")
    if method == "device":
        raise NotImplementedError(
            "sddmm_tpu_torch does not run method='device' row clustering "
            "yet (ROADMAP Queue 1: 'Device clustering'); use 'auto', "
            "'greedy' or 'batched'")


@dataclasses.dataclass
class _Segment:
    """One (family, bucket) segment of the packed flat vector."""
    offset: int          # start in the flat vector
    n_runs: int
    rows: int            # R, the run height
    lanes: int           # b*128
    a_idx: torch.Tensor  # (n_runs, R) A rows, or (n_runs, R/16) A panels
    gids: torch.Tensor   # (n_runs, b*128/G) grouped-B^T rows

    @property
    def size(self) -> int:
        return self.n_runs * self.rows * self.lanes


def check_device(device) -> torch.device:
    """``device`` as a torch.device: the CPU, or a CUDA card that is
    there.  The port's entry points default to ``"cuda"``; without a card
    that default raises here, and nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available "
                           "(torch.cuda.is_available() is False)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_order(order):
    if order not in ("packed", "csr"):
        raise ValueError(f"unknown order {order!r}")
    return order


def storage_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in the storage ``dtype``, unless autograd will differentiate
    through it (grad mode on and ``x`` requires grad)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return x
    return x.to(dtype)


class _GatherUnique(torch.autograd.Function):
    """``x[..., index]`` where ``index`` repeats no position (a CSR
    order's slots): its backward writes the cotangent at ``index`` into
    zeros (``index_copy_``, a plain scatter), where autograd's backward of
    an index (``index_put_`` with accumulation) sorts the index first."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.size = x.shape[-1]
        return x[..., index]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        out = g.new_zeros(g.shape[:-1] + (ctx.size,))
        return out.index_copy_(out.dim() - 1, index, g), None


def gather_unique(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` for an ``index`` without repeats, differentiable
    by a scatter (``_GatherUnique``)."""
    return _GatherUnique.apply(x, index)


class _HybridFn(torch.autograd.Function):
    """The runner's packed SDDMM of (H, M+1, K) A and (H, C, NG+1, G*kc)
    B^T as an autograd op (B1).  Forward: the storage cast, then one tile
    launch and one gather-dot launch (or the plain route).  Backward:
    ``HybridSDDMM.vjp`` at the saved storage-cast operands, in fp32 in
    every mode: more exact than the JAX package's "tf32" VJP, which rounds
    the cotangent to bf16."""

    @staticmethod
    def forward(ctx, runner, plain, a_panels, a_pad, bt_phys):
        adt, bdt = STORAGE[runner.compute_dtype]
        a_s = a_pad.to(adt).contiguous()
        b_s = bt_phys.to(bdt).contiguous()
        if a_panels is not None:
            a_panels = [x.to(adt) for x in a_panels]
        ctx.save_for_backward(a_s, b_s)
        ctx.runner, ctx.plain = runner, plain
        return runner._flat(a_s, b_s, plain, a_panels)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a_s, b_s = ctx.saved_tensors
        da, dbt = ctx.runner.vjp(a_s, b_s, g, ctx.plain,
                                 *ctx.needs_input_grad[3:5])
        return None, None, None, da, dbt


class HybridSDDMM:
    """Reusable hybrid SDDMM for a fixed sparsity packing, on one device.

    Holds the packed index arrays and the tile kernel's work table on
    ``device`` (the card unless the caller asks for ``"cpu"``, where every
    kernel runs its plain PyTorch version), so a call only ships A and B.
    Output layouts (``order``): ``"packed"``, the flat vector of length
    ``packed.packed_size`` in which non-nnz slots hold garbage; ``"csr"``,
    the values in CSR entry order of the input matrix.  ``order=None``
    means ``default_order``, as in the JAX package.
    """

    def __init__(self, packed: PackedMatrix, compute_dtype: str = "tf32",
                 *, default_order: str = "packed", k_chunks: int = 1,
                 use_pallas: bool = False, a_layout: str = "rows",
                 device="cuda"):
        check_slice(compute_dtype, k_chunks)
        if a_layout not in ("rows", "panels"):
            raise ValueError(f"unknown a_layout {a_layout!r}")
        _check_order(default_order)
        if a_layout == "panels" and packed.cont_panel_off is None:
            raise ValueError("a_layout='panels' needs container topology "
                             "(packed.cont_panel_off)")
        self.device = check_device(device)
        self.packed = packed
        self.compute_dtype = compute_dtype
        self.default_order = default_order
        self.k_chunks = int(k_chunks)
        # accepted for config compatibility: every dense tile goes through
        # the tile kernel either way
        self.use_pallas = bool(use_pallas)
        self.a_layout = a_layout

        def put(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        G = packed.group_size
        if a_layout == "panels":
            # containers span consecutive panels (the DP carve), so run
            # i's A block is panels [pst[i], pst[i] + R/16), clamped to
            # the zero sentinel panel
            first_panel = packed.cont_panel_ids[packed.cont_panel_off[:-1]]
            a_panel_gather = np.where(packed.a_row_gather < packed.m,
                                      packed.a_row_gather, packed.m)
            self._a_panel_gather = put(a_panel_gather)
            sentinel_panel = len(a_panel_gather) // PANEL_ROWS
        self._segments = []
        # the work table's parts: entries, A row ids, B^T group rows
        ents, t_rows, t_gids = [], [], []
        n_rows = n_gids = 0

        def add_blocks(rows, gids, out_base, lanes):
            """n blocks of rows (n, R) A row ids against gids (n, lanes/G),
            written from out_base (n,), rows ``lanes`` apart."""
            nonlocal n_rows, n_gids
            n, R = rows.shape
            ents.append(table_blocks(n_rows + np.arange(n) * R,
                                     n_gids + np.arange(n) * gids.shape[1],
                                     out_base, R, lanes, lanes))
            t_rows.append(rows)
            t_gids.append(gids)
            n_rows += rows.size
            n_gids += gids.size

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
                    n_runs, b * GROUP_LANES // G)
                seg = _Segment(offset, n_runs, R, b * GROUP_LANES,
                               put(a_idx), put(gids))
                self._segments.append(seg)
                if a_layout == "panels":
                    # panel p's row r is a_pad[a_panel_gather[16p + r]],
                    # the sentinel panel's rows the zero row m
                    pr = a_idx[:, :, None] * PANEL_ROWS + np.arange(
                        PANEL_ROWS)
                    rows = np.where(a_idx[:, :, None] < sentinel_panel,
                                    a_panel_gather[np.minimum(
                                        pr, len(a_panel_gather) - 1)],
                                    packed.m).reshape(n_runs, R)
                else:
                    rows = a_idx
                add_blocks(rows, gids,
                           offset + np.arange(n_runs) * R * seg.lanes,
                           seg.lanes)
                offset += seg.size
        self._hub_offset = offset
        if packed.hub_cols:
            add_blocks(np.arange(packed.m)[None],
                       np.arange(packed.hub_cols // G)[None], [offset],
                       packed.hub_cols)
        offset += packed.m * packed.hub_cols
        self._rowslab_offset = offset
        self._rowslab_rows = (put(packed.rowslab_rows)
                              if packed.rowslab_rows is not None else None)
        if packed.rowslab_rows is not None:
            add_blocks(np.asarray(packed.rowslab_rows)[None],
                       np.arange(packed.num_col_groups)[None], [offset],
                       packed.rowslab_width)
        offset += packed.rowslab_nrows * packed.rowslab_width
        #: the tile kernel's work table (``tile_dot.TileTable``)
        self.table = TileTable.build(ents, t_rows, t_gids, G, self.device)
        self._res_offset = offset
        self._res_rows = put(packed.res_rows, torch.int32)
        self._res_gids = put(packed.res_gids, torch.int32)
        # at G = 1 every member is 0: the kernel skips the select
        self._res_member = (put(packed.res_member, torch.int32) if G > 1
                            else None)
        #: the residual gather-dot's plan (``gather_plan``), its rows
        #: grouped in the packing's clustered row order
        self.res_plan = gather_plan(
            packed.res_rows, np.asarray(packed.res_gids, np.int64) * G
            + (np.asarray(packed.res_member) if G > 1 else 0),
            packing_row_order(packed)).to(self.device)
        if offset + len(packed.res_rows) != packed.packed_size:
            raise ValueError(
                f"packing layout mismatch: segments, slabs {offset} + "
                f"residual {len(packed.res_rows)} != packed_size "
                f"{packed.packed_size}")
        self._col_order = put(np.where(packed.col_order < packed.n,
                                       packed.col_order, packed.n))
        self._inv_idx = (put(packed.inv_idx)
                         if packed.inv_idx is not None else None)
        #: the backward's index (``grad_state``), built at the first
        #: backward, and the host seconds that took
        self._grad = None
        self.grad_pattern_seconds = None
        #: the read-pattern route's patterns (``grad_patterns``), built
        #: only when that route is called, and their host seconds
        self._read_grad = None
        self.read_pattern_seconds = None
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

    @functools.cached_property
    def inv_idx32(self) -> torch.Tensor:
        """(nnz,) int32: the packed slot of each CSR entry (the segment
        softmax kernel reads it so)."""
        p = self.packed
        if p.inv_idx is None:
            raise ValueError("light packing (full_metadata=False) has no "
                             "CSR-order metadata; re-pack with full "
                             "metadata")
        if p.packed_size >= 2 ** 31:
            raise ValueError(f"packed_size {p.packed_size} >= 2^31: the "
                             "packed slots do not fit the int32 index the "
                             "segment softmax kernel reads")
        # kept across calls, so not an inference tensor even when a
        # forward under inference_mode makes it: autograd saves it later
        with torch.inference_mode(False):
            return self._inv_idx.to(torch.int32)

    @property
    def packed_cols(self) -> torch.Tensor:
        """(F,) original col id per packed slot (sentinel = n)."""
        return self._packed_cols

    @functools.cached_property
    def is_identity_layout(self) -> bool:
        """True when bt_phys[0] is exactly bt_pad (G=1, C=1, no column
        clustering): only then may a caller pass a plain (N+1, K) B^T."""
        p = self.packed
        return (p.group_size == 1 and self.k_chunks == 1
                and bool(np.array_equal(p.col_order,
                                        np.arange(p.n, dtype=np.int64))))

    def _a_panels(self, a_pad: torch.Tensor) -> torch.Tensor:
        """The JAX package's panel-major A (P+1, 16, K) of a_pad (M+1, K),
        with a zero sentinel panel: the per-segment route's operand."""
        k = a_pad.shape[-1]
        ap = a_pad[self._a_panel_gather].reshape(-1, PANEL_ROWS, k)
        return torch.cat([ap, ap.new_zeros((1, PANEL_ROWS, k))])

    def device_bt(self, bt_pad: torch.Tensor) -> torch.Tensor:
        """Padded B^T (..., N+1, K) on the runner's device -> its grouped,
        chunked layout (..., C, NG+1, G*kc) (a view under the identity
        layout), in the dtype it came in."""
        if self.is_identity_layout:
            return bt_pad.unsqueeze(-3)
        p = self.packed
        return device_bt_phys(bt_pad, self._col_order, p.group_size,
                              p.num_col_groups, self.k_chunks)

    def device_prepare(self, a_pad: torch.Tensor, bt_pad: torch.Tensor):
        """Padded A (M+1, K) and B^T (N+1, K) already on the runner's
        device -> the runner's operands ``(a_pad, bt_phys)``, in the mode's
        storage dtypes (cast once here, not on every call), except where
        autograd will differentiate through an operand: that one keeps its
        dtype, and the runner's autograd op casts it, so that its gradient
        is not rounded to the storage dtype.  ``a_pad`` is the pair
        ``(a_pad, a_panels)`` under ``a_layout="panels"`` (the panels serve
        the per-segment route, ``plain=True``)."""
        adt, bdt = STORAGE[self.compute_dtype]
        a_pad = storage_cast(a_pad, adt)
        a_ops = a_pad
        if self.a_layout == "panels":
            a_ops = (a_pad, self._a_panels(a_pad))
        return a_ops, self.device_bt(storage_cast(bt_pad, bdt))

    def prepare_operands(self, a, b=None, bt=None):
        """numpy A (M, K) and B (K, N), or B^T (N, K) as ``bt`` -> the
        runner's operands on its device (see ``device_prepare``)."""
        a = np.asarray(a, dtype=np.float32)
        bt = (np.asarray(b, dtype=np.float32).T if bt is None
              else np.asarray(bt, dtype=np.float32))

        def pad(x):
            x = torch.as_tensor(np.ascontiguousarray(x), device=self.device)
            return torch.cat([x, x.new_zeros((1, x.shape[1]))])

        return self.device_prepare(pad(a), pad(bt))

    def __call__(self, a, b=None, bt=None, order: str = "csr"):
        """Host convenience: numpy in, CSR order out by default."""
        a_ops, bt_phys = self.prepare_operands(a, b=b, bt=bt)
        return self.run_padded(a_ops, bt_phys, order=order)

    def _check_bt(self, a_pad: torch.Tensor, bt_phys: torch.Tensor) -> int:
        """kc, after checking that bt_phys (..., C, NG+1, G*kc) fits a_pad
        (..., M+1, C*kc) and this packing."""
        p = self.packed
        k, C = a_pad.shape[-1], bt_phys.shape[-3] if bt_phys.dim() >= 3 else 0
        kc = k // C if C else 0
        if (bt_phys.dim() != a_pad.dim() + 1 or kc < 1 or kc * C != k
                or bt_phys.shape[-2:] != (p.num_col_groups + 1,
                                          p.group_size * kc)):
            raise ValueError(f"bt_phys {tuple(bt_phys.shape)} does not fit "
                             f"a_pad {tuple(a_pad.shape)} and this packing "
                             f"(NG={p.num_col_groups}, G={p.group_size})")
        return kc

    def _operands(self, a_ops, bt_phys: torch.Tensor, cast: bool = True):
        """(a_pad, a_panels or None, bt_phys, kc) from run_padded's
        operands, contiguous, in the mode's storage dtypes (or as they
        came, without ``cast``)."""
        if isinstance(a_ops, (tuple, list)):
            # a rows-layout runner given panels operands ignores the
            # relayout, as the JAX runner does
            a_pad = a_ops[0]
            a_panels = a_ops[1] if self.a_layout == "panels" else None
        elif self.a_layout == "panels":
            raise ValueError("a_layout='panels' operands must come from "
                             "prepare_operands/device_prepare (need the "
                             "panel-major A)")
        else:
            a_pad, a_panels = a_ops, None
        if bt_phys.dim() == 2:
            if not self.is_identity_layout:
                raise ValueError(
                    "2-D bt operand requires identity layout; use "
                    "prepare_operands/device_prepare for grouped packing")
            bt_phys = bt_phys[None]
        kc = self._check_bt(a_pad, bt_phys)
        if not cast:
            return a_pad, a_panels, bt_phys, kc
        adt, bdt = STORAGE[self.compute_dtype]
        a_pad = a_pad.to(adt).contiguous()
        bt_phys = bt_phys.to(bdt).contiguous()
        if a_panels is not None:
            a_panels = a_panels.to(adt)
        return a_pad, a_panels, bt_phys, kc

    def tile_calls(self, a_ops, bt_phys: torch.Tensor, flat: torch.Tensor):
        """Yield ``(a, b, out, accumulate)`` for every tile dot of the
        per-segment route of one call, in packed order: ``out`` is a view
        of the flat output ``flat``, and chunk c > 0 adds into it.  The A
        and B^T gathers of the dense segments run here (torch indexing);
        one segment's gathers are live at a time."""
        a_pad, a_panels, bt_phys, kc = self._operands(a_ops, bt_phys)
        yield from self._tile_calls(a_pad, a_panels, bt_phys, kc, flat)

    def _tile_calls(self, a_pad, a_panels, bt_phys, kc, flat):
        C, k = bt_phys.shape[0], a_pad.shape[1]
        p = self.packed
        G = p.group_size

        def chunks(a_blk, b_of_chunk, out):
            for c in range(C):
                yield (a_blk[:, :, c * kc:(c + 1) * kc], b_of_chunk(c), out,
                       c > 0)

        for seg in self._segments:
            if a_panels is not None:
                a_run = a_panels[seg.a_idx].reshape(seg.n_runs, seg.rows, k)
            else:
                a_run = a_pad[seg.a_idx]
            out = flat[seg.offset:seg.offset + seg.size].view(
                seg.n_runs, seg.rows, seg.lanes)
            yield from chunks(
                a_run, lambda c, s=seg: bt_phys[c][s.gids].view(
                    s.n_runs, s.lanes, kc), out)
        if p.hub_cols:
            H = p.hub_cols
            out = flat[self._hub_offset:self._hub_offset + p.m * H].view(
                1, p.m, H)
            yield from chunks(a_pad[None, :p.m], lambda c: bt_phys[
                c, :H // G].reshape(1, H, kc), out)
        if self._rowslab_rows is not None:
            S = p.rowslab_width
            n_hot = p.rowslab_nrows
            out = flat[self._rowslab_offset:
                       self._rowslab_offset + n_hot * S].view(1, n_hot, S)
            a_hot = a_pad[self._rowslab_rows][None]
            yield from chunks(a_hot, lambda c: bt_phys[
                c, :p.num_col_groups].reshape(1, S, kc), out)

    def run_tiles(self, a_ops, bt_phys: torch.Tensor, flat: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
        """The dense tiles (segments and slabs) of one call into ``flat``
        (no autograd):
        one tile-kernel launch over the work table, or with ``plain`` the
        per-segment route's plain versions."""
        a_pad, a_panels, bt_phys, _ = self._operands(a_ops, bt_phys)
        self._tiles(a_pad[None], bt_phys[None], flat[None], plain,
                    None if a_panels is None else [a_panels])
        return flat

    def _tiles(self, a_pad, bt_phys, flat, plain, a_panels=None):
        """a_pad (H, M+1, K), bt_phys (H, C, NG+1, G*kc), flat (H, F)."""
        if not plain:
            tile_table(a_pad, bt_phys, self.table, self.compute_dtype, flat)
            return
        kc = a_pad.shape[-1] // bt_phys.shape[1]
        for h in range(a_pad.shape[0]):
            panels = None
            if self.a_layout == "panels":
                panels = (a_panels[h] if a_panels is not None
                          else self._a_panels(a_pad[h]))
            for a, b, out, accumulate in self._tile_calls(
                    a_pad[h], panels, bt_phys[h], kc, flat[h]):
                tile_dot(a, b, self.compute_dtype, out=out,
                         accumulate=accumulate, plain=True)

    def residual_call(self, a_ops, bt_phys: torch.Tensor):
        """``(a_pad, bt_phys, rows, gids, member)``, the residual
        gather-dot's arguments (its plan is ``res_plan``)."""
        a_pad, _, bt_phys, _ = self._operands(a_ops, bt_phys)
        return (a_pad, bt_phys, self._res_rows, self._res_gids,
                self._res_member)

    def run_padded(self, a_ops, bt_phys: torch.Tensor,
                   order: Optional[str] = None,
                   plain: bool = False) -> torch.Tensor:
        """Compute from operands already in the runner's layout
        (``prepare_operands``/``device_prepare``; a plain (N+1, K) B^T is
        accepted under the identity layout).  ``order`` is ``"packed"`` or
        ``"csr"`` (None: ``default_order``).  On the card a call is one
        tile-kernel launch and, where the packing has a residual, one
        gather-dot launch.  Differentiable in ``a_pad`` and ``bt_phys``
        (the module docstring; under ``a_layout="panels"`` the gradient
        reaches ``a_pad``, the panels get none).

        ``plain=True`` runs the plain PyTorch versions of the kernels on
        any device, the tiles by the per-segment route, and the backward by
        ``tile_table_grad_plain`` and the plain SpMM (``vjp``): the
        reference the kernels are timed against on the card.  It is only
        ever chosen explicitly."""
        order = _check_order(order or self.default_order)
        a_pad, a_panels, bt_phys, _ = self._operands(a_ops, bt_phys,
                                                     cast=False)
        flat = _HybridFn.apply(self, plain,
                               None if a_panels is None else [a_panels],
                               a_pad[None], bt_phys[None])[0]
        return self.to_csr_order(flat) if order == "csr" else flat

    def run_heads(self, a_pad: torch.Tensor, bt_phys: torch.Tensor,
                  order: Optional[str] = None, plain: bool = False
                  ) -> torch.Tensor:
        """A batch of H heads sharing this packing: padded A (H, M+1, K)
        and grouped B^T (H, C, NG+1, G*kc) (``device_bt`` of a (H, N+1, K)
        batch) on the runner's device -> (H, packed_size), or (H, nnz) with
        ``order="csr"`` (None: ``default_order``).  The tiles of all heads
        are one tile-kernel launch with a head stride (the vmapped batch of
        the JAX package), and so is the residual's gather-dot; a backward
        is the same launches for all heads as for one (``vjp``).  ``plain``
        as in ``run_padded``."""
        order = _check_order(order or self.default_order)
        if a_pad.dim() != 3 or a_pad.shape[0] != bt_phys.shape[0]:
            raise ValueError(f"want a_pad (H, M+1, K) and bt_phys (H, C, "
                             f"NG+1, G*kc), got {tuple(a_pad.shape)} and "
                             f"{tuple(bt_phys.shape)}")
        self._check_bt(a_pad, bt_phys)
        flat = _HybridFn.apply(self, plain, None, a_pad, bt_phys)
        return self.to_csr_order(flat) if order == "csr" else flat

    def _flat(self, a_pad, bt_phys, plain, a_panels=None):
        """a_pad (H, M+1, K), bt_phys (H, C, NG+1, G*kc), contiguous in
        the storage dtypes -> the packed (H, F)."""
        heads = a_pad.shape[0]
        flat = torch.empty((heads, self.packed.packed_size),
                           dtype=torch.float32, device=a_pad.device)
        self._tiles(a_pad, bt_phys, flat, plain, a_panels)
        if plain:
            for h in range(heads):
                flat[h, self._res_offset:].copy_(residual_gather_dot_plain(
                    a_pad[h], bt_phys[h], self._res_rows, self._res_gids,
                    self._res_member))
        elif a_pad.device.type == "cuda":
            # the operands were checked by _operands / run_heads, the
            # residual's index arrays and plan when they were made
            _gather_launch(a_pad, bt_phys, self._res_rows, self._res_gids,
                           self._res_member, flat[:, self._res_offset:],
                           self.res_plan)
        else:
            residual_gather_dot(a_pad, bt_phys, self._res_rows,
                                self._res_gids, self._res_member,
                                out=flat[:, self._res_offset:],
                                plan=self.res_plan)
        return flat

    def read_pattern(self):
        """``(rows, lanes, slots)``, int64 numpy, one entry per packed slot:
        the row of ``a_pad`` (``m`` is its zero row) and the lane of the
        grouped B^T (``gid * G + member``; group row NG is the zero one)
        that the forward reads for that slot, taken from what the kernels
        read: the work table (each entry's rows and lanes, its output block)
        and the residual's index arrays.  Garbage slots included; no Python
        loop over blocks."""
        t = self.table
        ent = t.entries.cpu().numpy()
        row_ids = t.row_ids.cpu().numpy().astype(np.int64)
        gids = t.gids.cpu().numpy().astype(np.int64)
        G = t.group_size
        n_rows, n_lanes = ent[:, 1], ent[:, 4]
        count = n_rows * n_lanes
        e = np.repeat(np.arange(len(ent)), count)
        i = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count,
                                                    count)
        r, l = i // n_lanes[e], i % n_lanes[e]
        lane = ent[e, 3] + l
        rows = [row_ids[ent[e, 0] + r]]
        lanes = [gids[ent[e, 2] + lane // G] * G + lane % G]
        slots = [ent[e, 5] + r * ent[e, 6] + l]
        del e, i, r, l, lane
        p = self.packed
        rows.append(np.asarray(p.res_rows, dtype=np.int64))
        lanes.append(np.asarray(p.res_gids, dtype=np.int64) * G + (
            np.asarray(p.res_member, dtype=np.int64) if G > 1 else 0))
        slots.append(self._res_offset + np.arange(len(p.res_rows),
                                                  dtype=np.int64))
        rows, lanes, slots = (np.concatenate(x) for x in (rows, lanes,
                                                           slots))
        if len(slots) != p.packed_size or not (np.bincount(
                slots, minlength=p.packed_size) == 1).all():
            raise ValueError("read_pattern: the work table and the residual "
                             "do not cover every packed slot once")
        return rows, lanes, slots

    def _spmm_patterns(self, rows, lanes, slots):
        """The two SpMM patterns of (row, lane, slot) entries: ``P`` (rows
        of ``a_pad``, entries at lanes) for dA and ``P^T`` for dB^T_phys,
        their plans built too on the card.  The zero rows' gradients
        (``a_pad`` row m, group row NG) are left at 0: they are the pads',
        which ``torch.cat`` and ``device_bt`` discard."""
        # ops.spmm imports this module
        from sddmm_tpu_torch.ops.spmm import SpmmPattern
        p = self.packed
        lanes_real = p.num_col_groups * p.group_size
        keep = rows < p.m
        pa = SpmmPattern(rows[keep], lanes[keep], p.m + 1, self.device,
                         entries=slots[keep])
        keep = lanes < lanes_real
        pb = SpmmPattern(lanes[keep], rows[keep], lanes_real + p.group_size,
                         self.device, entries=slots[keep])
        if self.device.type == "cuda":
            pa.plan()
            pb.plan()
        return pa, pb

    def grad_state(self):
        """The backward's index, built at the first call
        (``grad_pattern_seconds`` records its host time) and kept: the work
        table's units and reduction (``TileTable.grad_index``, the pads'
        rows dropped) and the residual's two SpMM patterns (None without a
        residual).  Its cost grows with the table's entries and the
        residual, not with the packed slots."""
        if self._grad is None:
            t0 = time.perf_counter()
            p = self.packed
            G = p.group_size
            idx = self.table.grad_index(p.m + 1, (p.num_col_groups + 1) * G,
                                        p.m, p.num_col_groups * G)
            res = None
            if len(p.res_rows):
                res = self._spmm_patterns(
                    np.asarray(p.res_rows, dtype=np.int64),
                    np.asarray(p.res_gids, dtype=np.int64) * G + (
                        np.asarray(p.res_member, dtype=np.int64) if G > 1
                        else 0),
                    self._res_offset + np.arange(len(p.res_rows),
                                                 dtype=np.int64))
            self.grad_pattern_seconds = time.perf_counter() - t0
            self._grad = (idx, res)
        return self._grad

    def vjp(self, a_pad: torch.Tensor, bt_phys: torch.Tensor,
            g: torch.Tensor, plain: bool = False, need_a: bool = True,
            need_b: bool = True):
        """The backward of one call (B1): (dA (H, M+1, K), dB^T_phys (H, C,
        NG+1, G*kc)) fp32 of the packed cotangent g (H, F) at the operands
        (H, M+1, K) and (H, C, NG+1, G*kc), contiguous, as the forward read
        them (storage dtypes); None for what is not needed.  The residual's
        entries first, one SpMM launch each for dA and dB^T on the card
        (none without a residual), then the dense tiles' share added by
        ``tile_table_grad``: two launches, all heads and chunks (chunk c
        writes dA's columns c*kc.., or reads A's).  So a backward is 2
        launches, or 4 with a residual, at any H and C.  ``plain`` (or the
        CPU) takes ``tile_table_grad_plain`` and ``csr_spmm_plain``.  The
        pads' rows (``a_pad`` row m, group row NG) stay 0."""
        _, res = self.grad_state()
        H, C, ng1, gk = bt_phys.shape
        m1, K = a_pad.shape[1:]
        kc = K // C
        lanes = ng1 * (gk // kc)
        g = g.to(torch.float32).contiguous()
        a32 = a_pad.to(torch.float32).contiguous()
        b32 = bt_phys.to(torch.float32).contiguous()
        da = dbt = None
        if need_a:
            da = torch.empty((H, m1, K), dtype=torch.float32,
                             device=g.device)
        if need_b:
            dbt = torch.empty((H, C, ng1, gk), dtype=torch.float32,
                              device=g.device)
        if res is not None:
            pa, pb = res
            if need_a:
                pa(g, b32.view(H, C, lanes, kc),
                   da.view(H, m1, C, kc).transpose(1, 2), plain)
            if need_b:
                pb(g, a32.view(H, m1, C, kc).transpose(1, 2),
                   dbt.view(H, C, lanes, kc), plain)
        p = self.packed
        grad = tile_table_grad_plain if plain else tile_table_grad
        grad(a32, b32, g, self.table, da, dbt, accumulate=res is not None,
             real_rows=p.m, real_lanes=p.num_col_groups * p.group_size)
        return da, dbt

    def grad_patterns(self):
        """The read-pattern route's two SpMM patterns over the read pattern
        of every packed slot (``_spmm_patterns``), built at the first call
        (``read_pattern_seconds``) and kept.  The backward does not use
        them; ``vjp_read_pattern`` does."""
        if self._read_grad is None:
            t0 = time.perf_counter()
            self._read_grad = self._spmm_patterns(*self.read_pattern())
            self.read_pattern_seconds = time.perf_counter() - t0
        return self._read_grad

    def vjp_read_pattern(self, a_pad: torch.Tensor, bt_phys: torch.Tensor,
                         g: torch.Tensor):
        """``vjp`` by the read-pattern route, kept as a yardstick: one SpMM
        launch each for dA and dB^T over the read pattern
        (``grad_patterns``), or ``csr_spmm_plain`` per head and chunk on the
        CPU."""
        pa, pb = self.grad_patterns()
        H, C, ng1, gk = bt_phys.shape
        m1, K = a_pad.shape[1:]
        kc = K // C
        lanes = ng1 * (gk // kc)
        g = g.to(torch.float32).contiguous()
        da = torch.empty((H, m1, K), dtype=torch.float32, device=g.device)
        pa(g, bt_phys.to(torch.float32).view(H, C, lanes, kc),
           da.view(H, m1, C, kc).transpose(1, 2))
        dbt = torch.empty((H, C, ng1, gk), dtype=torch.float32,
                          device=g.device)
        pb(g, a_pad.to(torch.float32).view(H, m1, C, kc).transpose(1, 2),
           dbt.view(H, C, lanes, kc))
        return da, dbt

    def to_csr_order(self, flat: torch.Tensor) -> torch.Tensor:
        """Packed-order flat vector (..., F) -> CSR entry order: one
        gather (whose backward is one scatter: ``gather_unique``)."""
        if self._inv_idx is None:
            raise ValueError("light packing (full_metadata=False) has no "
                             "CSR-order metadata; re-pack with full "
                             "metadata")
        return gather_unique(flat, self._inv_idx)

    @staticmethod
    def from_csr(csr: CSR, alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA,
                 compute_dtype: str = "tf32", method: str = "auto",
                 device="cuda") -> "HybridSDDMM":
        check_slice(compute_dtype, 1, method)
        bsmr = BSMR(alpha, delta, csr, method=method)
        return HybridSDDMM(pack(csr, bsmr), compute_dtype=compute_dtype,
                           device=device)


def sddmm_hybrid(a, b, packed: PackedMatrix, compute_dtype: str = "tf32",
                 device="cuda") -> np.ndarray:
    """One-shot host convenience wrapper (numpy in, numpy out, CSR
    order)."""
    runner = HybridSDDMM(packed, compute_dtype=compute_dtype, device=device)
    return runner(a, b).cpu().numpy()
