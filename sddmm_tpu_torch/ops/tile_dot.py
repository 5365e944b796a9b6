"""The tile kernel in the five compute modes: the port of the Pallas
tile-dot kernel, and of the XLA gathers and dots around it.

Counterpart of ``sddmm_tpu/ops/pallas_tiles.py`` (``_tile_dot_kernel``,
``tile_dot_tf32``, ``tile_dot_padded``), of the dot products of
``sddmm_tpu/ops/hybrid.py`` (``_dot3``, the ``"mixed"`` branch,
``Precision.HIGH``/``HIGHEST``) and ``sddmm_tpu/ops/dense.py``, and of the
A/B^T takes that feed them: ``(R, K) x (L, K) -> (R, L)`` blocks,
accumulated in fp32.  Each mode stores its operands in the JAX package's
storage types (``STORAGE``) and splits each value into bfloat16 planes
(``split_bf16``) before the bf16 products (``MODES``):

- ``"tf32"``: fp32, ``ah.bh + ah.bl + al.bh`` on the hi/lo split of both
  operands, about 16 mantissa bits (XLA's ``Precision.HIGH``), far more
  than NVIDIA TF32's 10;
- ``"mixed"``: fp32 A split hi/lo times bf16 B, two products;
- ``"float16"``: fp16 storage, upcast exactly, then as ``"tf32"``;
- ``"bfloat16"``: one native bf16 product;
- ``"float32"``: the six products of a hi/mid/lo split of both operands
  (those whose plane orders sum to at most 2), the scheme of XLA's
  ``Precision.HIGHEST`` on the TPU: within about one fp32 rounding of the
  exact product, on the same tensor-core kernel as the other modes.

The kernel (``csrc/tile_dot.cu``, one instance per mode) walks a work
table (``TileTable``): one entry per output block of at most
``ROW_WINDOW`` A rows by ``LANE_WINDOW`` B^T lanes, naming where its rows
come from (row ids into a padded A), where its lanes come from (group rows
of a grouped, chunked B^T, with the group size G and the chunk width kc)
and where its block goes in a flat output.  ``tile_table`` runs one table
in one launch, over any number of heads; the hybrid runner, the dense class
and ``tile_dot`` all call it.  ``tile_table_plain`` is the same indexing
in PyTorch ops (per entry: gather the rows and lanes, ``tile_dot_plain``),
the CPU path.

The table's backward (B1's dense tiles, the VJP of the JAX runner's
tile dots) is ``tile_table_grad``: every entry's cotangent block reaches
its A rows (``dA += dO . B^T lanes``) and its B^T lanes (``dB^T += dO^T .
A rows``), on the card one launch of ``csrc/tile_grad.cu`` over units of
entries that share their rows or their lanes (``TileTable.grad_index``,
built at the first backward and kept) into per-unit partials, and one
launch that adds each row's partials in a fixed order.
``tile_table_grad_plain`` is the same sums in PyTorch ops, the CPU path.

``tile_dot`` is the batched tile dot ``(nT, R, K) x (nT, L, K) -> (nT, R,
L)`` over strided operands (A and B rows at any 16-byte row stride, so a K
chunk is a column view) into an output view with any strides, e.g. a slab
of a flat vector, with ``accumulate``; on the card it is a table of the
identity rows and lanes.  Any K: the kernel steps K by 16, so the wrappers
zero-pad copies of the operands along K (each chunk, for C > 1) where K is
off that step (zero planes add exact zeros).  ``tile_dot_plain`` is the
mode's math in PyTorch ops on the unpadded operands, the CPU path and the
kernels' reference on the card.
"""


from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from sddmm_tpu_torch import _kernels

_HL = ((0, 0), (0, 1), (1, 0))
#: mode -> (A storage, B storage, A planes, B planes, (A plane, B plane)
#: of each product, in the kernel's order).  The tensor cores truncate each
#: product's sum toward zero: "float32" on the card comes out short by
#: about 4e-8 of itself, which the tile kernel leaves and the projection GEMM
#: (``ops/project.py``) cancels on average, a step the plain versions do
#: not model
MODES = {
    "tf32": (torch.float32, torch.float32, 2, 2, _HL),
    "mixed": (torch.float32, torch.bfloat16, 2, 1, ((0, 0), (1, 0))),
    "float16": (torch.float16, torch.float16, 2, 2, _HL),
    "bfloat16": (torch.bfloat16, torch.bfloat16, 1, 1, ((0, 0),)),
    "float32": (torch.float32, torch.float32, 3, 3,
                ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))),
}
#: mode -> (A storage dtype, B storage dtype), as the JAX package's _STORAGE
STORAGE = {mode: spec[:2] for mode, spec in MODES.items()}
_ALIGN = 16  # bytes: the kernel copies A and B rows in 16-byte pieces
K_STEP = 16  # the kernel's k step: K is padded up to a multiple of it
ROW_WINDOW = 64     # A rows of one table entry (the kernel's kRows)
LANE_WINDOW = 128   # B^T lanes of one table entry (the kernel's kLanes)
#: int64 words of a table entry: [row_off, nrows, gid_off, lane0, nlanes,
#: out_off, out_rs, 0]
ENTRY_WORDS = 8
#: table entries a backward unit walks at most (``TileTable.grad_index``):
#: a long walk (the hub slab's row windows against one lane window) is cut
#: into parts that run side by side
GRAD_PART = 8
#: int64 words of a backward unit: [walk start, entries, partial row, 0]
UNIT_WORDS = 4


def split_bf16(x: torch.Tensor, planes: int) -> list:
    """x -> ``planes`` bfloat16 planes (round to nearest even) whose fp32
    sum carries x: hi, then hi/lo (``pallas_tiles._split_hi_lo``), then
    hi/mid/lo.  fp16 and bf16 inputs upcast exactly first."""
    rest = x.to(torch.float32)
    out = []
    for i in range(planes):
        p = rest.to(torch.bfloat16)
        out.append(p)
        if i + 1 < planes:
            rest = rest - p.to(torch.float32)
    return out


def split_probe(rng, shape) -> torch.Tensor:
    """fp32 values ``s * (1 + 2^-9 + 2^-18)``, s in [1, 2) with 4 fraction
    bits: exact in fp32, with hi/mid/lo bf16 planes exactly s, s*2^-9 and
    s*2^-18.  On a product of two of them the "tf32" split drops the mid x
    mid and both hi x lo products, 3*2^-18 (1.1e-5) of it, while "float32"
    keeps them and drops only about 2^-26: operands that tell the two
    instances apart, where U[0,2) data leaves them within a few 1e-6."""
    s = 1.0 + rng.integers(0, 16, shape) / 16.0
    return torch.tensor(s * (1.0 + 2.0 ** -9 + 2.0 ** -18),
                        dtype=torch.float32)


@contextlib.contextmanager
def full_fp32_matmul():
    """Run matmuls in full fp32: TF32 (10-bit) would spoil a reference on
    the card.  Restores the caller's settings on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def tile_dot_plain(a: torch.Tensor, b: torch.Tensor,
                   mode: str = "tf32") -> torch.Tensor:
    """Plain PyTorch version of ``mode``'s instance: the planes split in
    torch, each product on exact fp32 upcasts (a bf16 x bf16 product is
    exact in fp32) with TF32 off, summed in the kernel's order."""
    _, _, pa, pb, products = MODES[mode]
    ap, bp = split_bf16(a, pa), split_bf16(b, pb)
    out = None
    with full_fp32_matmul():
        for i, j in products:
            d = torch.bmm(ap[i].to(torch.float32),
                          bp[j].to(torch.float32).transpose(1, 2))
            out = d if out is None else out + d
    return out


def _check(a, b, mode, out, accumulate):
    if mode not in MODES:
        raise ValueError(f"tile_dot: unknown mode {mode!r}")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"tile_dot: want 3-D a and b, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    nT, R, K = a.shape
    if b.shape[0] != nT or b.shape[2] != K:
        raise ValueError(f"tile_dot: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree on nT or K")
    L = b.shape[1]
    if R < 1 or L < 1 or K < 1:
        raise ValueError(f"tile_dot: R={R}, L={L} and K={K} must be >= 1")
    adt, bdt = STORAGE[mode]
    tensors = [("a", a, adt), ("b", b, bdt)]
    if out is not None:
        tensors.append(("out", out, torch.float32))
        if tuple(out.shape) != (nT, R, L):
            raise ValueError(f"tile_dot: out {tuple(out.shape)} != "
                             f"{(nT, R, L)}")
    elif accumulate:
        raise ValueError("tile_dot: accumulate needs out")
    for name, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"tile_dot[{mode}]: {name} is {t.dtype}, want "
                            f"{dt}")
        if t.device != a.device:
            raise ValueError(f"tile_dot: {name} is on {t.device}, a on "
                             f"{a.device}")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"tile_dot: {name}'s last dimension is not "
                             "contiguous")
    # operands of a K that is not a multiple of K_STEP are copied (padded)
    # before a launch, so only the others must have aligned rows
    for name, t in (("a", a), ("b", b)) if K % K_STEP == 0 else ():
        size = t.element_size()
        if (t.data_ptr() % _ALIGN
                or (t.shape[1] > 1 and t.stride(1) * size % _ALIGN)
                or (t.shape[0] > 1 and t.stride(0) * size % _ALIGN)):
            raise ValueError(f"tile_dot: {name}'s rows are not "
                             f"{_ALIGN}-byte aligned (strides "
                             f"{t.stride()})")
    return nT, R, L, K


def pad_k(x: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """A contiguous copy of x (.., chunks * kc) with each of its ``chunks``
    column chunks zero-padded from kc up to the next multiple of
    ``K_STEP``: the kernel's operand for a chunk width off its step."""
    kc = x.shape[-1] // chunks
    x = x.reshape(*x.shape[:-1], chunks, kc)
    x = torch.nn.functional.pad(x, (0, -kc % K_STEP))
    return x.reshape(*x.shape[:-2], -1)


def table_blocks(row_base, gid_base, out_base, rows: int, lanes: int,
                 out_rs: int) -> np.ndarray:
    """Table entries of n output blocks of ``rows`` A rows by ``lanes`` B^T
    lanes, cut into windows of ``ROW_WINDOW`` x ``LANE_WINDOW``.  Block i's
    A row ids start at ``row_base[i]`` of the table's ``row_ids``, its
    lane-group rows at ``gid_base[i]`` of ``gids`` (lane l is group
    ``l // G``, member ``l % G``), and its (rows, lanes) output at
    ``out_base[i]`` of the flat output, rows ``out_rs`` apart.  Returns
    (n * windows, ``ENTRY_WORDS``) int64, block by block, row window by row
    window."""
    row_base, gid_base, out_base = (np.asarray(x, dtype=np.int64).ravel()
                                    for x in (row_base, gid_base, out_base))
    r0 = np.arange(0, rows, ROW_WINDOW, dtype=np.int64)
    l0 = np.arange(0, lanes, LANE_WINDOW, dtype=np.int64)
    blk, rr, ll = (x.ravel() for x in np.meshgrid(
        np.arange(len(row_base)), r0, l0, indexing="ij"))
    ent = np.zeros((len(blk), ENTRY_WORDS), dtype=np.int64)
    ent[:, 0] = row_base[blk] + rr
    ent[:, 1] = np.minimum(ROW_WINDOW, rows - rr)
    ent[:, 2] = gid_base[blk]
    ent[:, 3] = ll
    ent[:, 4] = np.minimum(LANE_WINDOW, lanes - ll)
    ent[:, 5] = out_base[blk] + rr * out_rs + ll
    ent[:, 6] = out_rs
    return ent


@dataclasses.dataclass
class GradIndex:
    """The backward's walk of a work table (``TileTable.grad_index``), on
    the table's device.  ``units`` (U, ``UNIT_WORDS``) int64: the first
    ``n_units_a`` are dA units (entries that share their A rows: the lane
    windows of one row window), the others dB^T units (entries that share
    their lanes: the row windows of one lane window); each walks
    ``units[u, 1]`` <= ``GRAD_PART`` entry ids of ``walk`` (int32, from
    ``units[u, 0]``, in table order) and writes its partial, its entries'
    rows (or lanes) by K, from workspace row ``units[u, 2]``; ``partials``
    workspace rows in all.  The reduction: output row t (A rows
    0..n_a-1, then the B^T lanes, ``n_targets`` in all) adds the workspace
    rows ``src[tptr[t]:tptr[t+1]]`` (int32) in that order, the units'
    order; a row past the real rows or lanes gets none (the pads' rows are
    left at 0)."""
    units: torch.Tensor
    n_units_a: int
    walk: torch.Tensor
    partials: int
    tptr: torch.Tensor
    src: torch.Tensor
    n_a: int
    n_targets: int


def _walks(keys: np.ndarray):
    """Units over table entries with equal rows of ``keys`` (E, k):
    (entry ids in walk order, unit starts, unit counts); a group keeps the
    table's order and is cut into parts of at most ``GRAD_PART``."""
    n = len(keys)
    order = np.lexsort(keys.T[::-1])           # stable
    sk = keys[order]
    new = np.ones(n, dtype=bool)
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    first = np.flatnonzero(new)
    pos = np.arange(n) - np.repeat(first, np.diff(np.append(first, n)))
    starts = np.flatnonzero(new | (pos % GRAD_PART == 0))
    return order, starts, np.diff(np.append(starts, n))


def _expand(n: np.ndarray):
    """(unit, index within the unit) of every partial row of units of
    ``n`` rows each."""
    unit = np.repeat(np.arange(len(n)), n)
    return unit, np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)


@dataclasses.dataclass
class TileTable:
    """The tile kernel's work table: ``entries`` (E, ``ENTRY_WORDS``) int64
    (see ``table_blocks``), the int32 A row ids and B^T group rows they
    index, the lane group size G, and the bounds the wrapper checks
    operands against: the largest row id and group row, and the flat
    output length the entries reach."""
    entries: torch.Tensor
    row_ids: torch.Tensor
    gids: torch.Tensor
    group_size: int
    max_row: int
    max_gid: int
    out_extent: int
    _grad: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def grad_index(self, rows: int, lanes: int, real_rows=None,
                   real_lanes=None) -> GradIndex:
        """The backward's units and reduction (``GradIndex``) for operands
        of ``rows`` A rows and ``lanes`` B^T lanes (NB * G), the partials
        of rows at or past ``real_rows`` and lanes at or past
        ``real_lanes`` dropped (None: keep all).  Built at the first call
        from the entries (numpy over entries and their rows, never over
        slots) and kept."""
        real_rows = rows if real_rows is None else int(real_rows)
        real_lanes = lanes if real_lanes is None else int(real_lanes)
        key = (int(rows), int(lanes), real_rows, real_lanes)
        if key in self._grad:
            return self._grad[key]
        ent = self.entries.cpu().numpy()
        row_ids = self.row_ids.cpu().numpy().astype(np.int64)
        gids = self.gids.cpu().numpy().astype(np.int64)
        G = self.group_size
        walk_a, st_a, cnt_a = _walks(ent[:, [0, 1]])
        walk_b, st_b, cnt_b = _walks(ent[:, [2, 3, 4]])
        first_a, first_b = ent[walk_a[st_a]], ent[walk_b[st_b]]
        n_rows, n_lanes = first_a[:, 1], first_b[:, 4]
        off_a = np.concatenate([[0], np.cumsum(n_rows)]).astype(np.int64)
        off_b = off_a[-1] + np.concatenate([[0], np.cumsum(n_lanes)]).astype(
            np.int64)
        units = np.zeros((len(st_a) + len(st_b), UNIT_WORDS), dtype=np.int64)
        units[:, 0] = np.concatenate([st_a, len(ent) + st_b])
        units[:, 1] = np.concatenate([cnt_a, cnt_b])
        units[:, 2] = np.concatenate([off_a[:-1], off_b[:-1]])
        u, r = _expand(n_rows)
        tgt_a = row_ids[first_a[u, 0] + r]
        src_a = off_a[u] + r
        keep_a = tgt_a < real_rows
        u, l = _expand(n_lanes)
        lane = first_b[u, 3] + l
        tgt_b = gids[first_b[u, 2] + lane // G] * G + lane % G
        src_b = off_b[u] + l
        keep_b = tgt_b < real_lanes
        tgt = np.concatenate([tgt_a[keep_a], rows + tgt_b[keep_b]])
        src = np.concatenate([src_a[keep_a], src_b[keep_b]])
        order = np.argsort(tgt, kind="stable")
        tptr = np.searchsorted(tgt[order], np.arange(rows + lanes + 1))
        if off_b[-1] >= 2 ** 31:
            raise ValueError(f"grad_index: {off_b[-1]} partial rows do not "
                             "fit the int32 index the reduction reads")
        dev = self.entries.device

        def put(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype),
                                   device=dev)

        idx = GradIndex(put(units, np.int64), len(st_a),
                        put(np.concatenate([walk_a, walk_b]), np.int32),
                        int(off_b[-1]), put(tptr, np.int64),
                        put(src[order], np.int32), int(rows),
                        int(rows + lanes))
        self._grad[key] = idx
        return idx

    @staticmethod
    def build(entries, row_ids, gids, group_size: int, device) -> "TileTable":
        """From numpy parts (lists are concatenated) onto ``device``."""
        def cat(x, dtype):
            parts = x if isinstance(x, (list, tuple)) else [x]
            return np.concatenate([np.zeros(0, dtype)] + [
                np.asarray(v, dtype=dtype).ravel() for v in parts])

        ent = cat(entries, np.int64).reshape(-1, ENTRY_WORDS)
        rows, gids = cat(row_ids, np.int32), cat(gids, np.int32)
        extent = int((ent[:, 5] + (ent[:, 1] - 1) * ent[:, 6]
                      + ent[:, 4]).max()) if len(ent) else 0

        def put(x):
            return torch.as_tensor(x, device=device)

        return TileTable(put(ent), put(rows), put(gids), int(group_size),
                         int(rows.max()) if len(rows) else -1,
                         int(gids.max()) if len(gids) else -1, extent)

    @property
    def n_entries(self) -> int:
        return self.entries.shape[0]


def head_shift(heads: int, kv_heads: int) -> int:
    """log2 of the query heads a key head serves (grouped-query attention:
    query head h reads key head ``h >> shift``); 0 where every head has its
    own.  ``heads`` must be a power-of-two multiple of ``kv_heads``."""
    group = heads // kv_heads if kv_heads else 0
    if kv_heads < 1 or group * kv_heads != heads or group & (group - 1):
        raise ValueError(f"{heads} query heads over {kv_heads} key heads: "
                         "want a power-of-two group")
    return group.bit_length() - 1


def tile_table_plain(a: torch.Tensor, b: torch.Tensor, table: TileTable,
                     mode: str, out: torch.Tensor, accumulate: bool = False,
                     batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``tile_table``: per head, for ``batch``
    entries at a time, gather each entry's A rows and B^T lanes through the
    table, take ``tile_dot_plain`` per chunk, sum the chunks in the order
    c = 0..C-1, and write (or add) the cells inside each entry's
    (nrows, nlanes) to its place in ``out``.  Head h reads the B^T of head
    ``h >> head_shift``."""
    H, C = a.shape[0], b.shape[1]
    shift = head_shift(H, b.shape[0])
    G = table.group_size
    kc = b.shape[3] // G
    dev = a.device
    ent = table.entries.to(dev)
    row_ids, gids = table.row_ids.to(dev).long(), table.gids.to(dev).long()
    rr = torch.arange(ROW_WINDOW, device=dev)
    ll = torch.arange(LANE_WINDOW, device=dev)
    for s in range(0, ent.shape[0], batch):
        e = ent[s:s + batch]
        rmask = rr[None] < e[:, 1:2]                       # (n, 64)
        lmask = ll[None] < e[:, 4:5]                       # (n, 128)
        rows = row_ids[torch.where(rmask, e[:, 0:1] + rr, 0)]
        lane = e[:, 3:4] + ll
        grp = gids[torch.where(lmask, e[:, 2:3] + lane // G, 0)]
        member = (lane % G)[:, :, None, None].expand(-1, -1, 1, kc)
        pos = (e[:, 5, None, None] + rr[None, :, None] * e[:, 6, None, None]
               + ll[None, None, :])
        keep = rmask[:, :, None] & lmask[:, None, :]
        for h in range(H):
            a_blk = a[h][rows]                             # (n, 64, C*kc)
            tot = torch.zeros((e.shape[0], ROW_WINDOW, LANE_WINDOW),
                              dtype=torch.float32, device=dev)
            for c in range(C):
                b_blk = b[h >> shift, c][grp].reshape(e.shape[0],
                                                      LANE_WINDOW, G, kc)
                b_blk = torch.take_along_dim(b_blk, member, dim=2)[:, :, 0]
                tot = tot + tile_dot_plain(
                    a_blk[:, :, c * kc:(c + 1) * kc], b_blk, mode)
            o = out[h]
            if accumulate:
                o[pos[keep]] += tot[keep]
            else:
                o[pos[keep]] = tot[keep]
    return out


def _check_table(a, b, table, mode, out):
    if mode not in MODES:
        raise ValueError(f"tile_table: unknown mode {mode!r}")
    if a.dim() != 3 or b.dim() != 4 or out.dim() != 2:
        raise ValueError(f"tile_table: want a (H, M, C*kc), b (H, C, NB, "
                         f"G*kc) and out (H, F), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)} and {tuple(out.shape)}")
    _, C, nb, gk = b.shape
    H = a.shape[0]
    G = table.group_size
    kc = gk // G if G else 0
    if (out.shape[0] != H or C < 1 or kc < 1
            or kc * G != gk or a.shape[2] != C * kc):
        raise ValueError(f"tile_table: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} and out {tuple(out.shape)} "
                         f"disagree on heads, C or kc (G={G})")
    head_shift(H, b.shape[0])
    if table.max_row >= a.shape[1] or table.max_gid >= nb:
        raise ValueError(f"tile_table: the table indexes row {table.max_row}"
                         f" of {a.shape[1]} and group row {table.max_gid} "
                         f"of {nb}")
    if table.out_extent > out.shape[1]:
        raise ValueError(f"tile_table: the table writes {table.out_extent} "
                         f"slots, out has {out.shape[1]}")
    adt, bdt = STORAGE[mode]
    for name, t, dt in (("a", a, adt), ("b", b, bdt),
                        ("out", out, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"tile_table[{mode}]: {name} is {t.dtype}, want "
                            f"{dt}")
        if t.device != a.device:
            raise ValueError(f"tile_table: {name} is on {t.device}, a on "
                             f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous() and out.stride(1) == 1):
        raise ValueError("tile_table: a and b must be contiguous and out's "
                         "rows contiguous")
    return H, C, kc


def tile_table(a: torch.Tensor, b: torch.Tensor, table: TileTable,
               mode: str, out: torch.Tensor,
               accumulate: bool = False) -> torch.Tensor:
    """Every entry of ``table`` in compute mode ``mode``, for every head:
    ``out[h, slot] (+)= sum_c dot(A row, B^T lane)`` over the chunks.

    a (H, M, C*kc) padded A rows in the mode's A storage, b (Hkv, C, NB,
    G*kc) the grouped, chunked B^T in its B storage (G = the table's group
    size; head h reads b's head ``h >> head_shift(H, Hkv)``, Hkv = H but
    for grouped-query attention), out (H, F) fp32 with contiguous rows;
    a and b contiguous, on one device.  CUDA tensors go through one launch of the mode's kernel
    instance (``csrc/tile_dot.cu``) or raise; CPU tensors through
    ``tile_table_plain``.  A kc off ``K_STEP`` is zero-padded (a copy of
    each operand) before the launch."""
    H, C, kc = _check_table(a, b, table, mode, out)
    if a.device.type == "cpu":
        return tile_table_plain(a, b, table, mode, out, accumulate)
    if a.device.type != "cuda":
        raise ValueError(f"tile_table: unsupported device {a.device}")
    if table.n_entries == 0:
        return out
    if table.entries.device != a.device:
        raise ValueError(f"tile_table: the table is on "
                         f"{table.entries.device}, a on {a.device}")
    G = table.group_size
    if kc % K_STEP:
        a = pad_k(a, C)
        b = pad_k(b.reshape(*b.shape[:3], G, kc), 1).reshape(
            *b.shape[:3], -1)
        kc = b.shape[3] // G
    _launch(mode, a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), b.stride(2), table,
            out, out.stride(0), H, C, kc, accumulate,
            head_shift(H, b.shape[0]))
    return out


def _launch(mode, a_ptr, sa_h, sa_r, b_ptr, sb_h, sb_c, sb_r, table, out,
            so_h, heads, C, kc, accumulate, kv_shift=0):
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(f"sddmm_tile_dot_{mode}", a_ptr, sa_h, sa_r,
                        b_ptr, sb_h, sb_c, sb_r, table.entries.data_ptr(),
                        table.n_entries, table.row_ids.data_ptr(),
                        table.gids.data_ptr(), out.data_ptr(), so_h, heads,
                        C, kc, table.group_size, kv_shift, int(accumulate),
                        stream)


def tile_table_grad_plain(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                          table: TileTable, da=None, dbt=None,
                          accumulate: bool = False, real_rows=None,
                          real_lanes=None):
    """Plain PyTorch version of ``tile_table_grad``: per head, for 64
    entries at a time, gather each entry's cotangent block (zero
    outside its (nrows, nlanes)), A rows and B^T lanes (the chunks side by
    side, as A's columns), take the fp32 products dO . B^T lanes and dO^T
    . A rows, and add them into the rows and lanes with ``index_add_``,
    entry by entry (a fixed order on the CPU).  Rows at or past
    ``real_rows`` and lanes at or past ``real_lanes`` get nothing.  Head h
    reads, and adds its lanes' gradient to, key head ``h >> head_shift``."""
    H = a.shape[0]
    shift = head_shift(H, b.shape[0])
    C, nb = b.shape[1:3]
    G = table.group_size
    kc = b.shape[3] // G
    dev = a.device
    real_rows = a.shape[1] if real_rows is None else real_rows
    real_lanes = nb * G if real_lanes is None else real_lanes
    for out in (da, dbt):
        if out is not None and not accumulate:
            out.zero_()
    dbt_l = None if dbt is None else dbt.view(-1, C, nb * G, kc)
    ent = table.entries.to(dev)
    row_ids, gids = table.row_ids.to(dev).long(), table.gids.to(dev).long()
    rr = torch.arange(ROW_WINDOW, device=dev)
    ll = torch.arange(LANE_WINDOW, device=dev)
    batch = 64
    for s in range(0, ent.shape[0], batch):
        e = ent[s:s + batch]
        n = e.shape[0]
        rmask = rr[None] < e[:, 1:2]                       # (n, 64)
        lmask = ll[None] < e[:, 4:5]                       # (n, 128)
        rows = row_ids[torch.where(rmask, e[:, 0:1] + rr, 0)]
        lane = e[:, 3:4] + ll
        grp = gids[torch.where(lmask, e[:, 2:3] + lane // G, 0)]
        member = (lane % G)[:, :, None, None].expand(-1, -1, 1, kc)
        keep = rmask[:, :, None] & lmask[:, None, :]
        pos = torch.where(keep, e[:, 5, None, None] + rr[None, :, None]
                          * e[:, 6, None, None] + ll[None, None, :], 0)
        to_a = rmask & (rows < real_rows)
        tgt_lane = grp * G + lane % G
        to_b = lmask & (tgt_lane < real_lanes)
        for h in range(H):
            d = torch.where(keep, g[h][pos].to(torch.float32), 0.0)
            b_blk = torch.cat([torch.take_along_dim(
                b[h >> shift, c][grp].reshape(n, LANE_WINDOW, G, kc), member,
                dim=2)[:, :, 0] for c in range(C)], dim=-1).to(torch.float32)
            with full_fp32_matmul():
                if da is not None:
                    pa = torch.bmm(d, b_blk)               # (n, 64, K)
                    da[h].index_add_(0, rows[to_a], pa[to_a])
                if dbt is not None:
                    a_blk = a[h][rows].to(torch.float32)   # (n, 64, K)
                    pb = torch.bmm(d.transpose(1, 2), a_blk)
                    pb = pb[to_b]                          # (lanes, K)
                    for c in range(C):
                        dbt_l[h >> shift, c].index_add_(
                            0, tgt_lane[to_b], pb[:, c * kc:(c + 1) * kc])
    return da, dbt


def _check_grad(a, b, g, table, da, dbt):
    if a.dim() != 3 or b.dim() != 4 or g.dim() != 2:
        raise ValueError(f"tile_table_grad: want a (H, M, C*kc), b (H, C, "
                         f"NB, G*kc) and g (H, F), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)} and {tuple(g.shape)}")
    _, C, nb, gk = b.shape
    H = a.shape[0]
    G = table.group_size
    kc = gk // G if G else 0
    if (g.shape[0] != H or C < 1 or kc < 1
            or kc * G != gk or a.shape[2] != C * kc):
        raise ValueError(f"tile_table_grad: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} and g {tuple(g.shape)} disagree "
                         f"on heads, C or kc (G={G})")
    head_shift(H, b.shape[0])
    if table.max_row >= a.shape[1] or table.max_gid >= nb:
        raise ValueError(f"tile_table_grad: the table indexes row "
                         f"{table.max_row} of {a.shape[1]} and group row "
                         f"{table.max_gid} of {nb}")
    if table.out_extent > g.shape[1]:
        raise ValueError(f"tile_table_grad: the table reads "
                         f"{table.out_extent} slots, g has {g.shape[1]}")
    for name, t, shape in (("a", a, a.shape), ("b", b, b.shape),
                           ("g", g, g.shape), ("da", da, a.shape),
                           ("dbt", dbt, b.shape)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != a.device:
            raise TypeError(f"tile_table_grad: {name} is {t.dtype} on "
                            f"{t.device}, want float32 on {a.device}")
        if t.shape != shape:
            raise ValueError(f"tile_table_grad: {name} {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not (t.is_contiguous() or (name == "g" and t.stride(1) == 1)):
            raise ValueError(f"tile_table_grad: {name} must be contiguous "
                             "(g: its rows)")
    return H, C, kc


def tile_table_grad(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                    table: TileTable, da=None, dbt=None,
                    accumulate: bool = False, real_rows=None,
                    real_lanes=None):
    """The backward of ``tile_table`` at fp32 operands: with dO the
    cotangent ``g`` (H, F) at each entry's slots,
    ``da[h, row] (+)= sum over entries of dO . B^T lanes`` and
    ``dbt[h, c, lane] (+)= dO^T . A rows`` (chunk c's columns), written
    (or added to with ``accumulate``) into ``da`` (H, M, C*kc) and ``dbt``
    (Hkv, C, NB, G*kc) (b's heads: query head h adds into key head ``h >>
    head_shift``, the group's heads in order), either of them None when not
    wanted.  a, b, da and
    dbt contiguous fp32, g fp32 with contiguous rows, on one device.  Rows
    at or past ``real_rows`` and lanes at or past ``real_lanes`` (the pads)
    get nothing: written as zeros, or left as they are.

    CUDA tensors go through two launches whatever the heads, chunks and
    slabs (or raise): ``csrc/tile_grad.cu``'s tile-grad kernel over the
    table's units (``TileTable.grad_index``) into a workspace of partials,
    then its reduction, which adds each row's partials in a fixed order:
    a repeat call is bit-equal.  The products are the "float32" instance's
    six bf16 products (about one fp32 rounding off the exact product).  A
    kc off ``K_STEP`` is zero-padded (copies) first.  CPU tensors go
    through ``tile_table_grad_plain``."""
    H, C, kc = _check_grad(a, b, g, table, da, dbt)
    if a.device.type == "cpu":
        return tile_table_grad_plain(a, b, g, table, da, dbt, accumulate,
                                     real_rows, real_lanes)
    if a.device.type != "cuda":
        raise ValueError(f"tile_table_grad: unsupported device {a.device}")
    if table.entries.device != a.device:
        raise ValueError(f"tile_table_grad: the table is on "
                         f"{table.entries.device}, a on {a.device}")
    if da is None and dbt is None:
        return da, dbt
    M, nb, G = a.shape[1], b.shape[2], table.group_size
    HB, shift = b.shape[0], head_shift(H, b.shape[0])
    idx = table.grad_index(M, nb * G, real_rows, real_lanes)
    da_k, dbt_k = da, dbt
    if kc % K_STEP:
        a = pad_k(a, C)
        b = pad_k(b.reshape(HB, C, nb, G, kc)).reshape(HB, C, nb, -1)
        if da is not None:
            da_k = pad_k(da, C) if accumulate else torch.empty_like(a)
        if dbt is not None:
            dbt_k = (pad_k(dbt.reshape(HB, C, nb, G, kc)).reshape(b.shape)
                     if accumulate else torch.empty_like(b))
    if a.data_ptr() % _ALIGN or b.data_ptr() % _ALIGN:
        raise ValueError(f"tile_table_grad: a and b must start "
                         f"{_ALIGN}-byte aligned")
    kp = b.shape[3] // G
    K = C * kp
    ws = torch.empty((H, idx.partials, K), dtype=torch.float32,
                     device=a.device)
    units, n_a, tptr = idx.units, idx.n_units_a, idx.tptr
    n_targets, rows_a = idx.n_targets, idx.n_a
    if da is None:
        units, n_a = units[idx.n_units_a:], 0
        tptr, n_targets, rows_a = tptr[idx.n_a:], n_targets - idx.n_a, 0
    elif dbt is None:
        units, n_targets = units[:idx.n_units_a], idx.n_a
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(_kernels.TILE_GRAD_ENTRY, a.data_ptr(), a.stride(0),
                        a.stride(1), b.data_ptr(), b.stride(0), b.stride(1),
                        b.stride(2), g.data_ptr(), g.stride(0),
                        table.entries.data_ptr(), table.row_ids.data_ptr(),
                        table.gids.data_ptr(), units.data_ptr(),
                        units.shape[0], n_a, idx.walk.data_ptr(),
                        ws.data_ptr(), ws.stride(0), H, K, kp, G, shift,
                        stream)
        _kernels.launch(_kernels.TILE_GRAD_REDUCE_ENTRY, ws.data_ptr(),
                        ws.stride(0), K, tptr.data_ptr(), idx.src.data_ptr(),
                        rows_a, n_targets,
                        None if da_k is None else da_k.data_ptr(),
                        0 if da_k is None else da_k.stride(0),
                        None if dbt_k is None else dbt_k.data_ptr(),
                        0 if dbt_k is None else dbt_k.stride(0),
                        0 if dbt_k is None else dbt_k.stride(1), kp, H,
                        int(accumulate), shift, stream)
    if da_k is not da:
        da.copy_(da_k.view(H, M, C, kp)[..., :kc].reshape(da.shape))
    if dbt_k is not dbt:
        dbt.copy_(dbt_k.view(HB, C, nb, G, kp)[..., :kc].reshape(dbt.shape))
    return da, dbt


def _rows_of(x: torch.Tensor):
    """(row stride, rows from one tile to the next) of x (nT, R, K) as rows
    of one strided matrix, or None where its tile stride is not a whole
    number of rows."""
    nT, R, _ = x.shape
    if R == 1:
        return x.stride(0), 1
    if nT == 1:
        return x.stride(1), 0
    if x.stride(1) and x.stride(0) % x.stride(1) == 0:
        return x.stride(1), x.stride(0) // x.stride(1)
    return None


def identity_table(nT: int, R: int, L: int, a_step: int, b_step: int,
                   so_t: int, so_r: int, device) -> TileTable:
    """The table of a batched tile dot: tile t's rows are ``t*a_step + r``
    and its lanes ``t*b_step + l`` (G = 1), its (R, L) block at
    ``t*so_t`` of the output, rows ``so_r`` apart."""
    t = np.arange(nT, dtype=np.int64)
    ent = table_blocks(t * R, t * L, t * so_t, R, L, so_r)
    rows = (t[:, None] * a_step + np.arange(R)).ravel()
    gids = (t[:, None] * b_step + np.arange(L)).ravel()
    return TileTable.build(ent, rows, gids, 1, device)


def tile_dot(a: torch.Tensor, b: torch.Tensor, mode: str = "tf32",
             out: torch.Tensor = None, accumulate: bool = False,
             plain: bool = False) -> torch.Tensor:
    """Batched tile dot ``(nT, R, K) x (nT, L, K) -> (nT, R, L)`` fp32 in
    compute mode ``mode``; a and b in the mode's ``STORAGE`` dtypes, on one
    device, last dimension contiguous; R, L, K >= 1, and rows 16-byte
    aligned where K is a multiple of 16 (other K are zero-padded to one,
    into aligned copies, before the launch).  ``out`` (optional, any
    strides with a contiguous last dimension) is written in place, or
    added to with ``accumulate``.
    CUDA tensors go through one launch of the mode's kernel instance over
    the identity table of the tiles (or raise); CPU tensors, or any with
    ``plain=True`` (only ever chosen explicitly, as the reference a kernel
    is timed against), through ``tile_dot_plain``."""
    nT, R, L, K = _check(a, b, mode, out, accumulate)
    if plain or a.device.type == "cpu":
        res = tile_dot_plain(a, b, mode)
        if out is None:
            return res
        if accumulate:
            return out.add_(res)
        return out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"tile_dot: unsupported device {a.device}")
    if out is None:
        out = torch.empty((nT, R, L), dtype=torch.float32, device=a.device)
    if nT == 0:
        return out
    if K % K_STEP:
        a, b = pad_k(a), pad_k(b)
        K = a.shape[2]
    ra, rb = _rows_of(a), _rows_of(b)
    if ra is None:
        a = a.contiguous()
        ra = _rows_of(a)
    if rb is None:
        b = b.contiguous()
        rb = _rows_of(b)
    table = identity_table(nT, R, L, ra[1], rb[1], out.stride(0),
                           out.stride(1), a.device)
    _launch(mode, a.data_ptr(), 0, ra[0], b.data_ptr(), 0, 0, rb[0], table,
            out, 0, 1, 1, K, accumulate)
    return out
