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
#: of each product, in the kernel's order)
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


def tile_table_plain(a: torch.Tensor, b: torch.Tensor, table: TileTable,
                     mode: str, out: torch.Tensor, accumulate: bool = False,
                     batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``tile_table``: per head, for ``batch``
    entries at a time, gather each entry's A rows and B^T lanes through the
    table, take ``tile_dot_plain`` per chunk, sum the chunks in the order
    c = 0..C-1, and write (or add) the cells inside each entry's
    (nrows, nlanes) to its place in ``out``."""
    H, C = b.shape[0], b.shape[1]
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
                b_blk = b[h, c][grp].reshape(e.shape[0], LANE_WINDOW, G, kc)
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
    H, C, nb, gk = b.shape
    G = table.group_size
    kc = gk // G if G else 0
    if (a.shape[0] != H or out.shape[0] != H or C < 1 or kc < 1
            or kc * G != gk or a.shape[2] != C * kc):
        raise ValueError(f"tile_table: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} and out {tuple(out.shape)} "
                         f"disagree on heads, C or kc (G={G})")
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

    a (H, M, C*kc) padded A rows in the mode's A storage, b (H, C, NB,
    G*kc) the grouped, chunked B^T in its B storage (G = the table's group
    size), out (H, F) fp32 with contiguous rows; a and b contiguous, on one
    device.  CUDA tensors go through one launch of the mode's kernel
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
            out, out.stride(0), H, C, kc, accumulate)
    return out


def _launch(mode, a_ptr, sa_h, sa_r, b_ptr, sb_h, sb_c, sb_r, table, out,
            so_h, heads, C, kc, accumulate):
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(f"sddmm_tile_dot_{mode}", a_ptr, sa_h, sa_r,
                        b_ptr, sb_h, sb_c, sb_r, table.entries.data_ptr(),
                        table.n_entries, table.row_ids.data_ptr(),
                        table.gids.data_ptr(), out.data_ptr(), so_h, heads,
                        C, kc, table.group_size, int(accumulate), stream)


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
