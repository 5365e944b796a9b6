"""Batched multi-leader row clustering on the card.

Counterpart of ``sddmm_tpu/reorder/device_cluster.py``
(``batched_cluster_device``, ``_round_step``): the same algorithm as the
host ``rows._batched_cluster``, each round on the device:

- the first L live rows in dispersion order become leader candidates,
- each candidate joins the first earlier accepted leader it is similar to,
  or is accepted,
- every live row joins the first accepted leader it is similar to, the
  similarity being the weighted Jaccard ``min_sum / (|x| + |y| - min_sum)``
  of L1-normalised encodings in fp32,
- with the host version's early bail (rounds that stop clustering leave
  the rest as singleton clusters).

The round loop stays on the host, with one fetch of two scalars a round
(clusters so far and live rows).  A round is two launches of the hand
kernel ``csrc/cluster_round.cu`` (``cluster_round``) on a CUDA device, or
its plain PyTorch version (``_round_step_plain``) on the CPU.

Where JAX densifies the encodings to (m, B) and reads all of them every
round, the rows keep their sparse encodings here (``encodings``: the
occupied column blocks of each row, in dispersion order), and only the
accepted leaders' hats are dense, a (B, L) table.  The arithmetic is
``rows._batched_cluster(..., hat_dtype=np.float32)``'s, bit for bit: the
same fp32 hats, norms and hat sums (``_sparse_hats``), each min-sum as
numpy's pairwise sum over the row's blocks, the leaders compared with
float32(alpha) and the rows with alpha in float64, as the host compares
them.  So ``cluster_of`` equals the host's; JAX's dense sums take another
order and equal it wherever no similarity lies within a rounding of alpha.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from sddmm_tpu_torch import _kernels

#: state words of a round on the device (``csrc/cluster_round.cu``)
CLUSTERS, LIVE, START, ACCEPTED, BASE = range(5)
#: leaders a round the kernel takes at most (its table's leading dimension)
MAX_LEADERS = 1024


def _sparse_hats(block_ptr, block_idx, block_cnt, num_rows):
    """(hat per encoding entry, hat sum per row), fp32, computed as
    ``rows._batched_cluster(hat_dtype=np.float32)`` computes them."""
    occ = np.diff(block_ptr)
    row_of = np.repeat(np.arange(num_rows), occ.astype(np.int64))
    cnt = block_cnt.astype(np.float32)
    norm_sq = np.zeros(num_rows, dtype=np.float32)
    np.add.at(norm_sq, row_of, cnt * cnt)
    norms = np.sqrt(np.maximum(norm_sq, np.finfo(np.float32).tiny))
    hat = cnt / norms[row_of]
    hat_sum = np.zeros(num_rows, dtype=np.float32)
    np.add.at(hat_sum, row_of, hat)
    return hat, hat_sum


@dataclasses.dataclass
class ClusterEncodings:
    """The rows of ``order`` in that order, on a device: ``ptr`` (n+1,)
    int64 over their occupied blocks, ``idx`` int32 block ids, ``hat`` fp32
    normalised counts, ``hat_sum`` (n,) fp32; ``ptr_host`` the numpy
    ``ptr``."""
    ptr: torch.Tensor
    idx: torch.Tensor
    hat: torch.Tensor
    hat_sum: torch.Tensor
    ptr_host: np.ndarray
    num_blocks: int

    @property
    def n(self) -> int:
        return len(self.ptr_host) - 1


def encodings(order, block_ptr, block_idx, block_cnt, num_blocks,
              device) -> ClusterEncodings:
    """The rows of ``order`` (their sparse encodings, ``rows.row_encodings``)
    permuted into dispersion order, on ``device``."""
    order = np.asarray(order, dtype=np.int64)
    hat, hat_sum = _sparse_hats(block_ptr, block_idx, block_cnt,
                                len(block_ptr) - 1)
    lens = np.diff(block_ptr)[order]
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    src = (np.repeat(block_ptr[order] - ptr[:-1], lens)
           + np.arange(ptr[-1], dtype=np.int64))

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype),
                               device=device)

    return ClusterEncodings(put(ptr, np.int64), put(block_idx[src], np.int32),
                            put(hat[src], np.float32),
                            put(hat_sum[order], np.float32), ptr,
                            int(num_blocks))


@dataclasses.dataclass
class RoundState:
    """A clustering's state on its device: ``cluster`` (n,) int32, -1 while
    a position is live, else its cluster id; ``state`` int32 (5,) (clusters
    so far, live positions, the first live one, the last round's accepted
    leaders and its first cluster id); ``lead`` (B, L) fp32, the accepted
    leaders' dense hats, leader a in column a; ``acc_pos`` (L,) int32 their
    positions."""
    cluster: torch.Tensor
    state: torch.Tensor
    lead: torch.Tensor
    acc_pos: torch.Tensor

    @staticmethod
    def start(enc: ClusterEncodings, L: int) -> "RoundState":
        dev = enc.ptr.device
        state = torch.tensor([0, enc.n, 0, 0, 0], dtype=torch.int32,
                             device=dev)
        return RoundState(
            torch.full((enc.n,), -1, dtype=torch.int32, device=dev), state,
            torch.zeros((max(enc.num_blocks, 1), L), dtype=torch.float32,
                        device=dev),
            torch.zeros(L, dtype=torch.int32, device=dev))


def thresholds(alpha: float):
    """(leaders', rows') thresholds as float32 values: the host dedups
    leaders against float32(alpha) (a float32 array against a Python
    float) and assigns rows from float64 similarities against alpha, which
    for a float32 similarity s is ``s > `` the largest float32 <= alpha."""
    lead = np.float32(alpha)
    row = lead if float(lead) <= alpha else np.nextafter(
        lead, np.float32(-np.inf))
    return float(lead), float(row)


def pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """numpy's float32 pairwise sum over the last dimension of ``v``, add
    for add: sequential below 8 terms, 8 accumulators up to 128, halves
    (cut at a multiple of 8) above."""
    n = v.shape[-1]
    if n < 8:
        res = v.new_zeros(v.shape[:-1])
        for k in range(n):
            res = res + v[..., k]
        return res
    if n <= 128:
        r = v[..., :8]
        stop = n - n % 8
        for i in range(8, stop, 8):
            r = r + v[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for k in range(stop, n):
            res = res + v[..., k]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(v[..., :n2]) + pairwise_sum(v[..., n2:])


def _first_leader_plain(enc, lead, acc, q, ln, alpha):
    """For positions ``q`` whose encodings all have ``ln`` blocks: the first
    accepted leader (columns of ``lead``, positions ``acc``) each is
    similar to, or -1; the kernel's arithmetic in torch ops."""
    k = enc.ptr[q][:, None] + torch.arange(ln, device=q.device)
    v = torch.minimum(lead[enc.idx[k].long(), :len(acc)],
                      enc.hat[k][..., None])           # (nq, ln, n_acc)
    ms = pairwise_sum(v.transpose(1, 2))                  # (nq, n_acc)
    sim = ms / torch.clamp((enc.hat_sum[acc][None, :]
                            + enc.hat_sum[q][:, None]) - ms, min=1e-30)
    hit = sim > alpha
    first = hit.to(torch.int32).argmax(dim=1)
    return torch.where(hit.any(dim=1), first, torch.full_like(first, -1))


def _round_step_plain(enc: ClusterEncodings, st: RoundState, L: int,
                      alpha_lead: float, alpha_row: float,
                      chunk: int = 2048) -> None:
    """One round in torch ops (any device), updating ``st`` as the kernel
    does: the plain version the kernel is held to, and the CPU's round.
    ``chunk`` bounds the rows taken at once (and their (rows, blocks,
    leaders) temporary to about 2^22 floats)."""
    cluster = st.cluster
    dev = cluster.device
    base, n_live = (int(x) for x in st.state[:2].tolist())
    lead = torch.zeros_like(st.lead)
    cand = torch.nonzero(cluster < 0).flatten()[:L]
    acc = []
    for p in cand.tolist():
        s, e = int(enc.ptr_host[p]), int(enc.ptr_host[p + 1])
        first = -1
        if acc:
            first = int(_first_leader_plain(
                enc, lead, torch.tensor(acc, device=dev),
                torch.tensor([p], device=dev), e - s, alpha_lead)[0])
        if first >= 0:
            cluster[p] = base + first
        else:
            lead[enc.idx[s:e].long(), len(acc)] = enc.hat[s:e]
            cluster[p] = base + len(acc)
            acc.append(p)
    assigned = len(cand)
    rows = torch.nonzero(cluster < 0).flatten()
    if acc and len(rows):
        acc_t = torch.tensor(acc, device=dev)
        lens = enc.ptr[rows + 1] - enc.ptr[rows]
        for ln in torch.unique(lens).tolist():
            sel = rows[lens == ln]
            step = max(1, min(chunk, (1 << 22) // (ln * len(acc))))
            for c0 in range(0, len(sel), step):
                q = sel[c0:c0 + step]
                first = _first_leader_plain(enc, lead, acc_t, q, ln, alpha_row)
                got = first >= 0
                cluster[q[got]] = base + first[got].to(torch.int32)
                assigned += int(got.sum())
    st.lead.copy_(lead)
    st.acc_pos[:len(acc)] = torch.tensor(acc, dtype=torch.int32, device=dev)
    st.state.copy_(torch.tensor(
        [base + len(acc), n_live - assigned,
         int(cand[0]) if len(cand) else int(st.state[START]), len(acc), base],
        dtype=torch.int32))


def cluster_round(enc: ClusterEncodings, st: RoundState, L: int,
                  alpha: float, plain: bool = False,
                  chunk: int = 2048) -> None:
    """One clustering round on ``st``: on a CUDA device two launches of
    ``csrc/cluster_round.cu`` (the leaders, then the rows; nothing synced),
    on the CPU (or with ``plain``) ``_round_step_plain``."""
    if not 1 <= L <= MAX_LEADERS or st.lead.shape[1] != L:
        raise ValueError(f"cluster_round: L={L} leaders, want 1.."
                         f"{MAX_LEADERS} and the table's {st.lead.shape[1]}")
    alpha_lead, alpha_row = thresholds(alpha)
    dev = st.cluster.device
    if plain or dev.type == "cpu":
        _round_step_plain(enc, st, L, alpha_lead, alpha_row, chunk)
        return
    if dev.type != "cuda":
        raise ValueError(f"cluster_round: unsupported device {dev}")
    if enc.n >= 2 ** 31 - 1:
        raise ValueError(f"cluster_round: {enc.n} rows do not fit int32")
    for t in (enc.ptr, enc.idx, enc.hat, enc.hat_sum, st.cluster, st.state,
              st.lead, st.acc_pos):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("cluster_round: encodings and state must be "
                             f"contiguous on {dev}")
    args = (enc.ptr.data_ptr(), enc.idx.data_ptr(), enc.hat.data_ptr(),
            enc.hat_sum.data_ptr(), st.cluster.data_ptr(),
            st.state.data_ptr(), st.lead.data_ptr(), st.acc_pos.data_ptr(),
            enc.n, L)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.launch(_kernels.CLUSTER_LEADERS_ENTRY, *args, alpha_lead,
                        stream)
        _kernels.launch(_kernels.CLUSTER_ASSIGN_ENTRY, *args, alpha_row,
                        stream)


def batched_cluster_device(order, block_ptr, block_idx, block_cnt,
                           num_blocks, alpha: float,
                           leaders_per_round: int = 32,
                           max_rounds=None, bail_after: int = 48,
                           bail_yield: float = 1.5, chunk: int = 2048,
                           device="cuda", plain: bool = False,
                           record: Optional[dict] = None):
    """Counterpart of ``rows._batched_cluster`` (same arguments, same
    return: ``(cluster_of (m,) int64, num_clusters)``) with every round on
    ``device``: the card unless the caller asks for ``"cpu"``, where the
    rounds are the plain version.  ``plain`` takes the plain version on
    the card too; ``chunk`` bounds its rows at once.  ``record``, a dict,
    receives ``rounds``, ``clusters`` (the clusters made by the end of each
    round that ran), ``round_ms`` (device time of each round's launches,
    by CUDA events, on the card) and ``seconds`` (host wall)."""
    from sddmm_tpu_torch.ops.hybrid import check_device

    dev = check_device(device)
    num_rows_total = block_ptr.shape[0] - 1
    cluster_of = np.full(num_rows_total, -1, dtype=np.int64)
    if not len(order):
        return cluster_of, 0
    t0 = time.perf_counter()
    L = int(leaders_per_round)
    enc = encodings(order, block_ptr, block_idx, block_cnt, num_blocks, dev)
    st = RoundState.start(enc, L)
    timed = record is not None and dev.type == "cuda"
    round_ms, made = [], []
    num_clusters, n_live = 0, enc.n
    rounds = 0
    while n_live:
        rounds += 1
        assigned_so_far = enc.n - n_live
        bail = (rounds > bail_after
                and assigned_so_far < bail_yield * L * rounds)
        if bail or (max_rounds is not None and rounds > max_rounds):
            # the rest become singleton clusters in dispersion order
            live = st.cluster < 0
            st.cluster[live] = num_clusters + torch.arange(
                n_live, dtype=torch.int32, device=dev)
            num_clusters += n_live
            break
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        cluster_round(enc, st, L, alpha, plain=plain, chunk=chunk)
        if timed:
            ev[1].record()
        # the round's one fetch: clusters so far and live rows
        num_clusters, n_live = (int(x) for x in st.state[:2].tolist())
        made.append(num_clusters)
        if timed:
            round_ms.append(ev[0].elapsed_time(ev[1]))
    cluster_of[np.asarray(order, dtype=np.int64)] = st.cluster.cpu().numpy()
    if record is not None:
        record.update(rounds=rounds, clusters=made, round_ms=round_ms,
                      seconds=time.perf_counter() - t0)
    return cluster_of, int(num_clusters)
