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

The round loop runs on the device: the host enqueues rounds in batches
(``ROUNDS_PER_FETCH``) and reads the state once a batch, and each round
tests the early bail and ``max_rounds`` itself, so a round after the end
does nothing.  A round is two launches of the hand kernel
``csrc/cluster_round.cu`` (``cluster_round``) on a CUDA device: the
leaders (their dedup as L x L similarity bits resolved with bit
operations) and the rows (a warp a live row of a compacted list).  On the
CPU a round is its plain version ``_round_step_plain`` (the sequential
dedup, as the host does it) behind ``_round_gate_plain``, the kernel's
test at the top of a round; ``_round_step_bitmask`` is the kernel's
organisation of a round in torch ops, with the same results.

Where JAX densifies the encodings to (m, B) and reads all of them every
round, the rows keep their sparse encodings here (``encodings``: the
occupied column blocks of each row, in dispersion order), and only the
round's leader candidates' hats are dense, a (B, L) table.  The arithmetic is
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

#: state words of a clustering on the device (``csrc/cluster_round.cu``):
#: clusters so far, live rows, the first live position, the last round's
#: candidates and first cluster id, rounds (counted as the host counts
#: them), done (0 running, 1 no live rows, 2 bailed), and the live
#: positions in each of the two lists; from ``MASK`` on, the last round's
#: accepted mask, 32 candidates a word
(CLUSTERS, LIVE, START, CANDS, BASE, ROUNDS, DONE, COUNT0, COUNT1,
 MASK) = range(10)
#: leader candidates a round the kernel takes at most (``kMaxLeaders``: its
#: accepted mask is MAX_LEADERS / 32 words); the plain rounds take any
#: number
MAX_LEADERS = 512
#: int32 words of a clustering's state
STATE_WORDS = MASK + MAX_LEADERS // 32
#: rounds the host enqueues between two reads of the state
ROUNDS_PER_FETCH = 32


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
    a position is live, else its cluster id; ``state`` int32
    (``STATE_WORDS``,) (the words ``CLUSTERS`` .. ``COUNT1`` and the mask
    from ``MASK``); ``lead`` (B, L) fp32, the round's
    candidates' dense hats, candidate j in column j; ``cand_pos`` (L,)
    int32 their positions; ``made`` (n+1,) int32, the clusters made by the
    end of each round; ``lists`` (2, n) int32, the live positions of the
    rounds (the kernel's compacted lists, ``lists[0]`` all at the start)."""
    cluster: torch.Tensor
    state: torch.Tensor
    lead: torch.Tensor
    cand_pos: torch.Tensor
    made: torch.Tensor
    lists: torch.Tensor

    @staticmethod
    def start(enc: ClusterEncodings, L: int) -> "RoundState":
        dev = enc.ptr.device
        n = enc.n
        state = torch.zeros(STATE_WORDS, dtype=torch.int32, device=dev)
        state[LIVE] = n
        state[COUNT0] = n
        lists = torch.empty((2, n), dtype=torch.int32, device=dev)
        lists[0] = torch.arange(n, dtype=torch.int32, device=dev)
        return RoundState(
            torch.full((n,), -1, dtype=torch.int32, device=dev), state,
            torch.zeros((max(enc.num_blocks, 1), L), dtype=torch.float32,
                        device=dev),
            torch.zeros(L, dtype=torch.int32, device=dev),
            torch.zeros(n + 1, dtype=torch.int32, device=dev), lists)


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


def _hits_plain(enc, lead, col_sums, q, ln, alpha):
    """(nq, n_cols) bool: whether each position of ``q`` (whose encodings
    all have ``ln`` blocks) is similar to each column of ``lead`` (a dense
    hat a column, their hat sums ``col_sums``); the kernel's arithmetic in
    torch ops."""
    k = enc.ptr[q][:, None] + torch.arange(ln, device=q.device)
    v = torch.minimum(lead[enc.idx[k].long()],
                      enc.hat[k][..., None])           # (nq, ln, n_cols)
    ms = pairwise_sum(v.transpose(1, 2))                  # (nq, n_cols)
    sim = ms / torch.clamp((col_sums[None, :] + enc.hat_sum[q][:, None])
                           - ms, min=1e-30)
    return sim > alpha


def _first_hit(hit):
    """The first True column of each row of ``hit``, or -1."""
    first = hit.to(torch.int32).argmax(dim=1)
    return torch.where(hit.any(dim=1), first, torch.full_like(first, -1))


def _round_gate_plain(st: RoundState, n: int, L: int, bail_after: int,
                      bail_yield: float, max_rounds) -> bool:
    """The kernel's test at the top of a round, on ``st``: False (and the
    clustering marked done) when no row is live, or when the host loop
    would bail or pass ``max_rounds``; else the round is counted and
    runs."""
    words = st.state.tolist()
    if words[DONE]:
        return False
    if words[LIVE] == 0:
        st.state[DONE] = 1
        return False
    rounds = words[ROUNDS] + 1
    st.state[ROUNDS] = rounds
    assigned = n - words[LIVE]
    bail = rounds > bail_after and assigned < bail_yield * L * rounds
    if bail or (max_rounds is not None and rounds > max_rounds):
        st.state[DONE] = 2
        return False
    return True


def _finish_round(st, base, n_live, cand, n_acc, mask, assigned):
    """The state words a round leaves, as the kernel writes them."""
    dev = st.cluster.device
    words = st.state.tolist()
    words[CLUSTERS] = base + n_acc
    words[LIVE] = n_live - assigned
    words[START] = int(cand[0])
    words[CANDS] = len(cand)
    words[BASE] = base
    # the mask's words (a plain round of more candidates than the kernel
    # takes keeps those that fit)
    for w in range(min(-(-len(cand) // 32), STATE_WORDS - MASK)):
        words[MASK + w] = int(np.uint32((mask >> (32 * w)) & 0xffffffff)
                              .view(np.int32))
    st.state.copy_(torch.tensor(words, dtype=torch.int32))
    st.made[words[ROUNDS] - 1] = base + n_acc
    st.cand_pos[:len(cand)] = torch.as_tensor(cand, dtype=torch.int32,
                                              device=dev)


def _assign_rows(enc, st, lead, col_sums, take, base, alpha_row, chunk):
    """The rows' pass in torch ops: every live row joins the first column
    of ``lead`` it is similar to, its cluster ``base + take[column]``
    (``take`` (n_cols,) int64, -1 for a column no row may join).  Returns
    the rows assigned."""
    cluster = st.cluster
    rows = torch.nonzero(cluster < 0).flatten()
    assigned = 0
    if not len(rows) or not bool((take >= 0).any()):
        return 0
    ok = take >= 0
    n_cols = lead.shape[1]
    lens = enc.ptr[rows + 1] - enc.ptr[rows]
    for ln in torch.unique(lens).tolist():
        sel = rows[lens == ln]
        step = max(1, min(chunk, (1 << 22) // (ln * n_cols)))
        for c0 in range(0, len(sel), step):
            q = sel[c0:c0 + step]
            first = _first_hit(_hits_plain(enc, lead, col_sums, q, ln,
                                           alpha_row) & ok[None, :])
            got = first >= 0
            cluster[q[got]] = base + take[first[got]].to(torch.int32)
            assigned += int(got.sum())
    return assigned


def _round_step_plain(enc: ClusterEncodings, st: RoundState, L: int,
                      alpha_lead: float, alpha_row: float,
                      chunk: int = 2048) -> None:
    """One round in torch ops (any device) with the host's sequential
    dedup, updating the state words, ``cluster`` and ``made`` as the kernel
    does (its own leader table, not ``st.lead``): the plain version the
    kernel is held to, and the CPU's round.  ``chunk`` bounds the rows
    taken at once (and their (rows, blocks, leaders) temporary to about
    2^22 floats)."""
    cluster = st.cluster
    dev = cluster.device
    base, n_live = (int(x) for x in st.state[:2].tolist())
    lead = torch.zeros_like(st.lead)
    cand = torch.nonzero(cluster < 0).flatten()[:L].tolist()
    acc, mask = [], 0
    for i, p in enumerate(cand):
        s, e = int(enc.ptr_host[p]), int(enc.ptr_host[p + 1])
        first = -1
        if acc:
            first = int(_first_hit(_hits_plain(
                enc, lead[:, :len(acc)],
                enc.hat_sum[torch.tensor(acc, device=dev)],
                torch.tensor([p], device=dev), e - s, alpha_lead))[0])
        if first >= 0:
            cluster[p] = base + first
        else:
            lead[enc.idx[s:e].long(), len(acc)] = enc.hat[s:e]
            cluster[p] = base + len(acc)
            acc.append(p)
            mask |= 1 << i
    take = torch.arange(L, device=dev)
    take[len(acc):] = -1
    assigned = len(cand) + _assign_rows(
        enc, st, lead, enc.hat_sum[torch.tensor(acc + [0] * (L - len(acc)),
                                                device=dev)],
        take, base, alpha_row, chunk)
    _finish_round(st, base, n_live, cand, len(acc), mask, assigned)


def dedup_bitmask(sim):
    """The kernel's dedup of a round's candidates from their similarity
    bits: ``sim[i]`` an int whose bit j (j < i) says candidate i is
    similar to candidate j.  In order, i is accepted iff ``sim[i] &
    accepted`` is empty, else it joins the lowest set bit of it; a
    candidate's cluster offset is the rank of its leader among the
    accepted.  Returns (accepted mask, offsets)."""
    acc, cid = 0, []
    for i, bits in enumerate(sim):
        hits = bits & acc
        if not hits:
            cid.append(bin(acc).count("1"))
            acc |= 1 << i
        else:
            j = (hits & -hits).bit_length() - 1
            cid.append(bin(acc & ((1 << j) - 1)).count("1"))
    return acc, cid


def _round_step_bitmask(enc: ClusterEncodings, st: RoundState, L: int,
                        alpha_lead: float, alpha_row: float,
                        chunk: int = 2048) -> None:
    """One round organised as the kernel's, in torch ops: every candidate's
    hat in its own column of ``st.lead``, the similarity bits of every
    (candidate, earlier candidate) pair, ``dedup_bitmask``, then the rows
    against the candidates' columns under the accepted mask.  Same results
    as ``_round_step_plain``."""
    cluster = st.cluster
    dev = cluster.device
    base, n_live = (int(x) for x in st.state[:2].tolist())
    st.lead.zero_()
    cand = torch.nonzero(cluster < 0).flatten()[:L].tolist()
    for j, p in enumerate(cand):
        s, e = int(enc.ptr_host[p]), int(enc.ptr_host[p + 1])
        st.lead[enc.idx[s:e].long(), j] = enc.hat[s:e]
    cand_t = torch.tensor(cand, device=dev)
    sums = enc.hat_sum[cand_t]
    sim = [0]
    for i in range(1, len(cand)):
        p = cand[i]
        ln = int(enc.ptr_host[p + 1] - enc.ptr_host[p])
        hit = _hits_plain(enc, st.lead[:, :i], sums[:i], cand_t[i:i + 1], ln,
                          alpha_lead)[0].tolist()
        sim.append(sum(1 << j for j, h in enumerate(hit) if h))
    mask, cid = dedup_bitmask(sim)
    cluster[cand_t] = base + torch.tensor(cid, dtype=torch.int32,
                                          device=dev)
    rank = [bin(mask & ((1 << j) - 1)).count("1") if (mask >> j) & 1 else -1
            for j in range(len(cand))]
    assigned = len(cand) + _assign_rows(
        enc, st, st.lead[:, :len(cand)], sums,
        torch.tensor(rank, device=dev), base, alpha_row, chunk)
    _finish_round(st, base, n_live, cand, bin(mask).count("1"), mask,
                  assigned)



def check_leaders(L: int) -> None:
    """Raises ``ValueError`` naming the kernel's cap when it cannot take
    ``L`` candidates a round (the C entry refuses the launch too)."""
    if L > MAX_LEADERS:
        raise ValueError(f"cluster_round: L={L} leaders, the kernel takes "
                         f"at most MAX_LEADERS={MAX_LEADERS} (its accepted "
                         f"mask is {MAX_LEADERS // 32} words of 32)")


def _kernel_round(enc: ClusterEncodings, st: RoundState, L: int,
                  alpha: float, bail_after: int, bail_yield: float,
                  max_rounds):
    """A round's two launches of ``csrc/cluster_round.cu`` on ``st``'s
    CUDA device, checked once: a function that enqueues one round (the
    leaders, then the rows; nothing synced) each time it is called."""
    dev = st.cluster.device
    check_leaders(L)
    if enc.n >= 2 ** 31 - 1:
        raise ValueError(f"cluster_round: {enc.n} rows do not fit int32")
    for t in (enc.ptr, enc.idx, enc.hat, enc.hat_sum, st.cluster, st.state,
              st.lead, st.cand_pos, st.made, st.lists):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("cluster_round: encodings and state must be "
                             f"contiguous on {dev}")
    alpha_lead, alpha_row = thresholds(alpha)
    head = (enc.ptr.data_ptr(), enc.idx.data_ptr(), enc.hat.data_ptr(),
            enc.hat_sum.data_ptr(), st.cluster.data_ptr(),
            st.state.data_ptr(), st.lead.data_ptr(), st.cand_pos.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    leaders = (*head, st.made.data_ptr(), enc.n, L, alpha_lead,
               min(int(bail_after), 2 ** 31 - 1), float(bail_yield),
               -1 if max_rounds is None else int(max_rounds), stream)
    rows = (*head, st.lists.data_ptr(), enc.n, L, alpha_row, stream)

    def run():
        _kernels.launch(_kernels.CLUSTER_LEADERS_ENTRY, *leaders)
        _kernels.launch(_kernels.CLUSTER_ASSIGN_ENTRY, *rows)

    return run


def cluster_round(enc: ClusterEncodings, st: RoundState, L: int,
                  alpha: float, plain: bool = False, chunk: int = 2048,
                  bail_after: int = 48, bail_yield: float = 1.5,
                  max_rounds=None) -> None:
    """One clustering round on ``st``, which first tests the host loop's
    end (no live row), bail and ``max_rounds`` and does nothing past it: on
    a CUDA device two launches of ``csrc/cluster_round.cu`` (the leaders,
    then the rows; nothing synced), on the CPU (or with ``plain``) the
    plain round ``_round_step_plain``."""
    _round_fn(enc, st, L, alpha, plain, chunk, bail_after, bail_yield,
              max_rounds)()


def _round_fn(enc, st, L, alpha, plain, chunk, bail_after, bail_yield,
              max_rounds):
    """``cluster_round``'s round as a function of no arguments, its checks
    and the kernel's arguments settled once."""
    if L < 1 or st.lead.shape[1] != L:
        raise ValueError(f"cluster_round: L={L} leaders, want at least 1 "
                         f"and the table's {st.lead.shape[1]}")
    dev = st.cluster.device
    if plain or dev.type == "cpu":
        alpha_lead, alpha_row = thresholds(alpha)

        def run():
            if _round_gate_plain(st, enc.n, L, bail_after, bail_yield,
                                 max_rounds):
                _round_step_plain(enc, st, L, alpha_lead, alpha_row, chunk)

        return run
    if dev.type != "cuda":
        raise ValueError(f"cluster_round: unsupported device {dev}")
    return _kernel_round(enc, st, L, alpha, bail_after, bail_yield,
                         max_rounds)


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
    rounds are plain.  ``plain`` takes the plain round on the card too;
    ``chunk`` bounds its rows at once.  Rounds are enqueued
    ``ROUNDS_PER_FETCH`` at a time, the state read once a batch.
    ``record``, a dict, receives ``rounds`` (counted as the host loop
    counts them), ``clusters`` (the clusters made by the end of each
    round that ran, read once at the end), ``rounds_enqueued``,
    ``fetches``, ``round_ms`` (on the card: each batch's device time by
    CUDA events around it, over the rounds it ran), ``device_ms`` (their
    sum), and host wall: ``setup_seconds`` (the encodings and the state
    on the device), ``loop_seconds`` (the rounds, from the first enqueue
    to the last read of the state) and ``seconds`` (all of it)."""
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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_loop = time.perf_counter()
    one_round = _round_fn(enc, st, L, alpha, plain, chunk, bail_after,
                          bail_yield, max_rounds)
    timed = record is not None and dev.type == "cuda"
    batch_ms, batch_rounds, enqueued, ran = [], [], 0, 0
    while True:
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        for _ in range(ROUNDS_PER_FETCH):
            one_round()
        enqueued += ROUNDS_PER_FETCH
        if timed:
            ev[1].record()
        # the batch's one fetch
        words = st.state.tolist()
        before, ran = ran, words[ROUNDS] - (words[DONE] == 2)
        batch_rounds.append(ran - before)
        if timed:
            batch_ms.append(ev[0].elapsed_time(ev[1]))
        if words[DONE]:
            break
    loop_seconds = time.perf_counter() - t_loop
    num_clusters, n_live = words[CLUSTERS], words[LIVE]
    if words[DONE] == 2:
        # the rest become singleton clusters in dispersion order
        live = st.cluster < 0
        st.cluster[live] = num_clusters + torch.arange(
            n_live, dtype=torch.int32, device=dev)
        num_clusters += n_live
    cluster_of[np.asarray(order, dtype=np.int64)] = st.cluster.cpu().numpy()
    if record is not None:
        record.update(rounds=words[ROUNDS],
                      clusters=st.made[:ran].cpu().tolist(),
                      rounds_enqueued=enqueued, fetches=len(batch_rounds),
                      round_ms=[ms / max(r, 1) for ms, r in
                                zip(batch_ms, batch_rounds)],
                      device_ms=sum(batch_ms),
                      setup_seconds=t_loop - t0, loop_seconds=loop_seconds,
                      seconds=time.perf_counter() - t0)
    return cluster_of, int(num_clusters)
