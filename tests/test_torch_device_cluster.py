"""The port's device row clustering (``reorder/device_cluster.py``) against
the JAX package's, on the CPU, where a round is the kernel's plain version.

Equality is exact: the same ``cluster_of`` and cluster count as JAX's
``batched_cluster_device`` and as the host ``rows._batched_cluster(...,
hat_dtype=np.float32)``, on the cases of tests/test_device_cluster.py."""

import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.reorder import rows as jrows
from sddmm_tpu.reorder.device_cluster import \
    batched_cluster_device as j_batched_cluster_device
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.reorder import device_cluster as dc
from sddmm_tpu_torch.reorder import rows as trows
from torch_native_ready import reference_native_loaded  # noqa: F401

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GENERATORS = {
    "block_clustered": lambda: jgen.block_clustered(
        24, 24, block_prob=0.15, block_density=0.6, noise_density=1e-3,
        seed=51),
    "banded": lambda: jgen.banded(512, 512, bandwidth=12, fill=0.6, seed=52),
    "powerlaw": lambda: jgen.powerlaw_graph(384, avg_degree=8, seed=53),
    "hypersparse_dense_mix": lambda: jgen.hypersparse_dense_mix(
        512, 512, density=2e-3, num_dense_rows=4, num_dense_cols=4,
        seed=54),
}


def _prep(csr, col_block_size=16):
    bp, bi, bc, nb = jrows.row_encodings(csr, col_block_size)
    disp = jrows.dispersion_scores(csr, bp, bc, col_block_size)
    nonempty = np.nonzero(disp > 0)[0]
    order = nonempty[np.argsort(disp[nonempty], kind="stable")]
    return order, bp, bi, bc, nb


@pytest.mark.parametrize("alpha", [0.3, 0.5])
@pytest.mark.parametrize("gen", list(GENERATORS))
def test_device_cluster_matches_jax_and_host(gen, alpha):
    args = _prep(GENERATORS[gen]())
    host_cl, host_n = jrows._batched_cluster(*args, alpha,
                                             hat_dtype=np.float32)
    jax_cl, jax_n = j_batched_cluster_device(*args, alpha, chunk=256)
    got_cl, got_n = dc.batched_cluster_device(*args, alpha, chunk=256,
                                              device="cpu")
    assert got_n == host_n == jax_n
    assert np.array_equal(got_cl, host_cl)
    assert np.array_equal(got_cl, jax_cl)
    # the port's own copy of the host algorithm agrees too
    port_cl, port_n = trows._batched_cluster(*args, alpha,
                                             hat_dtype=np.float32)
    assert port_n == got_n and np.array_equal(port_cl, got_cl)


def test_device_cluster_bail_matches():
    """The early bail (unclusterable rows become singletons) fires as in
    the host and the JAX versions."""
    args = _prep(jgen.powerlaw_graph(2048, avg_degree=6, seed=55))
    kw = dict(leaders_per_round=8, bail_after=3, bail_yield=4.0)
    host_cl, host_n = jrows._batched_cluster(*args, 0.5, **kw,
                                             hat_dtype=np.float32)
    jax_cl, jax_n = j_batched_cluster_device(*args, 0.5, **kw, chunk=512)
    record = {}
    got_cl, got_n = dc.batched_cluster_device(*args, 0.5, **kw, chunk=512,
                                              device="cpu", record=record)
    assert got_n == host_n == jax_n
    assert np.array_equal(got_cl, host_cl) and np.array_equal(got_cl, jax_cl)
    # rounds counted as the host counts them; no device times on the CPU
    assert record["rounds"] > 3 and record["round_ms"] == []


def test_device_cluster_empty_and_single():
    args = _prep(jgen.block_clustered(2, 2, block_prob=1.0, seed=56))
    host_cl, host_n = jrows._batched_cluster(*args, 0.3,
                                             hat_dtype=np.float32)
    got_cl, got_n = dc.batched_cluster_device(*args, 0.3, chunk=64,
                                              device="cpu")
    assert got_n == host_n and np.array_equal(got_cl, host_cl)
    order, bp, bi, bc, nb = args
    got0, n0 = dc.batched_cluster_device(np.zeros(0, dtype=np.int64), bp,
                                         bi, bc, nb, 0.3, device="cpu")
    assert n0 == 0 and np.all(got0 == -1)
    # one row: one cluster
    one, n1 = dc.batched_cluster_device(order[:1], bp, bi, bc, nb, 0.3,
                                        device="cpu")
    assert n1 == 1 and one[order[0]] == 0 and (one >= 0).sum() == 1


@pytest.mark.parametrize("L", [4, 32, 40])
def test_leaders_per_round_and_dense_rows(L):
    """Leader counts below, at and above a warp's 32 lanes, on a matrix
    with dense rows (long encodings: the pairwise sum's halves)."""
    csr = jgen.hypersparse_dense_mix(512, 4096, density=2e-3,
                                     num_dense_rows=6, num_dense_cols=4,
                                     seed=57)
    args = _prep(csr)
    assert np.diff(args[1]).max() > 128
    host_cl, host_n = jrows._batched_cluster(*args, 0.3,
                                             leaders_per_round=L,
                                             hat_dtype=np.float32)
    got_cl, got_n = dc.batched_cluster_device(*args, 0.3,
                                              leaders_per_round=L,
                                              device="cpu")
    assert got_n == host_n and np.array_equal(got_cl, host_cl)


def test_kernel_leader_cap():
    """The kernel takes up to MAX_LEADERS (at least 512) candidates a round,
    the C entry's kMaxLeaders; above it the card's round raises naming the
    cap, and nothing routes it to the plain round."""
    import re
    from pathlib import Path
    src = (Path(dc.__file__).parents[1] / "csrc" / "cluster_round.cu"
           ).read_text()
    assert int(re.search(r"kMaxLeaders = (\d+);", src).group(1)) \
        == dc.MAX_LEADERS >= 512
    assert dc.STATE_WORDS == dc.MASK + dc.MAX_LEADERS // 32
    for L in (1, 64, 65, 96, 256, dc.MAX_LEADERS):
        dc.check_leaders(L)
    with pytest.raises(ValueError, match=f"MAX_LEADERS={dc.MAX_LEADERS}"):
        dc.check_leaders(dc.MAX_LEADERS + 1)


@pytest.mark.parametrize("L", [65, 96])
def test_mask_words_of_a_round(L):
    """A round of more than 64 candidates leaves its accepted mask in the
    state's words from MASK, 32 candidates a word, as the kernel does."""
    args = _prep(GENERATORS["powerlaw"]())
    enc = dc.encodings(*args, torch.device("cpu"))
    st = dc.RoundState.start(enc, L)
    lead, row = dc.thresholds(0.5)
    st.state[dc.ROUNDS] = 1
    dc._round_step_plain(enc, st, L, lead, row)
    words = st.state.tolist()
    cand = st.cand_pos[:words[dc.CANDS]].tolist()
    cl = st.cluster[cand].tolist()
    # a candidate is accepted iff its cluster id is new among those before
    accepted = [c not in cl[:i] for i, c in enumerate(cl)]
    mask = sum(int(np.int32(words[dc.MASK + w]).view(np.uint32)) << (32 * w)
               for w in range(-(-L // 32)))
    assert len(cand) == L
    assert [(mask >> i) & 1 == 1 for i in range(L)] == accepted
    assert words[dc.CLUSTERS] == sum(accepted)


def test_pairwise_sum_is_numpys():
    """The plain round's sum takes numpy's float32 pairwise order, add for
    add, at every length the kernel may meet."""
    rng = np.random.default_rng(0)
    for n in list(range(1, 300)) + [511, 512, 1000, 2048, 3001]:
        x = (rng.random((3, n)) * rng.random((3, n)) ** 3).astype(
            np.float32)
        got = dc.pairwise_sum(torch.as_tensor(x)).numpy()
        assert np.array_equal(got.view(np.uint32),
                              x.sum(axis=1).view(np.uint32)), n


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.25, 0.1])
def test_thresholds(alpha):
    """The leaders' threshold is float32(alpha); the rows' the largest
    float32 not above alpha, so ``s > row`` iff ``float64(s) > alpha``."""
    lead, row = dc.thresholds(alpha)
    assert lead == float(np.float32(alpha))
    assert row <= alpha and np.float32(row) == row
    up = np.nextafter(np.float32(row), np.float32(np.inf))
    assert float(up) > alpha


def test_row_reordering_device_matches_jax():
    """method="device" through the row reordering: the same order and
    clusters as the JAX package's."""
    csr = jgen.block_clustered(64, 32, block_prob=0.1, block_density=0.6,
                               noise_density=1e-3, seed=58)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    want = jrows.row_reordering(csr, 0.3, method="device")
    got = trows.row_reordering(tcsr, 0.3, method="device", device="cpu")
    assert got.num_clusters == want.num_clusters
    assert np.array_equal(got.reordered_rows, want.reordered_rows)
    assert np.array_equal(got.cluster_ids, want.cluster_ids)


@pytest.mark.parametrize("env", ["0", "1", None])
def test_device_cluster_viable_parity(monkeypatch, env):
    """The kill switch SDDMM_TPU_DEVICE_CLUSTER routes both packages alike
    at the JAX test's points; on the CPU neither picks the device by
    default."""
    if env is None:
        monkeypatch.delenv("SDDMM_TPU_DEVICE_CLUSTER", raising=False)
    else:
        monkeypatch.setenv("SDDMM_TPU_DEVICE_CLUSTER", env)
    m_huge = jrows.DEVICE_CLUSTER_HAT_BUDGET // (4 * 64) + 4096
    for m, nb in ((200_000, 64), (m_huge, 64), (1000, 16)):
        assert (trows._device_cluster_viable(m, nb)
                == jrows._device_cluster_viable(m, nb)), (env, m, nb)


def test_device_cluster_budget_counts_the_encodings(monkeypatch):
    """The port's budget counts what the kernel keeps on the card: 8 bytes
    an occupied (row, block) pair, 16 a row and the leader table, not the
    dense (m, B) hats."""
    monkeypatch.setenv("SDDMM_TPU_DEVICE_CLUSTER", "1")
    budget = trows.DEVICE_CLUSTER_HAT_BUDGET
    m, nb = 1_000_000, 65536          # dense hats: 262 GB
    assert 4 * m * nb > budget
    assert trows._device_cluster_viable(m, nb, n_pairs=8 * m)
    assert not trows._device_cluster_viable(m, nb)  # worst case m * B
    assert trows._device_cluster_bytes(m, nb, 8 * m) == (
        64 * m + 16 * (m + 1) + 4 * nb * 32)


@pytest.mark.parametrize("env", ["0", None])
def test_route_by_cost_parity(monkeypatch, env):
    """With the device path off (kill switch, or no card) both packages
    route every sample alike."""
    if env is None:
        monkeypatch.delenv("SDDMM_TPU_DEVICE_CLUSTER", raising=False)
    else:
        monkeypatch.setenv("SDDMM_TPU_DEVICE_CLUSTER", env)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the port may route to it")
    for t in (1e-5, 1e-3, 0.05, 0.5, 5.0):
        for n in (10_000, 200_000, 500_000):
            for nb in (64, 512, 4096):
                assert (trows._route_by_cost(t, n, n, nb)
                        == jrows._route_by_cost(t, n, n, nb)), (t, n, nb)


def test_route_by_cost_picks_device_when_cheaper(monkeypatch):
    """Forced on, the device route is taken where its price (the port's
    measured constant per cell) beats the host estimate, and not where it
    does not."""
    monkeypatch.setenv("SDDMM_TPU_DEVICE_CLUSTER", "1")
    monkeypatch.setattr(trows, "DEVICE_CLUSTER_S_PER_CELL", 1e-9)
    assert trows._route_by_cost(50.0, 200_000, 200_000, 512) == "device"
    monkeypatch.setattr(trows, "DEVICE_CLUSTER_S_PER_CELL", 1.0)
    assert trows._route_by_cost(50.0, 200_000, 200_000, 512) != "device"


@pytest.mark.parametrize("alpha", [0.3, 0.5])
@pytest.mark.parametrize("gen", list(GENERATORS))
def test_bitmask_round_matches_sequential(gen, alpha, monkeypatch):
    """The kernel's organisation of a round in torch ops (every candidate
    in its own column, the pairs' similarity bits, ``dedup_bitmask``), put
    in place of the plain round, gives the sequential dedup's clusters and
    the host's."""
    args = _prep(GENERATORS[gen]())
    host_cl, host_n = jrows._batched_cluster(*args, alpha,
                                             hat_dtype=np.float32)
    rec_s, rec_b = {}, {}
    seq = dc.batched_cluster_device(*args, alpha, chunk=256, device="cpu",
                                    record=rec_s)
    monkeypatch.setattr(dc, "_round_step_plain", dc._round_step_bitmask)
    bit = dc.batched_cluster_device(*args, alpha, chunk=256, device="cpu",
                                    record=rec_b)
    assert bit[1] == seq[1] == host_n
    assert np.array_equal(bit[0], seq[0]) and np.array_equal(bit[0], host_cl)
    assert rec_b["rounds"] == rec_s["rounds"]
    assert rec_b["clusters"] == rec_s["clusters"]


@pytest.mark.parametrize("L", [4, 32, 40, 96])
def test_bitmask_round_leaders_per_round(L, monkeypatch):
    """The bitmask round, in place of the plain round, at candidate counts
    below, at and above a warp's 32 lanes, on dense rows (the pairwise
    sum's halves)."""
    csr = jgen.hypersparse_dense_mix(512, 4096, density=2e-3,
                                     num_dense_rows=6, num_dense_cols=4,
                                     seed=57)
    args = _prep(csr)
    host_cl, host_n = jrows._batched_cluster(*args, 0.3,
                                             leaders_per_round=L,
                                             hat_dtype=np.float32)
    monkeypatch.setattr(dc, "_round_step_plain", dc._round_step_bitmask)
    got_cl, got_n = dc.batched_cluster_device(*args, 0.3,
                                              leaders_per_round=L,
                                              device="cpu")
    assert got_n == host_n and np.array_equal(got_cl, host_cl)


def _sequential_dedup(sim_rows):
    """JAX's fori dedup (``_round_step``'s ``dedup``) on an (n, n) bool
    matrix: (accepted, cluster offset of each candidate)."""
    n = len(sim_rows)
    accepted = np.zeros(n, dtype=bool)
    offset = np.zeros(n, dtype=np.int64)
    for i in range(n):
        hits = sim_rows[i] & accepted & (np.arange(n) < i)
        accepted[i] = not hits.any()
        lead = i if accepted[i] else int(np.argmax(hits))
        offset[i] = int(accepted[:lead].sum())
    return accepted, offset


@pytest.mark.parametrize("n", [1, 2, 7, 32, 40, 64, 96])
def test_dedup_bitmask_matches_sequential(n):
    """The bit operations' dedup equals the sequential one on random
    similarity matrices, dense and sparse."""
    rng = np.random.default_rng(n)
    for p in (0.05, 0.3, 0.8):
        sim = rng.random((n, n)) < p
        bits = [sum(1 << j for j in range(i) if sim[i, j]) for i in range(n)]
        mask, cid = dc.dedup_bitmask(bits)
        accepted, offset = _sequential_dedup(sim)
        assert [(mask >> i) & 1 for i in range(n)] == accepted.tolist()
        assert cid == offset.tolist()


def _todays_loop(args, alpha, L=32, max_rounds=None, bail_after=48,
                 bail_yield=1.5):
    """The host round loop as it stood with one fetch a round (the test a
    round on the host, the plain round after it): (cluster_of, clusters,
    rounds, clusters made by each round)."""
    order, bp, bi, bc, nb = args
    enc = dc.encodings(order, bp, bi, bc, nb, torch.device("cpu"))
    st = dc.RoundState.start(enc, L)
    lead, row = dc.thresholds(alpha)
    made, rounds, n_live, num = [], 0, enc.n, 0
    while n_live:
        rounds += 1
        assigned = enc.n - n_live
        if ((rounds > bail_after and assigned < bail_yield * L * rounds)
                or (max_rounds is not None and rounds > max_rounds)):
            live = st.cluster < 0
            st.cluster[live] = num + torch.arange(n_live, dtype=torch.int32)
            num += n_live
            break
        st.state[dc.ROUNDS] = rounds
        dc._round_step_plain(enc, st, L, lead, row, 256)
        num, n_live = st.state[:2].tolist()
        made.append(num)
    cluster_of = np.full(bp.shape[0] - 1, -1, dtype=np.int64)
    cluster_of[order] = st.cluster.numpy()
    return cluster_of, num, rounds, made


@pytest.mark.parametrize("case", ["runs out", "bail", "max_rounds"])
@pytest.mark.parametrize("per_fetch", [1, 3, 32])
def test_batched_round_loop_matches_todays(case, per_fetch, monkeypatch):
    """Rounds enqueued in batches, each testing the end, the bail and
    max_rounds itself, give today's loop's cluster_of, rounds and clusters
    a round, whatever the batch size; rounds past the end do nothing."""
    if case == "runs out":
        args = _prep(GENERATORS["block_clustered"]())
        kw = dict(L=32)
    elif case == "bail":
        args = _prep(jgen.powerlaw_graph(2048, avg_degree=6, seed=55))
        kw = dict(L=8, bail_after=3, bail_yield=4.0)
    else:
        args = _prep(GENERATORS["banded"]())
        kw = dict(L=4, max_rounds=5)
    want_cl, want_n, want_rounds, want_made = _todays_loop(args, 0.5, **kw)
    record = {}
    L = kw.pop("L")
    monkeypatch.setattr(dc, "ROUNDS_PER_FETCH", per_fetch)
    got_cl, got_n = dc.batched_cluster_device(
        *args, 0.5, leaders_per_round=L, chunk=256, device="cpu",
        record=record, **kw)
    assert got_n == want_n and np.array_equal(got_cl, want_cl)
    assert record["rounds"] == want_rounds
    assert record["clusters"] == want_made
    assert record["fetches"] == -(-record["rounds_enqueued"] // per_fetch)
    assert record["rounds_enqueued"] >= len(want_made)
    if case != "runs out":
        assert len(want_made) < want_rounds  # the loop ended early

