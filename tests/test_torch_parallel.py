"""The port's multi-device path (``sddmm_tpu_torch.parallel``) against the
JAX package's.

The shard plan is compared field for field at R = 1..4.  The ranks of each
mesh run in one ``launch.spawn`` over gloo on the CPU (their functions are
in ``torch_parallel_worker``, which imports no jax); the JAX side runs here
on conftest's 8 host devices.  Outputs are held to the reference's contract
(abs 1e-5 or rel 1e-3): the JAX package's "float32" contracts in full fp32
on the CPU, the port's "float32" instance sums six bf16 products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from sddmm_tpu.data import generate as jgen
from sddmm_tpu.models.factorization import \
    DistributedSparseFactorizationModel as JDistFact
from sddmm_tpu.parallel.dist import DistributedDenseSDDMM as JDense
from sddmm_tpu.parallel.dist import DistributedHybridSDDMM as JDist
from sddmm_tpu.parallel.dist import _ShardPlan as JPlan
from sddmm_tpu.parallel.mesh import make_mesh as j_make_mesh
from sddmm_tpu.reorder.autotune import from_params as j_from_params
from sddmm_tpu.reorder.bsmr import BSMR as JBSMR
from sddmm_tpu.reorder.cols import cluster_columns, hub_first_rank
from sddmm_tpu.reorder.pack import pack as j_pack
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.interop import packed_from_reference
from sddmm_tpu_torch.ops.reference import sddmm_reference
from sddmm_tpu_torch.parallel import launch
from sddmm_tpu_torch.parallel.dist import _ShardPlan
from sddmm_tpu_torch.parallel.dryrun import dryrun_multichip
from sddmm_tpu_torch.utils.check import check_values

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 32
MESHES = [(2, 1), (1, 2), (2, 2)]
PLAN_FIELDS = ("window_bounds", "rows_max", "a_rows_local", "panel_dev",
               "local_buckets", "tile_rows", "tile_gids", "run_pst",
               "rowslab_pad", "rowslab_width", "rowslab_rows_local",
               "res_rows", "res_gids", "res_member", "csr_dest",
               "flat_local")
SPAWN_TIMEOUT_S = 240


def _small():
    csr = jgen.block_clustered(16, 12, block_prob=0.2, seed=11)
    return csr, j_pack(csr, JBSMR(0.3, 0.3, csr))


def _hub():
    """G = 4, C = 2 and a 64-column hub slab (tests/test_parallel.py)."""
    csr = jgen.powerlaw_graph(256, avg_degree=10, seed=21)
    rank = hub_first_rank(csr, 64, base_order=cluster_columns(csr, 0.3))
    return csr, j_pack(csr, JBSMR(0.3, 0.05, csr, group_size=4,
                                  col_rank=rank, hub_cols=64))


def _rowslab():
    """A hub and a hot-row slab (tests/test_parallel.py)."""
    csr = jgen.powerlaw_graph(1024, avg_degree=12, seed=7)
    return csr, j_from_params(csr, K, alpha=0.1, delta=0.05, hub_cols=128,
                              hot_rows=64, hot_rows_pre=True).packed


def _dryrun():
    csr = jgen.block_clustered(96, 96, block_prob=0.08, block_density=0.6,
                               noise_density=0.002, seed=3)
    return csr, j_pack(csr, JBSMR(0.3, 0.3, csr))


CASES = {"small": (_small, 0), "hub": (_hub, 2), "rowslab": (_rowslab, 0)}


def _cases(shape):
    """The packings run on a mesh: all three on (2, 2), the small one on
    the others (the hub's G = 4, C = 2 and the slabs need both axes at
    once to be split both ways)."""
    return list(CASES) if shape == (2, 2) else ["small"]


@pytest.fixture(scope="module")
def packings():
    out = {}
    for name, (make, k_chunks) in CASES.items():
        csr, packed = make()
        out[name] = (csr, packed, packed_from_reference(packed),
                     jgen.make_dense(csr.m, K, seed=1),
                     jgen.make_dense(K, csr.n, seed=2), k_chunks)
    return out


def _jmesh(shape):
    return j_make_mesh(shape, ("rows", "feat"),
                       devices=jax.devices()[:shape[0] * shape[1]])


def _dense_csr():
    """The port's CSR (a JAX package CSR would import jax in a rank when
    it is unpickled there)."""
    csr = jgen.random_sparse(100, 96, density=0.3, seed=21)
    return TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)


_RUNS = {}


@pytest.fixture(scope="module")
def mesh_run(packings):
    """The ranks' results of one mesh shape, spawned once (all its checks
    in that one spawn), and the JAX package's outputs to hold them to."""
    def run(shape):
        if shape in _RUNS:
            return _RUNS[shape]
        cases = {name: packings[name][2:] for name in _cases(shape)}
        dcsr = _dense_csr()
        da, db = (jgen.make_dense(dcsr.m, K, seed=3),
                  jgen.make_dense(K, dcsr.n, seed=4))
        fact = None
        if shape == (2, 2):
            fcsr, jp, tp = packings["small"][:3]
            jmodel = JDistFact(jp, _jmesh(shape), 16)
            params = jmodel.init(jax.random.PRNGKey(0))
            fact = (tp, fcsr.values, np.asarray(params.a),
                    np.asarray(params.bt), 16, 5)
        ranks = launch.spawn(shape[0] * shape[1], worker.mesh_checks,
                             (shape, cases, (dcsr, da, db), fact),
                             backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
        want = {}
        for name in _cases(shape):
            _, jp, _, a, b, kc = packings[name]
            for layout in ("rows", "panels"):
                jd = JDist(jp, _jmesh(shape), k_chunks=kc, a_layout=layout)
                ops = jd.prepare_operands(a, b=b)
                want[name, layout] = (
                    np.asarray(jd.run_padded(*ops, order="packed")),
                    np.asarray(jd.run_padded(*ops, order="csr")),
                    jd.plan.csr_dest, jp.nnz)
        jdd = JDense.from_csr(jgen.random_sparse(100, 96, density=0.3,
                                                 seed=21), _jmesh(shape))
        want["dense"] = np.asarray(jdd(da, b=db))
        want["dense_ref"] = sddmm_reference(da, db, dcsr)
        if fact is not None:
            _, losses = _jax_fit(jmodel, params, fcsr.values, 5)
            want["losses"] = losses
        _RUNS[shape] = (ranks, want)
        return _RUNS[shape]

    return run


def _jax_fit(model, params, values, steps):
    opt_state = model.optimizer.init(params)
    step = model.make_train_step()
    tp, mask = model.pack_targets(values)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tp, mask)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("R", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["dryrun", "hub", "rowslab"])
def test_shard_plan_matches_jax(case, R):
    """Field for field, including the hot-row slot hot_index*S + rank."""
    csr, jp = {"dryrun": _dryrun, "hub": _hub, "rowslab": _rowslab}[case]()
    want = JPlan(jp, R)
    got = _ShardPlan(packed_from_reference(jp), R)
    for field in PLAN_FIELDS:
        w, g = getattr(want, field), getattr(got, field)
        if isinstance(w, dict):
            assert w.keys() == g.keys(), field
            for key in w:
                assert np.array_equal(np.asarray(w[key]),
                                      np.asarray(g[key])), (field, key)
        else:
            assert np.array_equal(np.asarray(w), np.asarray(g)), field


@pytest.mark.parametrize("layout", ["rows", "panels"])
@pytest.mark.parametrize("case,shape", [(case, shape) for shape in MESHES
                                        for case in _cases(shape)])
def test_rank_outputs_match_jax(mesh_run, case, shape, layout):
    """Each rank's (flat_local,) output against the JAX runner's row for
    its rows coordinate, on every real slot; CSR order against JAX's."""
    ranks, want = mesh_run(shape)
    packed_j, csr_j, dest, nnz = want[case, layout]
    for r in ranks:
        row = r["coords"]["rows"]
        real = dest[row] < nnz
        res = check_values(packed_j[row][real],
                           r[case, layout, "packed"][real])
        assert res.passed and not res.num_errors, (r["coords"], res)
        res = check_values(csr_j, r[case, layout, "csr"])
        assert res.passed and not res.num_errors, (r["coords"], res)


@pytest.mark.parametrize("shape", MESHES)
def test_packed_step_collectives(mesh_run, shape):
    """The packed step issues exactly one all-reduce over 'feat' of
    flat_local floats and no all-gather; the dense class one all-reduce
    of its (M/R, N) block."""
    ranks, want = mesh_run(shape)
    for r in ranks:
        for case in _cases(shape):
            for layout in ("rows", "panels"):
                n = r[case, layout, "packed"].shape[0]
                assert r[case, layout, "log"] == [dict(
                    kind="all_reduce", group="feat", numel=n,
                    bytes=4 * n)], (case, layout)
        n = r["dense_block"].size
        assert r["dense_log"] == [dict(kind="all_reduce", group="feat",
                                       numel=n, bytes=4 * n)]


@pytest.mark.parametrize("shape", MESHES)
def test_dense_class_matches_jax(mesh_run, shape):
    ranks, want = mesh_run(shape)
    for r in ranks:
        for ref in (want["dense"], want["dense_ref"]):
            res = check_values(ref, r["dense"])
            assert res.passed and not res.num_errors, (r["coords"], res)


@pytest.mark.parametrize("shape", MESHES)
def test_balance_and_ranks_import_no_jax(mesh_run, shape, packings):
    """Every entry sits on exactly one rows rank; the spawned ranks never
    loaded jax or the JAX package."""
    ranks, _ = mesh_run(shape)
    for r in ranks:
        assert r["modules"] == [], r["modules"]
        for case in _cases(shape):
            bal = r[case, "rows", "balance"]
            assert bal.shape == (shape[0],)
            assert bal.sum() == packings[case][0].nnz


def test_factorization_losses_match_jax(mesh_run):
    """Five Adam steps of the distributed trainer on (2, 2) from the JAX
    model's initial factors: the same losses within 1e-5 relative."""
    ranks, want = mesh_run((2, 2))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        # fit from its own seeded start: finite, the same on every rank
        assert np.isfinite(r["fit_losses"]).all()
        assert r["fit_losses"] == ranks[0]["fit_losses"]


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(4, backend="gloo", device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S, verbose=False)


def test_dryrun_multichip_cpu(dryrun):
    """The dry run over (2, 2) on the CPU: its own checks pass, and every
    real slot equals the single-device runner bit for bit."""
    assert dryrun["mesh"] == dict(rows=2, feat=2)
    assert dryrun["bits"] == "all slots"
    assert dryrun["bit_equal"] == dryrun["real_slots"] == dryrun["nnz"]
    assert np.isfinite(dryrun["loss"])
    assert dryrun["weight_spread"] <= dryrun["naive_spread"]


def test_dryrun_gradients_match_jax_grad(dryrun):
    """The dry run's parameter gradients (summed over 'rows' in the
    backward) against jax.grad of the JAX dry run's loss on a (2, 2) mesh,
    on the real rows (the pads' rows differ by design: the port's backward
    leaves them out)."""
    csr, jp = _dryrun()
    jd = JDist(jp, _jmesh((2, 2)))
    rng = np.random.default_rng(0)
    a_pad = jnp.asarray(rng.standard_normal((csr.m + 1, K)),
                        dtype=jnp.float32)
    bt_pad = jnp.asarray(rng.standard_normal((csr.n + 1, K)),
                         dtype=jnp.float32)
    targets, mask = jd.make_packed_targets(csr.values)

    def loss_fn(a_pad, bt_pad):
        pred = jd.run_padded(*jd.device_prepare(a_pad, bt_pad),
                             order="packed")
        return jnp.sum(jnp.where(mask, pred - targets, 0.0) ** 2) / jp.nnz

    loss, (ga, gbt) = jax.value_and_grad(loss_fn, argnums=(0, 1))(a_pad,
                                                                  bt_pad)
    ga, gbt = np.asarray(ga), np.asarray(gbt)
    assert abs(dryrun["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    kf = K // 2
    for r in dryrun["ranks"]:
        f = r["coords"]["feat"]
        cols = slice(f * kf, (f + 1) * kf)
        for got, want, n in ((r["ga"], ga, csr.m), (r["gbt"], gbt, csr.n)):
            res = check_values(want[:n, cols], got[:n])
            assert res.passed and not res.num_errors, (r["coords"], res)


def test_spawn_raises_a_rank_failure():
    """A rank's exception reaches the parent, naming the rank."""
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        launch.spawn(2, worker.fail_on_rank, (1,), backend="gloo",
                     timeout_s=60)
