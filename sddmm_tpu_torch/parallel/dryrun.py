"""The multi-device dry run: ``dryrun_multichip(n_devices, backend, device)``.

Port of ``__graft_entry__.dryrun_multichip`` (which stays as it is): one
full distributed training step over an ('rows', 'feat') mesh of
``n_devices`` ranks (feat 2 where the count is even), at a size where every
rank holds several real units: ``block_clustered(96, 96, block_prob=0.08,
block_density=0.6, noise_density=0.002, seed=3)`` (1536 rows, 96 panels,
132,715 nnz) at K = 32.  Checks, as JAX's:

- every rank holds units, and the partition consulted the unit weights: its
  heaviest rank is no heavier than that of the cut into equal unit counts
  (a balancer that is right may well give equal counts, so the counts
  themselves are not compared);
- the loss is finite, and the distributed packed values at the initial
  parameters equal the single-device runner's (``HybridSDDMM(packed,
  "float32", k_chunks=2)``) bit for bit on every real slot, mapped through
  ``csr_dest`` and ``inv_idx``; where they do not, each feat rank's partial
  (before the all-reduce) must equal the single-device runner on its K
  slice bit for bit, and the sum be within one fp32 rounding (``bits``
  says which held);
- the loss equals the single-device one within 1e-6 relative;
- the packed step's collectives are one all-reduce over 'feat' of
  flat_local floats, and no all-gather;
- the dense class on the same mesh gives finite values (and 0 errors
  against the fp64 reference).
"""

from __future__ import annotations

import numpy as np
import torch

LR = 1e-2
K = 32


def dryrun_matrix():
    """The dry run's matrix: 96 row panels of skewed block counts plus
    background noise, so container weights vary by more than 10x."""
    from sddmm_tpu_torch.data import generate
    return generate.block_clustered(96, 96, block_prob=0.08,
                                    block_density=0.6, noise_density=0.002,
                                    seed=3)


def _rank(rank, world, packed, values, a_pad, bt_pad, shape, backend,
          device, dcsr, da, db):
    import torch.distributed as dist

    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.parallel.dist import (DistributedDenseSDDMM,
                                               DistributedHybridSDDMM)
    from sddmm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape, backend=backend, device=device)
    runner = DistributedHybridSDDMM(packed, mesh, device=device)
    targets, mask = runner.make_packed_targets(values)

    def param(x):
        return torch.tensor(runner.feat_slice(x), device=mesh.device,
                            requires_grad=True)

    a, bt = param(a_pad), param(bt_pad)
    _kernels.launches.clear()
    runner.collectives.clear()
    pred = runner.run_padded(*runner.device_prepare(a, bt), order="packed")
    step_log = list(runner.collectives)
    part = (torch.where(mask, pred - targets, 0.0) ** 2).sum() / packed.nnz
    part.backward()
    with torch.no_grad():
        a2, bt2 = a - LR * a.grad, bt - LR * bt.grad
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    loss = part.detach().clone()
    dist.all_reduce(loss, group=mesh.groups["rows"])
    with torch.no_grad():
        ops = runner.device_prepare(a.detach(), bt.detach())
        partial = runner.run_local(*ops)
        flat = runner.run_padded(*ops, order="packed")
    dense = DistributedDenseSDDMM.from_csr(dcsr, mesh, device=device)
    with torch.no_grad():
        dvals = dense(da, b=db)
    return dict(coords=mesh.coords, mesh=str(mesh), flat=flat.cpu().numpy(),
                partial=partial.cpu().numpy(), loss=float(loss),
                stepped=bool(torch.isfinite(a2).all()
                             and torch.isfinite(bt2).all()),
                ga=a.grad.cpu().numpy(), gbt=bt.grad.cpu().numpy(),
                step_log=step_log, launches=launches,
                dense=dvals.cpu().numpy(), flat_local=runner.plan.flat_local)


def weight_spread(plan):
    """(heaviest rank's unit weight / mean, the same for the cut into
    equal unit counts): the partition's balance against the naive one."""
    w = plan.unit_weight
    R = len(plan.window_bounds) - 1
    ours = np.array([w[plan.window_bounds[d]:plan.window_bounds[d + 1]].sum()
                     for d in range(R)])
    naive = np.array([p.sum() for p in np.array_split(w, R)])
    return float(ours.max() / ours.mean()), float(naive.max() / naive.mean())


def dryrun_multichip(n_devices: int, backend: str = "gloo", device="cuda",
                     timeout_s: float = 600.0, verbose: bool = True) -> dict:
    """Run the dry run over ``n_devices`` ranks (``launch.spawn``) on
    ``backend``, every rank on ``device`` (the card unless "cpu"; with
    "nccl" each rank takes card ``rank % device_count``), and check it;
    raise on any failed check.  Returns a summary (``bits``: "all slots"
    or "feat partials"; the per-rank results under ``ranks``)."""
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM, check_device
    from sddmm_tpu_torch.ops.reference import sddmm_reference
    from sddmm_tpu_torch.parallel.dist import _ShardPlan
    from sddmm_tpu_torch.parallel.launch import spawn
    from sddmm_tpu_torch.reorder.bsmr import BSMR
    from sddmm_tpu_torch.reorder.pack import pack
    from sddmm_tpu_torch.utils.check import check_values

    dev = check_device(device)
    feat = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    shape = (n_devices // feat, feat)
    csr = dryrun_matrix()
    packed = pack(csr, BSMR(0.3, 0.3, csr))
    if packed.num_panels < 64:
        raise AssertionError(f"{packed.num_panels} panels, want >= 64")
    plan = _ShardPlan(packed, shape[0])
    units = np.diff(plan.window_bounds)
    if not (units > 0).all():
        raise AssertionError(f"empty rank: units {units.tolist()}")
    spread, naive = weight_spread(plan)
    if spread > naive + 1e-12:
        raise AssertionError(f"unit weight spread {spread:.3f} worse than "
                             f"the equal-count cut's {naive:.3f}")
    rng = np.random.default_rng(0)
    a_pad = rng.standard_normal((csr.m + 1, K)).astype(np.float32)
    bt_pad = rng.standard_normal((csr.n + 1, K)).astype(np.float32)
    dcsr = generate.random_sparse(64, 64, density=0.3, seed=9)
    da = generate.make_dense(dcsr.m, K, seed=1)
    db = generate.make_dense(K, dcsr.n, seed=2)
    ranks = spawn(n_devices, _rank, (packed, csr.values, a_pad, bt_pad,
                                     shape, backend, device, dcsr, da, db),
                  backend=backend, timeout_s=timeout_s)

    for r in ranks:
        want = [dict(kind="all_reduce", group="feat", numel=r["flat_local"],
                     bytes=4 * r["flat_local"])]
        if r["step_log"] != want:
            raise AssertionError(f"rank {r['coords']}: the packed step "
                                 f"issued {r['step_log']}, want {want}")
        if not (np.isfinite(r["loss"]) and r["stepped"]):
            raise AssertionError(f"rank {r['coords']}: non-finite loss "
                                 f"{r['loss']} or step")
        res = check_values(sddmm_reference(da, db, dcsr), r["dense"])
        if not res.passed or res.num_errors:
            raise AssertionError(f"rank {r['coords']}: dense class {res}")
    # the single-device runner at the same parameters
    single = HybridSDDMM(packed, compute_dtype="float32", k_chunks=feat,
                         device=dev)
    with torch.no_grad():
        flat_1 = single.run_padded(*single.prepare_operands(
            a_pad[:-1], bt=bt_pad[:-1]), order="packed").cpu().numpy()
        kf = K // feat
        one = HybridSDDMM(packed, compute_dtype="float32", device=dev)
        part_1 = [one.run_padded(*one.prepare_operands(
            a_pad[:-1, f * kf:(f + 1) * kf],
            bt=bt_pad[:-1, f * kf:(f + 1) * kf]),
            order="packed").cpu().numpy() for f in range(feat)]
    n_real = n_eq = n_part_eq = n_part = 0
    worst_ulps = 0.0
    targets = np.asarray(csr.values, dtype=np.float32)
    loss_1 = np.float32(0.0)
    for r in ranks:
        row, f = r["coords"]["rows"], r["coords"].get("feat", 0)
        dest = plan.csr_dest[row]
        real = dest < packed.nnz
        slots = packed.inv_idx[dest[real]]
        got = r["flat"][real]
        p_got = r["partial"][real]
        n_part += int(real.sum())
        n_part_eq += int(np.count_nonzero(
            part_1[f][slots].view(np.uint32) == p_got.view(np.uint32)))
        if f:
            continue
        want = flat_1[slots]
        n_real += int(real.sum())
        n_eq += int(np.count_nonzero(want.view(np.uint32)
                                     == got.view(np.uint32)))
        worst_ulps = max(worst_ulps, float(np.max(
            np.abs(want - got) / np.spacing(np.abs(want)), initial=0.0)))
        loss_1 += np.sum((want - targets[dest[real]]) ** 2)
    if n_real != packed.nnz:
        raise AssertionError(f"{n_real} real slots, want {packed.nnz}")
    if n_eq == n_real:
        bits = "all slots"
    elif n_part_eq == n_part and worst_ulps <= 1.0:
        bits = "feat partials"
    else:
        raise AssertionError(
            f"multi-vs-single mismatch: {n_real - n_eq} of {n_real} real "
            f"slots differ (worst {worst_ulps:.1f} ulps), feat partials "
            f"{n_part - n_part_eq} of {n_part}")
    loss_1 = float(loss_1) / packed.nnz
    loss = ranks[0]["loss"]
    if abs(loss_1 - loss) > 1e-6 * max(abs(loss_1), 1.0):
        raise AssertionError(f"loss mismatch: single {loss_1} vs dist {loss}")
    summary = dict(mesh=dict(rows=shape[0], feat=shape[1]), backend=backend,
                   device=str(dev), m=csr.m, nnz=csr.nnz,
                   panels=packed.num_panels, units=units.tolist(),
                   weight_spread=spread, naive_spread=naive, loss=loss,
                   loss_single=loss_1, bits=bits, bit_equal=n_eq,
                   real_slots=n_real, worst_ulps=worst_ulps, ranks=ranks)
    if verbose:
        print(f"dryrun_multichip({n_devices}): mesh rows {shape[0]} x feat "
              f"{shape[1]} over {backend} on {dev}; m={csr.m} n={csr.n} "
              f"nnz={csr.nnz} panels={packed.num_panels} "
              f"units_per_rank={units.tolist()} weight spread "
              f"{spread:.3f} (equal counts {naive:.3f}) loss={loss:.6f} "
              f"single_vs_multi={bits} ({n_eq}/{n_real} slots bit-equal, "
              f"worst {worst_ulps:.1f} ulps) dense_ok OK", flush=True)
    return summary
