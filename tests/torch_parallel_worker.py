"""Rank functions of tests/test_torch_parallel.py.

``parallel.launch.spawn`` runs them in fresh processes, which import this
module by name: it imports torch and the port, never jax, so the ranks'
results come back as numpy and the test holds them against the JAX
package."""

import sys

import torch


def mesh_checks(rank, world, shape, cases, dense_case, fact_case):
    """Every check of one mesh shape in one spawn: per packing case and A
    layout the packed (flat_local,) output, its step's collectives and the
    CSR order; the dense class; the trainer's losses."""
    from sddmm_tpu_torch.models import DistributedSparseFactorizationModel
    from sddmm_tpu_torch.parallel import (DistributedDenseSDDMM,
                                          DistributedHybridSDDMM, make_mesh)

    torch.set_num_threads(1)   # the test workers run side by side
    mesh = make_mesh(shape, backend="gloo", device="cpu")
    out = {"coords": mesh.coords, "mesh": str(mesh)}
    for name, (packed, a, b, k_chunks) in cases.items():
        for layout in ("rows", "panels"):
            d = DistributedHybridSDDMM(packed, mesh, k_chunks=k_chunks,
                                       a_layout=layout, device="cpu")
            ops = d.prepare_operands(a, b=b)
            d.collectives.clear()
            out[name, layout, "packed"] = d.run_padded(*ops).numpy()
            out[name, layout, "log"] = list(d.collectives)
            out[name, layout, "csr"] = d.run_padded(*ops,
                                                    order="csr").numpy()
            out[name, layout, "balance"] = d.tile_balance()
    if dense_case is not None:
        dcsr, da, db = dense_case
        dd = DistributedDenseSDDMM.from_csr(dcsr, mesh, device="cpu")
        ops = dd.prepare_operands(da, b=db)
        dd.collectives.clear()
        out["dense_block"] = dd.run_padded(*ops).numpy()
        out["dense_log"] = list(dd.collectives)
        out["dense"] = dd.run_padded(*ops, order="csr").numpy()
    if fact_case is not None:
        packed, values, a0, bt0, k, steps = fact_case
        model = DistributedSparseFactorizationModel(packed, mesh, k,
                                                    device="cpu")
        model.load_params((a0, bt0))
        step = model.make_train_step()
        tp, mask = model.pack_targets(values)
        out["losses"] = [float(step(tp, mask)) for _ in range(steps)]
        _, out["fit_losses"] = model.fit(values, steps=2)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "sddmm_tpu"
                            or m.startswith("sddmm_tpu."))
    return out


def fail_on_rank(rank, world, bad):
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def imported_modules(rank, world):
    """sys.modules of a rank after importing the port's every package."""
    import sddmm_tpu_torch  # noqa: F401
    import sddmm_tpu_torch.models  # noqa: F401
    import sddmm_tpu_torch.parallel.dryrun  # noqa: F401
    import sddmm_tpu_torch.reorder.device_cluster  # noqa: F401
    return sorted(sys.modules)


def card_rows_mesh(rank, world, packed, a, b):
    """A (2, 1) mesh over gloo with CUDA tensors on one card: this rank's
    packed output, its rows coordinate and its kernels' launches."""
    from sddmm_tpu_torch import _kernels
    from sddmm_tpu_torch.parallel import DistributedHybridSDDMM, make_mesh

    mesh = make_mesh((world, 1), backend="gloo", device="cuda:0")
    d = DistributedHybridSDDMM(packed, mesh, device="cuda")
    ops = d.prepare_operands(a, b=b)
    _kernels.launches.clear()
    flat = d.run_padded(*ops)
    torch.cuda.synchronize()
    return dict(row=mesh.coords["rows"], flat=flat.cpu().numpy(),
                launches=dict(_kernels.launches), log=list(d.collectives))
