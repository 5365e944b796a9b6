"""The port's factorization trainer (``models.factorization``) and its
checkpointer (``utils.checkpoint``) against the JAX package's, on the CPU:
the losses of the first steps from JAX's initial factors, the loss falling
by half as in ``tests/test_models.py``, and a checkpointed fit resuming at
its latest step."""

import os

import jax
import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.models.factorization import (
    SparseFactorizationModel as JaxFactorization)
from sddmm_tpu_torch import interop
from sddmm_tpu_torch.data import generate
from sddmm_tpu_torch.data.sparse import CSR as TCSR
from sddmm_tpu_torch.models import (FactorizationParams,
                                    SparseFactorizationModel)
from sddmm_tpu_torch.utils.checkpoint import Checkpointer
from torch_native_ready import reference_native_loaded  # noqa: F401

# the losses of JAX and the port from the same factors: the forward within
# about one fp32 rounding, the gradients summed in another order, and Adam's
# first steps (about lr * sign(g)) move every factor alike
LOSS_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (at 8 threads a worker the trainer's steps
    took 4x the time of one thread, alone and more so beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fit_halves_the_loss():
    """tests/test_models.py:12-17 on the port."""
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=21)
    model = SparseFactorizationModel.from_csr(csr, k=16, learning_rate=0.05,
                                              device="cpu")
    params, losses = model.fit(csr.values, steps=60)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert np.isfinite(losses).all() and len(losses) == 60
    assert isinstance(params, FactorizationParams)
    assert params.a.shape == (csr.m, 16) and params.bt.shape == (csr.n, 16)


def test_first_losses_match_jax_train_step():
    """From the JAX model's initial factors (carried by interop), the
    losses of the first 5 train steps (forward, backward through the
    hybrid's read pattern, Adam) match JAX's make_train_step."""
    csr = jgen.block_clustered(8, 8, block_prob=0.4, seed=5)
    tgt = np.random.default_rng(0).standard_normal(csr.nnz).astype(
        np.float32)
    jm = JaxFactorization.from_csr(csr, 8, learning_rate=0.05)
    params = jm.init(jax.random.PRNGKey(3))
    opt_state = jm.optimizer.init(params)
    step = jm.make_train_step()
    tp = jm.pack_targets(tgt)
    want = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, tp)
        want.append(float(loss))
    model = SparseFactorizationModel(
        interop.packed_from_reference(jm.packed), 8, learning_rate=0.05,
        device="cpu")
    interop.factorization_params_from_reference(jm.init(
        jax.random.PRNGKey(3)), model)
    tstep = model.make_train_step()
    ttp = model.pack_targets(tgt)
    got = [float(tstep(ttp)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    assert got[-1] < got[0]


def test_forward_and_loss_match_jax():
    """forward in both orders and the weighted packed-slot loss on the
    same factors; pack_targets puts the targets at the real slots."""
    csr = jgen.block_clustered(8, 8, block_prob=0.4, seed=5)
    tgt = np.random.default_rng(1).standard_normal(csr.nnz).astype(
        np.float32)
    jm = JaxFactorization.from_csr(csr, 8)
    params = jm.init(jax.random.PRNGKey(0))
    model = SparseFactorizationModel(
        interop.packed_from_reference(jm.packed), 8, device="cpu")
    interop.factorization_params_from_reference(params, model)
    with torch.no_grad():
        got = model(order="csr").numpy()
        loss = float(model.loss(model.pack_targets(tgt)))
    want = np.asarray(jm.forward(params, order="csr"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss, float(jm.loss(params,
                                                   jm.pack_targets(tgt))),
                               rtol=LOSS_REL)
    tp = model.pack_targets(tgt).numpy()
    assert np.array_equal(tp[jm.packed.inv_idx], tgt)
    with pytest.raises(ValueError, match="weight"):
        interop.factorization_params_from_reference(
            params._replace(a=np.zeros((3, 8))), model)


def test_checkpoint_resume(tmp_path):
    """tests/test_models.py:138-151 on the port: a fresh model resumes
    from the latest saved step and runs only steps 21..30; the resumed
    state is the saved one (factors and Adam's moments)."""
    csr = generate.block_clustered(8, 8, block_prob=0.4, seed=5)
    tgt = np.random.default_rng(0).standard_normal(csr.nnz).astype(
        np.float32)
    d = str(tmp_path / "ck")
    m = SparseFactorizationModel.from_csr(csr, 8, device="cpu")
    p1, l1 = m.fit(tgt, steps=20, checkpoint_dir=d, checkpoint_every=10)
    assert len(l1) == 20 and Checkpointer(d).all_steps() == [10, 20]
    m2 = SparseFactorizationModel.from_csr(csr, 8, device="cpu")
    p2, l2 = m2.fit(tgt, steps=30, checkpoint_dir=d, checkpoint_every=10)
    assert len(l2) == 10  # only steps 21..30 ran
    assert np.isfinite(m2(order="packed").detach().numpy()).all()
    # the same 30 steps in one fit give the same losses from step 21 on
    m3 = SparseFactorizationModel.from_csr(csr, 8, device="cpu")
    _, l3 = m3.fit(tgt, steps=30)
    np.testing.assert_allclose(l2, l3[20:], rtol=1e-6)
    assert Checkpointer(d).latest_step == 30


def test_checkpointer_keeps_the_newest(tmp_path):
    ck = Checkpointer(tmp_path / "c", keep=2)
    assert ck.latest_step is None and ck.restore() is None
    for step in (5, 10, 15):
        ck.save(step, {"x": torch.full((2,), float(step)), "step": step})
    assert ck.all_steps() == [10, 15]
    assert ck.restore()["step"] == 15
    assert torch.equal(ck.restore(step=10)["x"], torch.full((2,), 10.0))
    assert sorted(os.listdir(tmp_path / "c")) == ["step_10.pt",
                                                  "step_15.pt"]
    with pytest.raises(FileNotFoundError):
        ck.restore(step=5)
    with pytest.raises(ValueError):
        Checkpointer(tmp_path / "d", keep=0)


def test_train_step_moves_both_factors():
    """The loss carries the runner's autograd op: both factors get a
    gradient, and a train step moves both."""
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=2)
    model = SparseFactorizationModel.from_csr(csr, 8, device="cpu")
    model.init(torch.Generator().manual_seed(1))
    tp = model.pack_targets(csr.values)
    loss = model.loss(tp)
    assert loss.grad_fn is not None
    loss.backward()
    assert model.a.grad.abs().max() > 0 and model.bt.grad.abs().max() > 0
    before = [w.detach().clone() for w in (model.a, model.bt)]
    model.make_train_step()(tp)
    assert all(not torch.equal(b, w) for b, w in zip(before, (model.a,
                                                              model.bt)))


def test_port_csr_type_is_accepted():
    csr = jgen.block_clustered(8, 8, block_prob=0.3, seed=2)
    tcsr = TCSR(csr.shape, csr.row_ptr, csr.col_idx, csr.values)
    model = SparseFactorizationModel.from_csr(tcsr, 4, device="cpu")
    assert model.runner.device.type == "cpu" and model.k == 4
