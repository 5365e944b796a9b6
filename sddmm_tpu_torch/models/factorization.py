"""Sparse matrix factorization, the training use of SDDMM.

Counterpart of ``sddmm_tpu/models/factorization.py``
(``FactorizationParams``, ``SparseFactorizationModel``): learn low-rank
factors A (M, K) and B^T (N, K) whose products reproduce the observed
entries of a sparse matrix S, minimising the mean squared error over its
nnz.  The forward is the hybrid SDDMM (``HybridSDDMM.run_padded``, one
tile-kernel launch and one gather-dot launch on the card), the loss is
taken over the packed slots with zero weight on the padding ones, and the
backward is the runner's autograd op: two launches over the tile kernel's
work table (``tile_table_grad``), plus two SpMM launches for a residual.
The optimizer is ``torch.optim.Adam`` with optax's defaults (beta
0.9 / 0.999, eps 1e-8: the same update rule as ``optax.adam``).

The factors are ``nn.Parameter``s on the model's device; torch cannot draw
``jax.random``'s numbers, so ``interop.factorization_params_from_reference``
carries the JAX model's factors across.

``DistributedSparseFactorizationModel`` is the same trainer over a ('rows',
'feat') mesh of ranks (``parallel``): each rank holds the K slice of the
factors of its feat coordinate, computes its rows block's share of the
packed-target loss (one all-reduce of the packed output over 'feat'), and
its gradients are summed over 'rows' in the backward, so every rank's Adam
takes the same step.  The total loss is the sum of the rows ranks' shares.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from sddmm_tpu_torch import config
from sddmm_tpu_torch.data.sparse import CSR
from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
from sddmm_tpu_torch.reorder.bsmr import BSMR
from sddmm_tpu_torch.reorder.pack import PackedMatrix, pack
from sddmm_tpu_torch.utils.checkpoint import Checkpointer


class FactorizationParams(NamedTuple):
    a: torch.Tensor    # (M, K)
    bt: torch.Tensor   # (N, K)


class SparseFactorizationModel(nn.Module):
    """SDDMM-based low-rank factorization trainer on one device (the card
    unless the caller asks for ``"cpu"``)."""

    def __init__(self, packed: PackedMatrix, k: int,
                 learning_rate: float = 1e-2,
                 compute_dtype: str = "float32", device="cuda"):
        super().__init__()
        if packed.inv_idx is None:
            raise ValueError("SparseFactorizationModel needs a packing with "
                             "CSR-order metadata (full_metadata=True)")
        self.packed = packed
        self.k = int(k)
        self.learning_rate = learning_rate
        self.compute_dtype = compute_dtype
        self.runner = HybridSDDMM(packed, compute_dtype=compute_dtype,
                                  device=device)
        self.device = self.runner.device
        # packed-slot weights: 1 on the real nnz, 0 on the padding slots
        w = np.zeros(packed.packed_size, dtype=np.float32)
        w[packed.inv_idx] = 1.0
        self._slot_weight = torch.as_tensor(w, device=self.device)
        self.a = nn.Parameter(torch.zeros((packed.m, self.k),
                                          device=self.device))
        self.bt = nn.Parameter(torch.zeros((packed.n, self.k),
                                           device=self.device))
        self.optimizer = self._adam()

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> FactorizationParams:
        """N(0, 1/K) factors from the CPU ``generator`` (not the JAX
        package's numbers), and a fresh optimizer state."""
        scale = 1.0 / np.sqrt(self.k)
        for w in (self.a, self.bt):
            w.copy_(torch.randn(w.shape, generator=generator) * scale)
        self.optimizer = self._adam()
        return self.params()

    def params(self) -> FactorizationParams:
        return FactorizationParams(self.a.detach(), self.bt.detach())

    @torch.no_grad()
    def load_params(self, params: FactorizationParams) -> None:
        """Set the factors (and start a fresh optimizer state)."""
        for w, p in zip((self.a, self.bt), params):
            w.copy_(torch.as_tensor(p, dtype=torch.float32))
        self.optimizer = self._adam()

    def forward(self, order: str = "packed",
                plain: bool = False) -> torch.Tensor:
        """Predicted values at the nnz positions: the packed flat vector
        (order "packed"), or CSR entry order ("csr").  ``plain=True`` runs
        every kernel's plain version, forward and backward (the reference
        the kernels are held to on the card)."""
        zero = self.a.new_zeros((1, self.k))
        a_pad = torch.cat([self.a, zero])
        bt_pad = torch.cat([self.bt, zero])
        return self.runner.run_padded(
            *self.runner.device_prepare(a_pad, bt_pad), order=order,
            plain=plain)

    def pack_targets(self, targets) -> torch.Tensor:
        """CSR-order target values (nnz,) -> the packed layout (F,) on the
        model's device, zero on the padding slots (once: the targets do not
        change across steps)."""
        tp = np.zeros(self.packed.packed_size, dtype=np.float32)
        tp[self.packed.inv_idx] = np.asarray(targets, dtype=np.float32)
        return torch.as_tensor(tp, device=self.device)

    def loss(self, targets_packed: torch.Tensor,
             plain: bool = False) -> torch.Tensor:
        """The weighted packed-slot MSE: sum over the real slots of
        (prediction - target)^2, over nnz."""
        err = (self(order="packed", plain=plain) - targets_packed) ** 2
        return (err * self._slot_weight).sum() / self.packed.nnz

    def make_train_step(self, plain: bool = False):
        """``step(targets_packed) -> loss``: one forward, backward and Adam
        update of the model's factors (the loss is the pre-update one, as
        JAX's ``value_and_grad`` step returns); ``plain`` as in
        ``forward``."""
        def train_step(targets_packed: torch.Tensor) -> torch.Tensor:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(targets_packed, plain=plain)
            loss.backward()
            self.optimizer.step()
            return loss.detach()

        return train_step

    def state(self) -> dict:
        """The training state a checkpoint keeps: factors and optimizer."""
        return {"params": {"a": self.a.detach(), "bt": self.bt.detach()},
                "opt": self.optimizer.state_dict()}

    def load_state(self, state: dict) -> None:
        self.load_params(FactorizationParams(state["params"]["a"],
                                             state["params"]["bt"]))
        self.optimizer.load_state_dict(state["opt"])

    def fit(self, targets, generator: Optional[torch.Generator] = None,
            steps: int = 100, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 50):
        """Train from ``init(generator)`` (default: a generator seeded 0)
        on CSR-order ``targets`` (nnz,) for ``steps`` steps -> (the final
        ``FactorizationParams``, the losses of the steps this call ran).

        With ``checkpoint_dir`` the factors and the optimizer state are
        saved every ``checkpoint_every`` steps and at the end
        (``utils.checkpoint.Checkpointer``), and a fit resumes from the
        latest saved step."""
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))
        start, ck = 0, None
        if checkpoint_dir:
            ck = Checkpointer(checkpoint_dir)
            # on the host: Adam keeps its step counts there, and
            # load_state_dict moves the rest to the factors' device
            saved = ck.restore(map_location="cpu")
            if saved is not None:
                self.load_state(saved)
                start = int(ck.latest_step)
        step = self.make_train_step()
        targets_packed = self.pack_targets(targets)
        losses = []
        for i in range(start, steps):
            losses.append(float(step(targets_packed)))
            if ck is not None and ((i + 1) % checkpoint_every == 0
                                   or i + 1 == steps):
                ck.save(i + 1, self.state())
        return self.params(), losses

    @staticmethod
    def from_csr(csr: CSR, k: int, alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA, device="cuda",
                 **kwargs) -> "SparseFactorizationModel":
        """Pack ``csr`` with the BSMR defaults, as the JAX model does;
        ``kwargs`` (``learning_rate``, ``compute_dtype``) go to the
        constructor."""
        return SparseFactorizationModel(pack(csr, BSMR(alpha, delta, csr)),
                                        k, device=device, **kwargs)


class DistributedSparseFactorizationModel(nn.Module):
    """The factorization trainer over a ('rows', 'feat') mesh: this rank's
    part (``parallel.dist.DistributedHybridSDDMM``, the packed-target loss
    kept sharded on 'rows', the factors K-sliced on 'feat').  ``a`` and
    ``bt`` are this rank's slices (M, K/F) and (N, K/F); ``init`` and
    ``load_params`` take the whole factors and keep the slice."""

    def __init__(self, packed: PackedMatrix, mesh, k: int,
                 learning_rate: float = 1e-2,
                 compute_dtype: str = "float32", device="cuda"):
        from sddmm_tpu_torch.parallel.dist import DistributedHybridSDDMM

        super().__init__()
        self.packed = packed
        self.k = int(k)
        self.learning_rate = learning_rate
        self.dist = DistributedHybridSDDMM(packed, mesh,
                                           compute_dtype=compute_dtype,
                                           device=device)
        if self.k % self.dist.k_chunks:
            raise ValueError(f"K={k} not divisible by C={self.dist.k_chunks}")
        self.mesh = mesh
        self.device = self.dist.device
        kf = self.k // self.dist.F
        self.a = nn.Parameter(torch.zeros((packed.m, kf), device=self.device))
        self.bt = nn.Parameter(torch.zeros((packed.n, kf),
                                           device=self.device))
        self.optimizer = self._adam()

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1/K) factors drawn whole from the CPU ``generator`` as
        ``SparseFactorizationModel.init`` draws them (so every rank, and a
        single-device model from the same seed, start alike), this rank's
        slice kept; a fresh optimizer state."""
        scale = 1.0 / np.sqrt(self.k)
        full = [torch.randn((n, self.k), generator=generator) * scale
                for n in (self.packed.m, self.packed.n)]
        self.load_params(FactorizationParams(*full))

    @torch.no_grad()
    def load_params(self, params: FactorizationParams) -> None:
        """Set the factors from the whole (M, K) and (N, K) ones (and start
        a fresh optimizer state)."""
        for w, p in zip((self.a, self.bt), params):
            w.copy_(self.dist.feat_slice(
                torch.as_tensor(np.array(p, dtype=np.float32))))
        self.optimizer = self._adam()

    def forward(self, order: str = "packed") -> torch.Tensor:
        """This rank's predicted packed values (flat_local,), or with
        ``order="csr"`` all values in CSR order."""
        zero = self.a.new_zeros((1, self.a.shape[1]))
        a_pad = torch.cat([self.a, zero])
        bt_pad = torch.cat([self.bt, zero])
        return self.dist.run_padded(*self.dist.device_prepare(a_pad, bt_pad),
                                    order=order)

    def pack_targets(self, targets):
        """(targets, mask) in this rank's packed layout (flat_local,)."""
        return self.dist.make_packed_targets(targets)

    def loss(self, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """This rows rank's share of the loss: the squared error over its
        real slots, over nnz."""
        err = torch.where(mask, self() - targets, 0.0) ** 2
        return err.sum() / self.packed.nnz

    def make_train_step(self):
        """``step(targets, mask) -> loss``: one forward, backward (the
        gradients summed over 'rows') and Adam update; the loss returned is
        the total before the update (the rows ranks' shares summed)."""
        def train_step(targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
            import torch.distributed as dist

            self.optimizer.zero_grad(set_to_none=True)
            part = self.loss(targets, mask)
            part.backward()
            self.optimizer.step()
            total = part.detach().clone()
            dist.all_reduce(total, group=self.mesh.groups["rows"])
            return total

        return train_step

    def fit(self, targets, generator: Optional[torch.Generator] = None,
            steps: int = 50):
        """Train from ``init(generator)`` (default: a generator seeded 0)
        for ``steps`` steps -> (this rank's factor slices, the losses)."""
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))
        step = self.make_train_step()
        tp, mask = self.pack_targets(targets)
        losses = [float(step(tp, mask)) for _ in range(steps)]
        return FactorizationParams(self.a.detach(), self.bt.detach()), losses

    @staticmethod
    def from_csr(csr: CSR, mesh, k: int, alpha: float = config.DEFAULT_ALPHA,
                 delta: float = config.DEFAULT_DELTA, device="cuda",
                 **kwargs) -> "DistributedSparseFactorizationModel":
        """Pack ``csr`` with the BSMR defaults, as the JAX model does."""
        from sddmm_tpu_torch.ops.hybrid import check_device
        check_device(device)
        return DistributedSparseFactorizationModel(
            pack(csr, BSMR(alpha, delta, csr)), mesh, k, device=device,
            **kwargs)
