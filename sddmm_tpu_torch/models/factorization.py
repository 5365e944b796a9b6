"""Sparse matrix factorization, the training use of SDDMM.

Counterpart of ``sddmm_tpu/models/factorization.py``
(``FactorizationParams``, ``SparseFactorizationModel``): learn low-rank
factors A (M, K) and B^T (N, K) whose products reproduce the observed
entries of a sparse matrix S, minimising the mean squared error over its
nnz.  The forward is the hybrid SDDMM (``HybridSDDMM.run_padded``, one
tile-kernel launch and one gather-dot launch on the card), the loss is
taken over the packed slots with zero weight on the padding ones, and the
backward is the runner's autograd op: two SpMM launches over the packing's
read pattern.  The optimizer is ``torch.optim.Adam`` with optax's defaults
(beta 0.9 / 0.999, eps 1e-8: the same update rule as ``optax.adam``).

The factors are ``nn.Parameter``s on the model's device; torch cannot draw
``jax.random``'s numbers, so ``interop.factorization_params_from_reference``
carries the JAX model's factors across.  ``DistributedSparseFactorizationModel``
waits for the port of ``parallel`` (ROADMAP Queue 1).
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
