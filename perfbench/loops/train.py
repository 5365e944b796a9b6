"""Loop of the training cells: steps back to back, each over a batch of
``batch`` sequences: the forward of every sequence, the loss
mean((out - y)^2) over the whole batch, one backward and
``torch.optim.Adam.step`` over every layer's weights.  The (x, y) pairs
are drawn in turn from a pool made from the seed.  Every sequence's graph
stays alive until the batch's backward, as in a batched step.

Set-up builds one training step (model, optimizer, loss), drives its first
``check_steps`` steps on distinct pairs through the window's own call, and
hands the same object on to the warm-up and the window.
``train_step_ms`` is the window's seconds over the steps completed; the
window begins after a synchronize and ends with one.

Judged against the float64 reference following the same steps: each
step's loss, each weight's first gradient as Adam got it (its first
moment after one step over 1 - beta1), and each weight's change over the
checked steps, read before the next step moves it."""

from __future__ import annotations

import math
import statistics
import time

import torch

from perfbench import attention_inputs, counts, reference
from perfbench.attention_inputs import dims
from perfbench.trace import span

#: a weight whose reference gradient is under this share of the median
#: weight's moves by round-off alone under Adam: its change is not judged
STILL_GRAD = 1e-3


def loss_of(outs: list, ys: list) -> torch.Tensor:
    """The mean of (out - y)^2 over every sequence of the batch."""
    return sum(((o - y) ** 2).mean() for o, y in zip(outs, ys)) / len(outs)


class Loop:
    kind = "train"

    def __init__(self, system, pattern, config, traffic, device, seed: int):
        self.system, self.pattern = system, pattern
        self.dims = dims(config)
        self.mode = config["compute_mode"]
        self.pool, self.lr = int(traffic["pool"]), float(traffic["lr"])
        self.batch = int(traffic["batch"])
        self.check_steps = int(traffic["check_steps"])
        if self.check_steps * self.batch > self.pool:
            raise ValueError("the checked steps need distinct sequences")
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ws = attention_inputs.weights(self.dims, gen, device)
        hidden = self.dims["hidden"]
        self.xs = attention_inputs.sequences(self.pool, pattern.m, hidden,
                                             gen, device)
        self.ys = attention_inputs.sequences(self.pool, pattern.m, hidden,
                                             gen, device)
        system.load_weights(self.ws)
        self.params = system.parameters()
        self.opt = torch.optim.Adam(self.params, lr=self.lr)
        self.betas = self.opt.defaults["betas"]
        losses, grads = [], None
        for i in range(self.check_steps):
            losses.append(self.step(i).detach())
            if i == 0:
                grads = [self.first_grad(p) for p in self.params]
        self.checked = {
            "losses": [float(v) for v in losses],
            "grad_norms": [float(g.norm()) for g in grads],
            "change_norms": [float((p.detach() - w).norm())
                             for p, w in zip(self.params, self.flat_ws())]}
        self.steps = self.check_steps
        for _ in range(int(traffic["warm_steps"])):
            self.next_step()
        self.sync()

    def first_grad(self, p: torch.Tensor) -> torch.Tensor:
        """The gradient Adam got at its first step, from its first moment
        (zero where the optimizer kept no state for ``p``)."""
        m = self.opt.state.get(p, {}).get("exp_avg")
        if m is None:
            return torch.zeros_like(p.detach())
        return m.detach().clone() / (1 - self.betas[0])

    def flat_ws(self) -> list:
        return [w for ws in self.ws for w in ws]

    def batch_of(self, i: int) -> list:
        """Pool indices of step ``i``'s sequences."""
        return [(i * self.batch + b) % self.pool for b in range(self.batch)]

    def sync(self):
        if self.xs.is_cuda:
            torch.cuda.synchronize()

    def step(self, i: int) -> torch.Tensor:
        js = self.batch_of(i)
        self.opt.zero_grad(set_to_none=True)
        loss = loss_of([self.system.forward(self.xs[j]) for j in js],
                       [self.ys[j] for j in js])
        loss.backward()
        self.opt.step()
        return loss

    def next_step(self):
        self.step(self.steps)
        self.steps += 1

    def traced_call(self, i: int):
        js = self.batch_of(self.steps)
        self.steps += 1
        with span("zero_grad"):
            self.opt.zero_grad(set_to_none=True)
        with span("forward"):
            outs = [self.system.forward(self.xs[j]) for j in js]
        with span("loss"):
            loss = loss_of(outs, [self.ys[j] for j in js])
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            self.opt.step()

    def window(self, seconds: float):
        self.sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.next_step()
            n += 1
        self.sync()
        return {"train_step_ms": (time.perf_counter() - t0) / n * 1e3}, n

    def host_probe(self, calls: int) -> list:
        out = []
        for _ in range(calls):
            self.sync()
            t0 = time.perf_counter()
            self.next_step()
            out.append(time.perf_counter() - t0)
        self.sync()
        return out

    def ops(self) -> list:
        d = self.dims
        params = sum(w.numel() for w in self.flat_ws())
        return counts.attention_train_ops(
            self.pattern.m, d["hidden"], d["heads"], d["head_dim"],
            self.pattern.nnz, params, d["layers"], self.batch)

    def release(self):
        """Drop the program's state; what it produced stays."""
        self.system = None
        self.opt = self.params = None

    def readings(self) -> dict:
        return self.checked

    def control_readings(self, precision: str) -> dict:
        """The readings of the reference following the checked steps."""
        mask = reference.dense_mask(self.pattern, self.xs.device)
        batches = [[(self.xs[j], self.ys[j]) for j in self.batch_of(i)]
                   for i in range(self.check_steps)]
        losses, grads, final = reference.train(
            self.ws, batches, mask, self.lr, betas=self.betas,
            precision=precision)
        return {"losses": losses,
                "grad_norms": [float(g.norm()) for g in grads],
                "change_norms": [float((p - w.to(p.dtype)).norm())
                                 for p, w in zip(final, self.flat_ws())]}

    def judge(self, readings: dict) -> dict:
        return gaps(readings, self.control_readings("exact"))


def gaps(got: dict, ref: dict) -> dict:
    """The three numbers compared, each the worst over steps or weights:
    a loss's gap relative to the reference's; a weight's gap of gradient
    norms, and of change norms, relative to the reference's norm of that
    weight or of the median weight, whichever is larger."""
    def worst(vals):
        vals = list(vals)
        return max(v if math.isfinite(v) else math.inf for v in vals)

    loss_gap = worst(abs(g - r) / abs(r)
                     for g, r in zip(got["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"])
    grad_gap = worst(abs(g - r) / max(r, g_med)
                     for g, r in zip(got["grad_norms"], ref["grad_norms"]))
    moved = [i for i, r in enumerate(ref["grad_norms"])
             if r >= STILL_GRAD * g_med]
    c_med = statistics.median(ref["change_norms"][i] for i in moved)
    change_gap = worst(abs(got["change_norms"][i] - ref["change_norms"][i])
                       / max(ref["change_norms"][i], c_med) for i in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
