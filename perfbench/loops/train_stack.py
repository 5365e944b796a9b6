"""Loop of the training cells of a stack built from a layer pattern
(``systems/mimo_stack.py``): the design of ``loops/train.py``, whose step,
window, probes and judge it takes as they are.  Each step is a batch of
``batch`` sequences: the forward of every sequence, the loss mean((out -
y)^2) over the batch, one backward and ``torch.optim.Adam.step`` over every
weight, the sinks included; (x, y) drawn in turn from a pool made from the
seed.  Set-up drives the first ``check_steps`` steps on distinct pairs and
``warm_steps`` more.

Judged against ``perfbench/mimo_reference.py`` in float64 following the
same steps: each loss, each weight's first gradient (Adam's first moment
over 1 - beta1) and change, as ``loops/train.py``'s ``gaps``."""

from __future__ import annotations

import torch

from perfbench import cells, counts_mimo, mimo_reference

_train = cells.loop("train")
loss_of, gaps = _train.loss_of, _train.gaps


def stack_dims(config: dict) -> dict:
    return cells.system(config["system"]).dims(config)


def weights(d: dict, gen: torch.Generator, device) -> list:
    """One dict a layer: w_q (H, F, D), w_k (Hkv, F, D), w_v (Hkv, F, Dv)
    and w_o (H*Dv, F), normal draws scaled by 1/sqrt(fan-in), and ``sink``
    (H,) N(0, 1) in a layer of a kind that has one; one draw for all."""
    F, H, D, Dv = d["hidden"], d["heads"], d["head_dim"], d["v_head_dim"]
    shapes = []
    for t in d["layer_types"]:
        k = d["kinds"][t]
        s = {"w_q": (H, F, D), "w_k": (k["kv_heads"], F, D),
             "w_v": (k["kv_heads"], F, Dv), "w_o": (H * Dv, F)}
        if k["sink"]:
            s["sink"] = (H,)
        shapes.append(s)
    total = sum(torch.Size(s).numel() for ss in shapes for s in ss.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, o = [], 0
    for ss in shapes:
        layer = {}
        for name, s in ss.items():
            n = torch.Size(s).numel()
            scale = (1.0 if name == "sink" else
                     s[0] ** -0.5 if name == "w_o" else s[1] ** -0.5)
            layer[name] = flat[o:o + n].view(s) * scale
            o += n
        out.append(layer)
    return out


class Loop(_train.Loop):
    kind = "train_stack"

    def __init__(self, system, pattern, config, traffic, device, seed: int):
        self.system, self.pattern = system, pattern
        self.dims = stack_dims(config)
        self.mode = config["compute_mode"]
        self.pool, self.lr = int(traffic["pool"]), float(traffic["lr"])
        self.batch = int(traffic["batch"])
        self.check_steps = int(traffic["check_steps"])
        if self.check_steps * self.batch > self.pool:
            raise ValueError("the checked steps need distinct sequences")
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ws = weights(self.dims, gen, device)
        hidden, L = self.dims["hidden"], pattern.m
        self.xs = torch.randn((self.pool, L, hidden), generator=gen,
                              device=device)
        self.ys = torch.randn((self.pool, L, hidden), generator=gen,
                              device=device)
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

    def flat_ws(self) -> list:
        return [w[n] for w in self.ws for n in mimo_reference.NAMES
                if n in w]

    def ops(self) -> list:
        params = sum(w.numel() for w in self.flat_ws())
        return counts_mimo.train_ops(self.dims, self.pattern.m, self.batch,
                                     params)

    def control_readings(self, precision: str) -> dict:
        """The readings of the reference following the checked steps."""
        d = self.dims
        kinds = counts_mimo.layer_kinds(d)
        cfg = {"rotary_dim": d["rotary_dim"],
               "value_scale": d["value_scale"]}
        batches = [[(self.xs[j], self.ys[j]) for j in self.batch_of(i)]
                   for i in range(self.check_steps)]
        losses, grads, final = mimo_reference.train(
            self.ws, kinds, cfg, batches, self.lr, betas=self.betas,
            precision=precision)
        return {"losses": losses,
                "grad_norms": [float(g.norm()) for g in grads],
                "change_norms": [float((p - w.to(p.dtype)).norm())
                                 for p, w in zip(final, self.flat_ws())]}
