"""Optimizer factories with the reference's torch semantics — the port of
``semantic_segmentation_tpu/core/optim.py``. The JAX package builds these
out of optax chains; here they are the torch optimizers those chains
restate:

- Adam(lr, betas=(beta1, 0.999), eps=1e-8) for G/D (pix2pix_model.py:75-82),
  with torch's L2 ``weight_decay`` (added to the gradient, not AdamW) for
  the arch optimizer (train_end2end_jsrt.py:324, wd=1e-5).
- RMSprop(lr, alpha=0.99, eps=1e-8, weight_decay=1e-8, momentum=0.9) for
  the seg net (train_end2end_jsrt.py:71-72).

``Accumulate`` restates ``optax.MultiSteps(every_k_schedule=k)``, the
seg optimizer's ``optim.accumulate``.

The JAX package's ``PlateauTracker`` restates torch's ReduceLROnPlateau;
the port's trainer uses torch's own. ``lr_schedule`` is the epoch-indexed
multiplier of the pix2pix policies (``networks.py:44-70``), set on an
optimizer's ``param_groups`` by ``set_learning_rate``.
"""

from __future__ import annotations

import math

import torch


def adam_torch(params, lr: float, beta1: float = 0.5,
               weight_decay: float = 0.0):
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def rmsprop_torch(params, lr: float):
    return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                               weight_decay=1e-8, momentum=0.9)


class Accumulate(torch.optim.Optimizer):
    """``optax.MultiSteps(inner, every_k_schedule=k)``: every ``step()``
    folds the parameters' gradients into their running mean (Welford, as
    optax: ``acc += (g - acc) / (n + 1)``); on every k-th the mean steps
    ``inner`` and the accumulator restarts, and in between neither the
    parameters nor ``inner``'s state move. A parameter without a gradient
    counts as a zero one. ``param_groups`` are ``inner``'s, so a learning
    rate set here (ReduceLROnPlateau) is ``inner``'s. The accumulator and
    the mini-step count live in ``state_dict()``, which the engine's
    roll-back and the checkpoints snapshot and restore."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k {every_k} < 1")
        self.params = [p for g in inner.param_groups for p in g["params"]]
        super().__init__(self.params, {})
        self.inner, self.every_k = inner, every_k
        self.param_groups = inner.param_groups
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Accumulate.step takes no closure")
        n = self.mini_step
        for p, a in zip(self.params, self.acc):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            a.add_((g - a) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone()
        self.inner.step()
        for a in self.acc:
            a.zero_()
        self.mini_step = 0

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(),
                "mini_step": self.mini_step, "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.inner.load_state_dict(state["inner"])
        for a, v in zip(self.acc, state["acc"], strict=True):
            a.copy_(v)
        self.mini_step = int(state["mini_step"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def lr_schedule(policy: str, base_lr: float, n_epochs: int,
                epoch_count: int = 1, n_epochs_decay: int = 100,
                lr_decay_iters: int = 50):
    """epoch -> learning rate for the policies linear, step and cosine
    (``semantic_segmentation_tpu/core/optim.py:66-87``)."""
    if policy == "linear":
        def mult(epoch):
            # torch's lambda_rule goes negative past the n_epochs +
            # n_epochs_decay horizon, which turns every step into ascent;
            # clamped at 0 as in the JAX package
            return max(0.0, 1.0 - max(0, epoch + epoch_count - n_epochs)
                       / float(n_epochs_decay + 1))
    elif policy == "step":
        def mult(epoch):
            return 0.1 ** (epoch // lr_decay_iters)
    elif policy == "cosine":
        def mult(epoch):
            return 0.5 * (1 + math.cos(math.pi * epoch / n_epochs))
    else:
        raise NotImplementedError(f"learning rate policy [{policy}]")
    return lambda epoch: base_lr * mult(epoch)
