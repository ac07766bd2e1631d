"""Optimizer factories with the reference's torch semantics — the port of
``semantic_segmentation_tpu/core/optim.py``. The JAX package builds these
out of optax chains; here they are the torch optimizers those chains
restate:

- Adam(lr, betas=(beta1, 0.999), eps=1e-8) for G/D (pix2pix_model.py:75-82),
  with torch's L2 ``weight_decay`` (added to the gradient, not AdamW) for
  the arch optimizer (train_end2end_jsrt.py:324, wd=1e-5).
- RMSprop(lr, alpha=0.99, eps=1e-8, weight_decay=1e-8, momentum=0.9) for
  the seg net (train_end2end_jsrt.py:71-72).

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
