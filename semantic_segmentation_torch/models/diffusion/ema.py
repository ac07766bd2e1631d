"""Exponential moving average of the denoiser's weights — the port of
``semantic_segmentation_tpu/models/diffusion/ema.py`` (the BBDM EMA,
``BBDM/runners/base/EMA.py``, wired in ``BaseRunner.py:60-75, 163-180``):
updated every ``update_ema_interval`` steps, a plain copy before
``start_ema_step`` and a decayed blend from it on. The shadow is a dict of
tensors keyed like ``named_parameters()``, updated in place."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EMAConfig:
    use_ema: bool = True
    ema_decay: float = 0.995
    update_ema_interval: int = 8
    start_ema_step: int = 30000


def ema_init(params: dict) -> dict:
    """The shadow's first value: a detached copy of ``params``."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_step(cfg: EMAConfig, global_step: int, shadow: dict, params: dict):
    """``BaseRunner.step_ema`` (:163-168): at every ``update_ema_interval``-th
    step ``shadow = d * shadow + (1 - d) * params`` with ``d`` the decay
    from ``start_ema_step`` on and 0 before it (so step 0 copies the
    parameters); other steps leave it. ``d`` and ``1 - d`` are taken in
    float32, as the JAX package takes them."""
    if global_step % cfg.update_ema_interval != 0:
        return shadow
    d = cfg.ema_decay if global_step >= cfg.start_ema_step else 0.0
    for k, s in shadow.items():
        d_t = torch.tensor(d, dtype=s.dtype, device=s.device)
        s.copy_(d_t * s + (1.0 - d_t) * params[k].detach())
    return shadow
