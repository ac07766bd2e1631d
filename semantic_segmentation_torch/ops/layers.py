"""Layers with the JAX package's numerics — the counterpart of
``semantic_segmentation_tpu/ops/flax_layers.py``.

- ``BatchNorm2d``: flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``. In
  training it normalizes with the biased batch variance (as torch does) but
  also folds the BIASED variance into ``running_var``, where
  ``torch.nn.BatchNorm2d`` folds the unbiased one. At the generator's inner
  layers (2x2 maps at batch 2) the two differ by 8/7, which moves every
  eval-mode output.
- ``call_module``: a forward on scratch BN buffers and, optionally, on
  parameters that are not the module's own.
- ``pad_to_match``: the U-Net skip-concat pad (``unet/unet_parts.py:59-63``).
- ``resize_bilinear_align_corners`` / ``upsample_bilinear_2x``: torch's
  ``align_corners=True`` bilinear resize, which the JAX package restates
  (``ops/flax_layers.py:363-391``).
- ``dropout_half``: Dropout(0.5) as flax applies it, on a keep-mask.
- ``checkpointed``: a call under ``torch.utils.checkpoint`` whose
  recomputation leaves the BN running statistics alone (``model.remat``).
- init laws: pix2pix ``init_type='normal'`` (N(0, 0.02), BN scale
  N(1, 0.02), zero biases), torch's kaiming-uniform with the fan-in the
  JAX package uses (C_in * k * k, also for transposed convs), flax's
  default lecun-normal and DeepLabV2's He-normal on the fan-out.

Max-pool is ``F.max_pool2d``: the JAX reshape pool is a TPU lowering of the
same function (first-argmax gradient, as torch's).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

# set while ``checkpointed`` recomputes a forward in the backward
_recompute = threading.local()


class BatchNorm2d(nn.Module):
    """flax ``BatchNorm`` semantics on NCHW tensors, statistics in float32."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        if not getattr(_recompute, "on", False):
            self._fold(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (x32 - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def _fold(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(m).add_((1.0 - m) * mean)
        self.running_var.mul_(m).add_((1.0 - m) * var)


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), the JAX package's
    ``jax.checkpoint`` of ``model.remat``. The recomputation runs with
    ``BatchNorm2d``'s running-statistics update off, so the statistics fold
    once per forward, as without it. ``fn`` must draw nothing from an
    explicit ``torch.Generator``: the recomputation would draw again."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


def call_module(module, args, keep_stats: bool = True, params=None):
    """``module(*args)``; with ``keep_stats`` False the forward's BN updates
    go to scratch copies of the buffers, which are dropped. ``params``
    ({name: tensor}) replaces the module's parameters for this call (the
    hypergradients' surrogate and shifted weights); the buffers are then
    always scratch copies, so the real running statistics never change.
    ``BatchNorm2d`` updates its buffers in place, and under
    ``functional_call`` that write lands in the tensors passed."""
    if keep_stats and params is None:
        return module(*args)
    tensors = {k: b.clone() for k, b in module.named_buffers()}
    if params is not None:
        tensors.update(params)
    return functional_call(module, tensors, args)


def pad_to_match(x_small, target_hw):
    """Pad an NCHW tensor symmetrically (extra pixel on the high side) to
    ``target_hw``."""
    dy = target_hw[0] - x_small.shape[-2]
    dx = target_hw[1] - x_small.shape[-1]
    if dx == 0 and dy == 0:
        return x_small
    return F.pad(x_small, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])


def pix2pix_normal_(module: nn.Module, gain: float = 0.02,
                    generator: torch.Generator | None = None):
    """``init_weights`` 'normal' (``models_pix2pix/networks.py:84-101``):
    conv weights N(0, gain), biases 0, our BatchNorm's scale N(1, gain)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0]) \
                if "." in name else module
            leaf = name.rpartition(".")[2]
            if isinstance(owner, BatchNorm2d):
                if leaf == "weight":
                    p.normal_(1.0, gain, generator=generator)
                else:
                    p.zero_()
            elif leaf.startswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, gain, generator=generator)


def kaiming_uniform_(weight, fan_in: int,
                     generator: torch.Generator | None = None):
    """torch's default conv init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with an
    explicit fan-in (``flax_layers.torch_kaiming_uniform``)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def lecun_normal_(weight, generator: torch.Generator | None = None):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in (fan_in = C_in * k * k)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def he_normal_fan_out_(weight, generator: torch.Generator | None = None):
    """DeepLabV2's ``variance_scaling(2.0, 'fan_out', 'normal')``: an
    untruncated normal of variance 2 / (C_out * k * k)."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def dropout_half(h, keep, generator: torch.Generator | None = None):
    """Dropout(0.5) as flax applies it: the keep-mask ``keep`` if given,
    else one drawn from ``generator``; kept values doubled."""
    if keep is None:
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 0.5
    return torch.where(keep, h * 2.0, torch.zeros_like(h))


def resize_bilinear_align_corners(x, size):
    """NCHW bilinear resize to ``size`` with ``align_corners=True``
    (``flax_layers.resize_bilinear_align_corners``)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def upsample_bilinear_2x(x):
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
    (``flax_layers.upsample_bilinear_2x``), in float32: the JAX package's
    float32 interpolation weights promote a bfloat16 input."""
    return resize_bilinear_align_corners(x.float(), (2 * x.shape[-2],
                                                     2 * x.shape[-1]))
