"""Layers with the JAX package's numerics — the counterpart of
``semantic_segmentation_tpu/ops/flax_layers.py``.

- ``BatchNorm2d``: flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on
  NC... tensors of any rank (NCHW, NCDHW). In training it normalizes with
  the biased batch variance (as torch does) but also folds the BIASED
  variance into ``running_var``, where ``torch.nn.BatchNorm2d`` folds the
  unbiased one. At the generator's inner layers (2x2 maps at batch 2) the
  two differ by 8/7, which moves every eval-mode output.
- ``InstanceNorm``: flax's ``nn.InstanceNorm(use_scale=False,
  use_bias=False, epsilon=1e-5)``, torch's ``InstanceNorm{2,3}d(affine=
  False)``: per-sample, per-channel statistics, no parameters.
- ``norm_layer``: the ``get_norm_layer`` choice (batch, instance, none).
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
  default lecun-normal and DeepLabV2's He-normal on the fan-out; and
  ``reinit_``, the non-default ``init_type``/``init_gain`` laws of
  ``init_weights`` (normal, xavier, kaiming, orthogonal).

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

from semantic_segmentation_torch.parallel import collectives

# set while ``checkpointed`` recomputes a forward in the backward
_recompute = threading.local()


def _at_least_f32(x):
    """``x`` promoted to float32 at least (float64 stays), as flax takes
    normalization statistics."""
    return x if x.dtype == torch.float64 else x.float()


def _channel_view(t, ndim: int):
    """A per-channel (C,) tensor shaped to broadcast over an NC... tensor
    of rank ``ndim``."""
    return t.reshape((-1,) + (1,) * (ndim - 2))


class BatchNorm2d(nn.Module):
    """flax ``BatchNorm`` semantics on NC... tensors (NCHW, NCDHW): the
    statistics reduce over every axis but the channel axis, in float32 (in
    float64 for a float64 input), over the global batch under data
    parallelism (``parallel/collectives.batch_var_mean``)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        xs = _at_least_f32(x)
        if not self.training:
            return F.batch_norm(xs, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        dims = (0,) + tuple(range(2, x.dim()))
        var, mean = collectives.batch_var_mean(xs, dims)
        if not getattr(_recompute, "on", False):
            self._fold(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xs - _channel_view(mean, x.dim())) \
            * _channel_view(scale, x.dim()) + _channel_view(self.bias,
                                                            x.dim())
        return y.to(x.dtype)

    @torch.no_grad()
    def _fold(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(m).add_((1.0 - m) * mean)
        self.running_var.mul_(m).add_((1.0 - m) * var)


class InstanceNorm(nn.Module):
    """flax ``nn.InstanceNorm(use_scale=False, use_bias=False,
    epsilon=1e-5)`` on NC... tensors: each sample's channel normalized over
    its spatial axes, no parameters, no running statistics. As flax does,
    the statistics are taken in float32 (float64 stays float64) with the
    variance as E[x^2] - E[x]^2, clipped at 0; the output has the input's
    dtype."""

    eps = 1e-5

    def forward(self, x):
        xs = _at_least_f32(x)
        dims = tuple(range(2, x.dim()))
        mean = xs.mean(dim=dims, keepdim=True)
        mean2 = (xs * xs).mean(dim=dims, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        return ((xs - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def norm_layer(norm: str, num_features: int) -> nn.Module:
    """``get_norm_layer`` (``models_pix2pix/networks.py:23-41``): 'batch'
    (affine, running statistics), 'instance' (no parameters) or 'none'."""
    if norm == "batch":
        return BatchNorm2d(num_features)
    if norm == "instance":
        return InstanceNorm()
    if norm == "none":
        return nn.Identity()
    raise NotImplementedError(f"normalization layer {norm!r} is not found")


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
                    generator: torch.Generator | None = None,
                    draw_bn_scale: bool = True):
    """``init_weights`` 'normal' (``models_pix2pix/networks.py:84-101``):
    conv weights N(0, gain), biases 0, our BatchNorm's scale N(1, gain)
    (1 with ``draw_bn_scale`` False: the JAX package's 3D nets keep flax's
    default BN init)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0]) \
                if "." in name else module
            leaf = name.rpartition(".")[2]
            if isinstance(owner, BatchNorm2d):
                if leaf == "weight" and draw_bn_scale:
                    p.normal_(1.0, gain, generator=generator)
                elif leaf == "weight":
                    p.fill_(1.0)
                else:
                    p.zero_()
            elif leaf.startswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, gain, generator=generator)


def _semi_orthogonal(rows: int, cols: int, gain: float,
                     generator: torch.Generator | None):
    """torch ``init.orthogonal_``'s law on a (rows, cols) matrix: the QR of
    a Gaussian (transposed when rows < cols, so the short side is
    orthonormal), its columns' signs set by diag(R), scaled by ``gain``."""
    tall = rows >= cols
    a = torch.randn((rows, cols) if tall else (cols, rows),
                    generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return gain * (q if tall else q.T)


def reinit_(module: nn.Module, init_type: str = "normal",
            init_gain: float = 0.02,
            generator: torch.Generator | None = None) -> nn.Module:
    """``init_weights`` (``models_pix2pix/networks.py:73-104``), the laws of
    ``flax_layers.reinit_params`` on the torch weight layout, drawn from
    ``generator``. Every conv or linear weight (a parameter named
    ``weight`` or ``kernel_*`` of rank 2 or more, not a norm's):

    - normal: N(0, gain);
    - xavier: ``xavier_normal_(gain)``, N(0, gain * sqrt(2 / (rf*I +
      rf*O)));
    - kaiming: ``kaiming_normal_(a=0, mode='fan_in')``, N(0, sqrt(2 /
      fan)) with torch's fan from dimension 1 of the weight: rf * I for a
      conv (O, I, k...), rf * O for a transposed conv (I, O, k...);
    - orthogonal: ``orthogonal_(gain)`` on the (dim 0, rest) flattening,
      rows = O for a conv, rows = I for a transposed conv.

    Biases go to 0; a ``BatchNorm2d`` scale is drawn from N(1, gain) and
    its bias zeroed; ``InstanceNorm`` has nothing to draw."""
    if init_type not in ("normal", "xavier", "kaiming", "orthogonal"):
        raise NotImplementedError(f"initialization method {init_type!r} is "
                                  "not implemented")
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name \
                else module
            if isinstance(owner, BatchNorm2d):
                if leaf == "weight":
                    p.copy_(1.0 + init_gain * torch.randn(
                        p.shape, generator=generator))
                else:
                    p.zero_()
            elif leaf.startswith("bias"):
                p.zero_()
            elif p.dim() >= 2:
                p.copy_(_init_law(p.shape, init_type, init_gain, generator))
    return module


def _init_law(shape, init_type: str, gain: float, generator):
    """One weight of torch layout ``shape`` drawn from ``init_type``'s law
    (``reinit_``)."""
    rf = math.prod(shape[2:])
    if init_type == "normal":
        return gain * torch.randn(shape, generator=generator)
    if init_type == "xavier":
        std = gain * math.sqrt(2.0 / (rf * shape[1] + rf * shape[0]))
        return std * torch.randn(shape, generator=generator)
    if init_type == "kaiming":
        return math.sqrt(2.0 / (rf * shape[1])) * torch.randn(
            shape, generator=generator)
    return _semi_orthogonal(shape[0], rf * shape[1], gain,
                            generator).reshape(shape)


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
    else one drawn from ``generator``; kept values doubled. Under data
    parallelism the mask is the global batch's (drawn, or given, at its
    shape) and this rank takes its rows."""
    if keep is None:
        shape = (collectives.global_batch(h.shape[0]),) + tuple(h.shape[1:])
        keep = torch.rand(shape, generator=generator, device=h.device) < 0.5
    keep = collectives.rows(keep, h.shape[0])
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
