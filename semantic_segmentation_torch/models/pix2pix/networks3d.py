"""3D Pix2Pix networks (Pix2PixNIfTI) — the port of
``semantic_segmentation_tpu/models/pix2pix/networks3d.py``
(``GenSeg-3D/models/networks.py``):

- ``UnetGenerator3D`` (:604-650) in both upsampling variants:
  'linear' (:654-733, the default): the searchable down-convs
  (``MixedConv`` in 3D, driven by ``arch_conv``), then
  ``linear_additive_upsample`` (:50-81) and a 3x3x3 conv; 'deconvolution'
  (:736-802): plain 4^3 stride-2 downs and transposed-conv ups.
- ``NLayerDiscriminator3D`` (:804+): the volumetric PatchGAN.

NCDHW. Submodule names are the JAX package's (``down{d}``, ``down_bn{d}``,
``up{d}``, ``up_bn{d}``; ``conv{n}``, ``bn{n}``, ``head``), so the weight
bridge maps the trees leaf by leaf. ``use_bias`` is ``norm == 'instance'``
(always set on up0 and on the discriminator's first conv and head). The
JAX package's init is ``pix2pix_normal_`` with ``draw_bn_scale=False``:
conv kernels N(0, 0.02), biases 0, BN scale 1 (flax's default).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import dropout_half, norm_layer
from semantic_segmentation_torch.ops.nas import MixedConv, arch_softmax


def linear_additive_upsample(x, scale: int = 2, n_splits: int = 4):
    """LinearAdditiveUpsample (networks.py:50-81): trilinear x``scale`` with
    half-pixel centres (``align_corners=False``, the source coordinate
    clamped at the borders, which is ``jax.image.resize``'s renormalized
    edge weight for an upsample), then the sum over consecutive groups of
    ``n_splits`` channels. NCDHW."""
    n, c = x.shape[:2]
    if c % n_splits:
        raise ValueError(f"{c} channels do not split into groups of "
                         f"{n_splits}")
    y = F.interpolate(x, scale_factor=scale, mode="trilinear",
                      align_corners=False)
    return y.reshape((n, c // n_splits, n_splits) + y.shape[2:]).sum(2)


def dropout_depths(num_downs: int):
    """Depths whose up block applies dropout: 4 <= d <= nd-2."""
    return tuple(range(4, num_downs - 1))


class UnetGenerator3D(nn.Module):
    """3D recursive-skip U-Net generator. ``arch_conv`` (num_downs, 3): row
    ``num_downs - 1 - d`` drives depth d's searchable down-conv in the
    'linear' variant (innermost first, the construction order of
    :625-650)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 num_downs: int = 6, ngf: int = 64,
                 upsampling: str = "linear", use_dropout: bool = False,
                 norm: str = "batch", n_splits: int = 4):
        super().__init__()
        if upsampling not in ("linear", "deconvolution"):
            raise ValueError(f"upsampling {upsampling!r} (linear or "
                             "deconvolution)")
        nd = self.num_downs = num_downs
        self.upsampling, self.use_dropout = upsampling, use_dropout
        self.n_splits = n_splits
        use_bias = norm == "instance"
        inner = [min(ngf * 2 ** d, ngf * 8) for d in range(nd)]
        self.up_channels = [output_nc] + [ngf * min(2 ** (d - 1), 8)
                                          for d in range(1, nd)]
        for d in range(nd):
            c_in = input_nc if d == 0 else inner[d - 1]
            if upsampling == "linear":
                down = MixedConv(c_in, inner[d], bias=use_bias,
                                 ndim_spatial=3)
            else:
                down = nn.Conv3d(c_in, inner[d], 4, 2, 1, bias=use_bias)
            self.add_module(f"down{d}", down)
            if 0 < d < nd - 1:
                self.add_module(f"down_bn{d}", norm_layer(norm, inner[d]))
            up_in = inner[d] * (2 if d < nd - 1 else 1)
            out_ch = self.up_channels[d]
            bias = True if d == 0 else use_bias
            if upsampling == "linear":
                up = nn.Conv3d(up_in // n_splits, out_ch, 3, 1, 1, bias=bias)
            else:
                up = nn.ConvTranspose3d(up_in, out_ch, 4, 2, 1, bias=bias)
            self.add_module(f"up{d}", up)
            if d > 0:
                self.add_module(f"up_bn{d}", norm_layer(norm, out_ch))

    def forward(self, x, arch_conv=None, dropout_masks=None,
                generator: torch.Generator | None = None):
        """``dropout_masks``: {depth: bool keep-mask shaped like that
        depth's up-block output} replaces the draw from ``generator`` (train
        mode only)."""
        return self._block(x, 0, arch_conv, dropout_masks, generator)

    def draw_dropout(self, shape, generator=None, device=None) -> dict:
        """{depth: keep-mask} for a train-mode forward on an NCDHW input of
        ``shape``, drawn from ``generator`` in the order the forward draws
        them (the deepest first)."""
        if not self.use_dropout:
            return {}
        b, _, dd, hh, ww = shape
        return {d: torch.rand((b, self.up_channels[d], dd >> d, hh >> d,
                               ww >> d), generator=generator,
                              device=device) < 0.5
                for d in reversed(dropout_depths(self.num_downs))}

    def _block(self, h, d, arch_conv, dropout_masks, generator):
        """The skip block at depth ``d`` and, inside it, those below (a
        method, not a self-calling closure: see ``UnetGenerator._block``)."""
        nd = self.num_downs
        skip = h
        if d > 0:
            h = F.leaky_relu(h, 0.2)
        if self.upsampling == "linear":
            h = getattr(self, f"down{d}")(h, arch_softmax(arch_conv[nd - 1
                                                                    - d]))
        else:
            h = getattr(self, f"down{d}")(h)
        if 0 < d < nd - 1:
            h = getattr(self, f"down_bn{d}")(h)
        if d < nd - 1:
            h = self._block(h, d + 1, arch_conv, dropout_masks, generator)
        h = F.relu(h)
        if self.upsampling == "linear":
            h = linear_additive_upsample(h, 2, self.n_splits)
        h = getattr(self, f"up{d}")(h)
        if d == 0:
            return torch.tanh(h.float())
        h = getattr(self, f"up_bn{d}")(h)
        if self.training and self.use_dropout and d in dropout_depths(nd):
            h = dropout_half(h, None if dropout_masks is None
                             else dropout_masks[d], generator)
        return torch.cat([skip, h.to(skip.dtype)], dim=1)


class NLayerDiscriminator3D(nn.Module):
    """Volumetric PatchGAN: an NCDHW logit map."""

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch"):
        super().__init__()
        self.n_layers = n_layers
        use_bias = norm == "instance"
        self.conv0 = nn.Conv3d(input_nc, ndf, 4, 2, 1, bias=True)
        nf = ndf
        for n in range(1, n_layers):
            nf_out = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", nn.Conv3d(nf, nf_out, 4, 2, 1,
                                                  bias=use_bias))
            self.add_module(f"bn{n}", norm_layer(norm, nf_out))
            nf = nf_out
        nf_out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", nn.Conv3d(nf, nf_out, 4, 1, 1,
                                                     bias=use_bias))
        self.add_module(f"bn{n_layers}", norm_layer(norm, nf_out))
        self.head = nn.Conv3d(nf_out, 1, 4, 1, 1, bias=True)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"bn{n}")(h), 0.2)
        return self.head(h).float()
