"""UNet3D, the GenSeg-3D segmentation net — the port of
``semantic_segmentation_tpu/models/unet3d.py``
(``GenSeg-3D/UNet3D/unet3d.py:14-134``): a 3-level analysis path of double
3x3x3 convs (the first halving the block's width), a bottleneck, and a
synthesis path of 2^3 transposed-conv ups (``in_channels`` wide, the
reference's), skip concat and double convs, a 1x1x1 head. NCDHW.

The reference's ``UpConv3DBlock`` calls ONE BatchNorm module after both of
its convs (:81-93), so that module's running statistics fold twice per
train-mode forward; kept. Init as the JAX package's: kernels torch's
kaiming-uniform with the fan-in C_in * k^3 (also for the transposed conv),
conv biases 0, the transposed conv's bias U(+-1/sqrt(fan_in)). Max-pool is
``F.max_pool3d`` (the JAX reshape pool is a TPU lowering of it).

Under a spatial mesh (``parallel/spatial.depth_sharded``) each rank holds
one depth slab of the volume: a k3 conv takes a one-slice halo of each
neighbour and pads depth 0 (H and W stay padded 1); the pool, the k2 s2
transposed conv and the 1x1x1 head need none while the slab's depth is
even; BN reduces its statistics over the group. A level whose slab would
be odd before its pool (the thin depths of a small crop over many ranks)
gathers its depth and runs whole on every rank, its BN local (every rank
computes the same), and the levels below it too; the way up splits again
where the skip is split.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import (BatchNorm2d,
                                                    kaiming_uniform_)
from semantic_segmentation_torch.parallel import collectives, spatial


def _conv(c_in: int, c_out: int, k: int, generator) -> nn.Conv3d:
    conv = nn.Conv3d(c_in, c_out, k, padding=k // 2)
    kaiming_uniform_(conv.weight, c_in * k ** 3, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _conv3(conv: nn.Conv3d, x, sp):
    """``conv`` (k3, padding 1) on ``x``; under the spatial mesh ``sp``, on
    this rank's depth slab with a one-slice halo and depth padding 0."""
    if sp is None:
        return conv(x)
    return F.conv3d(spatial.halo(x, 1, sp), conv.weight, conv.bias,
                    padding=(0, 1, 1))


def _level(slab, sp):
    """The context of a level's block under the spatial mesh ``sp``: on
    depth slabs (``slab``, the mesh), BN over the group; whole on every rank
    (None), BN local. Without a mesh, as the caller's."""
    return contextlib.nullcontext() if sp is None or slab is not None \
        else collectives.replicated()


class Conv3DBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck: bool = False, generator=None):
        super().__init__()
        self.bottleneck = bottleneck
        self.conv1 = _conv(in_channels, out_channels // 2, 3, generator)
        self.bn1 = BatchNorm2d(out_channels // 2)
        self.conv2 = _conv(out_channels // 2, out_channels, 3, generator)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x, sp=None):
        """``sp``: the spatial mesh ``x`` is a depth slab of, or None."""
        h = F.relu(self.bn1(_conv3(self.conv1, x, sp)))
        res = F.relu(self.bn2(_conv3(self.conv2, h, sp)))
        if self.bottleneck:
            return res, res
        return F.max_pool3d(res, 2, 2), res


class UpConv3DBlock(nn.Module):
    def __init__(self, in_channels: int, res_channels: int = 0,
                 last_layer: bool = False, num_classes: int | None = None,
                 generator=None):
        super().__init__()
        self.last_layer = last_layer
        self.upconv1 = nn.ConvTranspose3d(in_channels, in_channels, 2, 2)
        fan_in = in_channels * 8
        kaiming_uniform_(self.upconv1.weight, fan_in, generator)
        kaiming_uniform_(self.upconv1.bias, fan_in, generator)
        self.bn = BatchNorm2d(in_channels // 2)   # ONE, called twice
        self.conv1 = _conv(in_channels + res_channels, in_channels // 2, 3,
                           generator)
        self.conv2 = _conv(in_channels // 2, in_channels // 2, 3, generator)
        if last_layer:
            self.conv3 = _conv(in_channels // 2, num_classes, 1, generator)

    def forward(self, x, residual=None, sp=None, split=False):
        """``sp``: the spatial mesh ``residual`` is a depth slab of, or
        None; ``split``: ``x`` is whole, and the up-conv's output is split
        to this rank's slab."""
        h = self.upconv1(x)
        if split:
            h = spatial.split_depth(h, sp)
        if residual is not None:
            h = torch.cat([h, residual.to(h.dtype)], dim=1)
        h = F.relu(self.bn(_conv3(self.conv1, h, sp)))
        h = F.relu(self.bn(_conv3(self.conv2, h, sp)))
        if self.last_layer:
            h = self.conv3(h)
        return h


class UNet3D(nn.Module):
    """``level_channels`` (l1, l2, l3) and ``bottleneck_channel``: 64, 128,
    256 and 512 in the reference; weights drawn from ``generator``."""

    def __init__(self, in_channels: int = 1, num_classes: int = 2,
                 level_channels: tuple = (64, 128, 256),
                 bottleneck_channel: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_channels, self.n_classes = in_channels, num_classes
        l1, l2, l3 = level_channels
        g = generator
        self.a_block1 = Conv3DBlock(in_channels, l1, generator=g)
        self.a_block2 = Conv3DBlock(l1, l2, generator=g)
        self.a_block3 = Conv3DBlock(l2, l3, generator=g)
        self.bottleneck = Conv3DBlock(l3, bottleneck_channel, True,
                                      generator=g)
        self.s_block3 = UpConv3DBlock(bottleneck_channel, l3, generator=g)
        self.s_block2 = UpConv3DBlock(l3, l2, generator=g)
        self.s_block1 = UpConv3DBlock(l2, l1, True, num_classes, generator=g)

    def forward(self, x):
        """Under a spatial mesh, on this rank's depth slab ``x`` (module
        docstring): each level on slabs while they stay even before its
        pool, else whole."""
        sp = spatial.active_mesh()
        out, slab, skips = x, sp, []
        for block in (self.a_block1, self.a_block2, self.a_block3):
            if slab is not None and out.shape[2] % 2:
                out, slab = spatial.gather_depth(out, sp), None
            with _level(slab, sp):
                out, res = block(out, slab)
            skips.append((res, slab))
        with _level(slab, sp):
            out, _ = self.bottleneck(out, slab)
        for block, (res, res_slab) in zip(
                (self.s_block3, self.s_block2, self.s_block1),
                reversed(skips)):
            with _level(res_slab, sp):
                out = block(out, res, res_slab,
                            split=res_slab is not None and slab is None)
            slab = res_slab
        return out.float()
