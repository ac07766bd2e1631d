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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import (BatchNorm2d,
                                                    kaiming_uniform_)


def _conv(c_in: int, c_out: int, k: int, generator) -> nn.Conv3d:
    conv = nn.Conv3d(c_in, c_out, k, padding=k // 2)
    kaiming_uniform_(conv.weight, c_in * k ** 3, generator)
    nn.init.zeros_(conv.bias)
    return conv


class Conv3DBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck: bool = False, generator=None):
        super().__init__()
        self.bottleneck = bottleneck
        self.conv1 = _conv(in_channels, out_channels // 2, 3, generator)
        self.bn1 = BatchNorm2d(out_channels // 2)
        self.conv2 = _conv(out_channels // 2, out_channels, 3, generator)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        res = F.relu(self.bn2(self.conv2(h)))
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

    def forward(self, x, residual=None):
        h = self.upconv1(x)
        if residual is not None:
            h = torch.cat([h, residual.to(h.dtype)], dim=1)
        h = F.relu(self.bn(self.conv1(h)))
        h = F.relu(self.bn(self.conv2(h)))
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
        out, r1 = self.a_block1(x)
        out, r2 = self.a_block2(out)
        out, r3 = self.a_block3(out)
        out, _ = self.bottleneck(out)
        out = self.s_block3(out, r3)
        out = self.s_block2(out, r2)
        return self.s_block1(out, r1).float()
