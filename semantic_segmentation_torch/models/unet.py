"""Segmentation U-Net — the port of ``semantic_segmentation_tpu/models/
unet.py`` (milesial ``unet/unet_model.py:7-49`` + ``unet/unet_parts.py:8-77``):
4 max-pool downs, 4 ups, pad-to-match skip concat, DoubleConv = (conv3x3
no-bias -> BN -> ReLU) x 2. NCHW. The ups are transposed convs (k2 s2), or
with ``bilinear`` an align-corners 2x upsample, the JAX package's
``DoubleConv`` of mid width half the upsampled input's channels, and half
widths from ``down4`` on (``factor = 2``).

Submodule names follow the JAX package's (``inc``, ``down1``..``up4``,
``outc``; ``conv0``/``bn0``/``conv1``/``bn1`` inside a DoubleConv) so the
weight bridge maps the two trees leaf by leaf.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import (BatchNorm2d,
                                                    kaiming_uniform_,
                                                    pad_to_match,
                                                    upsample_bilinear_2x)


class DoubleConv(nn.Module):
    """(conv3x3 no-bias => BN => ReLU) * 2 (unet/unet_parts.py:8-25)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.conv0 = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn0 = BatchNorm2d(mid)
        self.conv1 = nn.Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_channels)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class Down(nn.Module):
    """maxpool(2) -> DoubleConv (unet/unet_parts.py:28-39)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x):
        return self.conv(F.max_pool2d(x, 2))


class Up(nn.Module):
    """ConvTranspose(k2, s2) -> pad-to-match -> concat [skip, up] ->
    DoubleConv (unet/unet_parts.py:42-70). With ``bilinear`` the up is the
    align-corners 2x upsample of all ``up_channels`` input channels, and
    the DoubleConv's mid width is ``up_channels // 2`` (JAX
    ``models/unet.py:62-82``)."""

    def __init__(self, up_channels: int, skip_channels: int,
                 out_channels: int, bilinear: bool = False):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(up_channels + skip_channels, out_channels,
                                   up_channels // 2)
        else:
            self.up = nn.ConvTranspose2d(up_channels, up_channels // 2, 2,
                                         stride=2)
            self.conv = DoubleConv(up_channels // 2 + skip_channels,
                                   out_channels)

    def forward(self, x, skip):
        x = upsample_bilinear_2x(x) if self.bilinear else self.up(x)
        x = pad_to_match(x, skip.shape[-2:])
        return self.conv(torch.cat([skip, x.to(skip.dtype)], dim=1))


class UNet(nn.Module):
    """unet/unet_model.py:7-37. NCHW float in, NCHW float32 logits out."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 base_features: int = 64, bilinear: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = base_features
        k = 2 if bilinear else 1
        self.n_channels, self.n_classes = n_channels, n_classes
        self.bilinear = bilinear
        self.inc = DoubleConv(n_channels, f)
        self.down1 = Down(f, f * 2)
        self.down2 = Down(f * 2, f * 4)
        self.down3 = Down(f * 4, f * 8)
        self.down4 = Down(f * 8, f * 16 // k)
        self.up1 = Up(f * 16 // k, f * 8, f * 8 // k, bilinear)
        self.up2 = Up(f * 8 // k, f * 4, f * 4 // k, bilinear)
        self.up3 = Up(f * 4 // k, f * 2, f * 2 // k, bilinear)
        self.up4 = Up(f * 2 // k, f, f, bilinear)
        self.outc = nn.Conv2d(f, n_classes, 1)
        # torch's kaiming-uniform law with the JAX package's fan-in,
        # C_in * k * k, also for the transposed convs (torch's own init
        # would take C_out * k * k there), drawn from ``generator``
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                kaiming_uniform_(m.weight, fan_in, generator)
                if m.bias is not None:
                    kaiming_uniform_(m.bias, fan_in, generator)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y).float()
