"""Feature extractors for generative-quality evaluation (FID, LPIPS) — the
port of ``semantic_segmentation_tpu/models/extractors.py``, NCHW:

- ``InceptionV3Pool3``: pytorch-fid's InceptionV3 pool3 head
  (``BBDM/evaluation/FID.py:11-17``): torchvision's InceptionV3 with the
  FID variants (the blocks' average pools exclude padding, the last
  InceptionE max-pools), inference only, its BN in eval mode (eps 1e-3).
  Its input is resized to 299^2 as ``jax.image.resize`` does: bilinear,
  half-pixel centres, antialiased when it shrinks, with JAX's own float32
  weights (``resize_weights``).
- ``AlexNetFeatures`` and ``lpips_alex``: LPIPS 'alex'
  (``BBDM/evaluation/LPIPS.py:10-30``): the scaling layer, the relu1-5
  taps of torchvision's AlexNet.features, channel-unit-normalized,
  weighted by the learned per-channel ``lin`` weights, spatial mean, layer
  sum.

Module names are the JAX package's (and the torch checkpoints'), so
``utils/bridge`` and ``utils/torch_port`` map weights by name. The real
weights are not in the repository; with random ones the nets run and the
scores mean nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.models.vgg import (lpips_from_features,
                                                    scaling_layer)
from semantic_segmentation_torch.ops.layers import BatchNorm2d


def avg_pool_3x3_valid_count(x):
    """3x3 stride-1 average pool, padded to keep the size, dividing by the
    count of taps inside the image (count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """torchvision BasicConv2d: conv (no bias) + BN (eps 1e-3, its running
    statistics always) + relu."""

    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = self.conv(x)
        return F.relu(F.batch_norm(x, bn.running_mean, bn.running_var,
                                   bn.weight, bn.bias, False, 0.0, bn.eps))


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_valid_count(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3_valid_count(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg' (Mixed_7b) or 'max' (Mixed_7c, the FID
    variant)."""

    def __init__(self, c_in: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, 1, padding=1)
        else:
            bp = avg_pool_3x3_valid_count(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         dim=1)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """The (n_in, n_out) float32 weight matrix of ``jax.image.resize``'s
    'bilinear' along one axis (``compute_weight_mat``), computed as it
    computes it in float32: half-pixel centres, a triangle kernel widened
    by the shrink factor when it shrinks (antialias), each output's
    weights normalized to sum 1."""
    f32 = torch.float32
    inv_scale = torch.tensor(n_in / n_out, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_299(x_nchw):
    """``jax.image.resize(x, (N, 299, 299, C), 'bilinear')``: its float32
    weight matrices (``resize_weights``) contracted with the image in
    float64 (``F.interpolate(antialias=True)`` is the same resize, but its
    float32 weights part from JAX's by 1.2e-5 at 320 -> 299)."""
    h, w = x_nchw.shape[-2:]
    if (h, w) == (299, 299):
        return x_nchw
    f64 = torch.float64
    wh = resize_weights(h, 299).to(x_nchw.device, f64)
    ww = resize_weights(w, 299).to(x_nchw.device, f64)
    return torch.einsum("nchw,hy,wx->ncyx", x_nchw.to(f64), wh, ww
                        ).to(x_nchw.dtype)


class InceptionV3Pool3(nn.Module):
    """pytorch-fid's pool3 feature head. ``forward(x)``: x NHWC in [0, 1]
    at any size (grayscale repeated to 3 channels), resized to 299^2 and
    scaled to [-1, 1] (pytorch_fid's ``resize_input`` /
    ``normalize_input``); returns (N, 2048) float32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = torch.as_tensor(x).float()
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = 2.0 * resize_299(x.permute(0, 3, 1, 2)) - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()


# (C_out, kernel, stride, padding, max-pool before) of AlexNet.features'
# five convs
ALEX_SPECS = ((64, 11, 4, 2, False), (192, 5, 1, 2, True),
              (384, 3, 1, 1, True), (256, 3, 1, 1, False),
              (256, 3, 1, 1, False))
ALEX_WIDTHS = tuple(s[0] for s in ALEX_SPECS)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features' relu1-5 taps (the LPIPS 'alex'
    backbone), ``conv0`` ... ``conv4``. Input NCHW, already through the
    scaling layer; returns the five taps."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, (c, k, s, p, _) in enumerate(ALEX_SPECS):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, c, k, s, p))
            c_in = c

    def forward(self, x):
        feats = []
        for i, (*_, pool) in enumerate(ALEX_SPECS):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return feats


def _lpips_prep(x_nhwc):
    x = torch.as_tensor(x_nhwc).float()
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return scaling_layer(2.0 * x.permute(0, 3, 1, 2) - 1.0)


def lpips_alex(net: AlexNetFeatures, lin_weights, a, b):
    """LPIPS(alex) per pair: ``a``, ``b`` NHWC in [0, 1] (on the net's
    device); ``lin_weights`` five per-channel vectors (the lpips
    checkpoint's ``lin{i}.model.1.weight``). Returns (N,)."""
    return lpips_from_features(net(_lpips_prep(a)), net(_lpips_prep(b)),
                               lin_weights)
