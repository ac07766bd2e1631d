"""DeepLabV3 and DeepLabV2 — the port of
``semantic_segmentation_tpu/models/deeplab.py``, the ``--seg_model deeplab``
and ``deeplabv2`` segmenters. NCHW.

- ``DeepLabV3`` (the reference's torchvision ``deeplabv3_resnet50``,
  ``deeplab/deeplabv3.py:3-16``): a grayscale input expanded to 3 channels,
  ResNet-50 at output stride 8 (layer3 dilation 2, layer4 dilation 4, the
  FIRST block of a dilated stage at the previous dilation, as torchvision's
  ``_make_layer``), ASPP (1x1, 3x3 at rates 12/24/36, image pooling;
  projection then Dropout(0.5)), the DeepLabHead 3x3 + BN + ReLU + 1x1, and
  the logits resized to the input bilinearly without corner alignment.
- ``DeepLabV2`` (``deeplabv2/deeplab_v2.py:13-89``,
  ``backbone/resnet.py:53-131``): a dilated ResNet-101 with a multi-grid
  layer4 ((1, 2, 4) x its dilation), output stride 16 or 8, its stem on the
  raw input channels, the sum of four dilated 3x3 convs (rates 6/12/18/24)
  as classifier, and the align-corners resize to the input.

Submodule names follow the JAX package's (``backbone.layer3_0.conv2``,
``aspp.b1_conv``, ...), so ``utils/bridge.py`` carries the weights leaf by
leaf. Init: flax's defaults (lecun-normal kernels, zero biases, unit BN
scales); DeepLabV2's stem He-normal on the fan-out and its classifier
N(0, 0.01), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import (
    BatchNorm2d, dropout_half, he_normal_fan_out_, lecun_normal_,
    resize_bilinear_align_corners)


def _conv(c_in, c_out, k, stride=1, dilation=1, bias=False):
    """A k x k conv with the JAX package's padding: ``dilation`` for the
    3x3s, k // 2 for the stem, none for the 1x1s."""
    pad = dilation * (k // 2)
    return nn.Conv2d(c_in, c_out, k, stride, pad, dilation, bias=bias)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, each with BN; a strided
    1x1 + BN on the identity of a stage's first block."""

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(c_in, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        if downsample:
            self.down_conv = _conv(c_in, planes * 4, 1, stride)
            self.down_bn = BatchNorm2d(planes * 4)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = (self.down_bn(self.down_conv(x))
                    if hasattr(self, "down_conv") else x)
        return F.relu(h + identity.to(h.dtype))


class _ResNet(nn.Module):
    """A stem (7x7 s2 conv, BN, ReLU, 3x3 s2 max-pool) and Bottleneck
    stages ``layer{L}_{B}`` from a list of (planes, first-block stride,
    per-block dilations)."""

    def __init__(self, c_in: int, stages):
        super().__init__()
        self.stem = _conv(c_in, 64, 7, stride=2)
        self.stem_bn = BatchNorm2d(64)
        self.blocks = []
        c = 64
        for li, (planes, stride, dils) in enumerate(stages):
            for bi, dil in enumerate(dils):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, Bottleneck(
                    c, planes, stride if bi == 0 else 1, dil,
                    downsample=bi == 0))
                self.blocks.append(name)
                c = planes * 4

    def forward(self, x):
        h = F.relu(self.stem_bn(self.stem(x)))
        # the JAX package pads with -inf and pools VALID: torch's padding
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return h


class ResNet50Backbone(_ResNet):
    """ResNet-50 at output stride 8: torchvision's ``resnet50(
    replace_stride_with_dilation=[False, True, True])``, whose first block
    of a dilated stage keeps the previous dilation (JAX ``:58-87``)."""

    def __init__(self, layers=(3, 4, 6, 3)):
        cfgs = ((64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 1, 2),
                (512, 1, 2, 4))
        super().__init__(3, [
            (planes, stride, (dil0,) + (dil,) * (n - 1))
            for n, (planes, stride, dil0, dil) in zip(layers, cfgs)])


class ASPP(nn.Module):
    """JAX ``:90-117``: 1x1, three dilated 3x3s and the image-pooling 1x1
    (BN on a 1x1 map), each + BN + ReLU, concatenated; a 1x1 projection +
    BN + ReLU, then Dropout(0.5) in train mode."""

    def __init__(self, c_in: int = 2048, rates=(12, 24, 36),
                 features: int = 256):
        super().__init__()
        self.rates = tuple(rates)
        self.b0_conv = _conv(c_in, features, 1)
        self.b0_bn = BatchNorm2d(features)
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i + 1}_conv", _conv(c_in, features, 3,
                                                    dilation=r))
            self.add_module(f"b{i + 1}_bn", BatchNorm2d(features))
        self.pool_conv = _conv(c_in, features, 1)
        self.pool_bn = BatchNorm2d(features)
        n_branches = len(self.rates) + 2
        self.proj_conv = _conv(n_branches * features, features, 1)
        self.proj_bn = BatchNorm2d(features)

    def forward(self, x, keep=None, generator=None):
        branches = []
        for i in range(len(self.rates) + 1):
            h = getattr(self, f"b{i}_conv")(x)
            branches.append(F.relu(getattr(self, f"b{i}_bn")(h)))
        g = x.mean(dim=(2, 3), keepdim=True)
        g = F.relu(self.pool_bn(self.pool_conv(g)))
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        h = torch.cat([b.to(branches[0].dtype) for b in branches], dim=1)
        h = F.relu(self.proj_bn(self.proj_conv(h)))
        if self.training:
            h = dropout_half(h, keep, generator)
        return h


def _flax_init(module: nn.Module, generator):
    """flax's defaults on every conv: lecun-normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


def _out_size(n: int, halvings: int) -> int:
    """The size after ``halvings`` stride-2 layers (each ceil(n / 2))."""
    for _ in range(halvings):
        n = (n + 1) // 2
    return n


class DeepLabV3(nn.Module):
    """JAX ``:120-148``. NCHW float in (1 or 3 channels), NCHW float32
    logits at the input's size out."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 layers=(3, 4, 6, 3),
                 generator: torch.Generator | None = None):
        super().__init__()
        if n_channels not in (1, 3):
            raise ValueError(f"DeepLabV3 takes 1 or 3 channels, not "
                             f"{n_channels}")
        self.n_channels, self.n_classes = n_channels, n_classes
        self.backbone = ResNet50Backbone(layers)
        self.aspp = ASPP()
        self.head_conv = _conv(256, 256, 3)
        self.head_bn = BatchNorm2d(256)
        self.classifier = _conv(256, n_classes, 1, bias=True)
        _flax_init(self, generator)

    def draw_dropout(self, shape, generator=None, device=None) -> dict:
        """{'aspp': (B, 256, h, w) bool keep-mask} for an input of NCHW
        ``shape``, drawn from ``generator`` as the train-mode forward
        draws it (the stride-8 map: stem, pool and layer2 halve)."""
        b, _, hh, ww = shape
        size = (b, 256, _out_size(hh, 3), _out_size(ww, 3))
        return {"aspp": torch.rand(size, generator=generator,
                                   device=device) < 0.5}

    def forward(self, x, drop_masks=None,
                generator: torch.Generator | None = None):
        """``drop_masks`` ({'aspp': keep-mask}) replaces the train-mode
        draw from ``generator``."""
        b, c, hh, ww = x.shape
        if c == 1:   # grayscale -> 3 channels (deeplab/deeplabv3.py:14-15)
            x = x.expand(b, 3, hh, ww)
        keep = None
        if self.training:
            keep = (drop_masks if drop_masks is not None else
                    self.draw_dropout(x.shape, generator, x.device))["aspp"]
        h = self.aspp(self.backbone(x), keep)
        h = F.relu(self.head_bn(self.head_conv(h)))
        h = self.classifier(h)
        # torchvision upsamples the logits, bilinear, no corner alignment
        return F.interpolate(h.float(), size=(hh, ww), mode="bilinear",
                             align_corners=False)


class ResNetMGBackbone(_ResNet):
    """Dilated ResNet-101 (or -50) with a multi-grid layer4 (JAX
    ``:159-197``): output stride 16 -> strides (1, 2, 2, 1), dilations
    (1, 1, 1, 2); 8 -> (1, 2, 1, 1), (1, 1, 2, 4); layer4's blocks at
    (1, 2, 4) x its dilation. The stem takes the raw input channels."""

    def __init__(self, n_channels: int = 1, layers=(3, 4, 23),
                 output_stride: int = 16):
        if output_stride == 16:
            strides, dils = (1, 2, 2, 1), (1, 1, 1, 2)
        elif output_stride == 8:
            strides, dils = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            raise NotImplementedError(f"output_stride {output_stride}")
        stages = [(planes, strides[li], (dils[li],) * n)
                  for li, (n, planes) in enumerate(zip(layers,
                                                       (64, 128, 256)))]
        stages.append((512, strides[3], tuple(g * dils[3]
                                              for g in (1, 2, 4))))
        super().__init__(n_channels, stages)


class ClassifierModule(nn.Module):
    """The sum of dilated 3x3 convs with bias over the 2048-channel map
    (JAX ``:200-216``)."""

    def __init__(self, n_classes: int = 1, rates=(6, 12, 18, 24)):
        super().__init__()
        self.n = len(rates)
        for i, r in enumerate(rates):
            self.add_module(f"conv{i}", _conv(2048, n_classes, 3,
                                              dilation=r, bias=True))

    def forward(self, x):
        out = self.conv0(x)
        for i in range(1, self.n):
            out = out + getattr(self, f"conv{i}")(x)
        return out


class DeepLabV2(nn.Module):
    """JAX ``:219-239``: backbone, classifier, the logits resized to the
    input with ``align_corners=True``."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 output_stride: int = 16, layers=(3, 4, 23),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.backbone = ResNetMGBackbone(n_channels, layers, output_stride)
        self.classifier = ClassifierModule(n_classes)
        _flax_init(self, generator)
        # the stem's and the classifier's own laws (JAX ``_he_out``,
        # ``normal(0.01)``)
        he_normal_fan_out_(self.backbone.stem.weight, generator)
        with torch.no_grad():
            for i in range(self.classifier.n):
                getattr(self.classifier, f"conv{i}").weight.normal_(
                    0.0, 0.01, generator=generator)

    def forward(self, x):
        h = self.classifier(self.backbone(x))
        return resize_bilinear_align_corners(h.float(), x.shape[-2:])
