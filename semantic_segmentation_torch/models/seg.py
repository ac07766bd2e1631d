"""Segmentation problem: net + loss + optimizer factory — the port of
``semantic_segmentation_tpu/models/seg.py``.

Loss parity: BCE-with-logits + Dice on sigmoid for the JSRT family
(``train_end2end_jsrt.py:181-183``), BCE + smoothed Jaccard for ISIC
(``train_end2end_isic.py:247-249``); cross entropy + multi-class Dice when
classes > 1. Optimizer: RMSprop(lr, wd=1e-8, momentum=0.9), its lr stepped
by ReduceLROnPlateau from the validation hook
(``train_end2end_jsrt.py:71-73``); with ``accumulate`` k > 1 it steps on the
mean of k micro-gradients (``optax.MultiSteps``, JAX ``models/seg.py:61-75``).
Segmenters: the milesial U-Net (``unet``, transposed-conv or bilinear
ups), DeepLabV3 (``deeplab``), DeepLabV2 (``deeplabv2``) and the Swin-UNet
(``vit``, ``swin``, ``swin_unet``).
"""

from __future__ import annotations

import torch

from semantic_segmentation_torch.core.optim import Accumulate, rmsprop_torch
from semantic_segmentation_torch.models.deeplab import DeepLabV2, DeepLabV3
from semantic_segmentation_torch.models.swin_unet import SwinUnet
from semantic_segmentation_torch.models.unet import UNet
from semantic_segmentation_torch.ops import losses
from semantic_segmentation_torch.ops.layers import call_module

SWIN_NAMES = ("vit", "swin", "swin_unet")


def seg_loss_fn(logits, masks, n_classes: int = 1, loss_type: str = "dice"):
    """criterion + region loss. ``logits`` NCHW; ``masks`` N1HW or NHW."""
    masks_hw = masks[:, 0] if masks.dim() == logits.dim() else masks
    if n_classes == 1:
        target = masks_hw.float()
        loss = losses.bce_with_logits(logits, target[:, None])
        probs = torch.sigmoid(logits[:, 0].float())
        if loss_type == "dice":
            return loss + losses.dice_loss(probs, target)
        if loss_type == "jaccard":
            return loss + losses.jaccard_index_loss(probs, target)
        raise ValueError(loss_type)
    labels = masks_hw.long()
    loss = losses.softmax_cross_entropy(logits, labels)
    probs = torch.softmax(logits.float(), dim=1)
    onehot = torch.nn.functional.one_hot(labels, n_classes).permute(
        0, 3, 1, 2).float()
    return loss + losses.dice_loss(probs, onehot, multiclass=True)


def create_seg_model(name: str, n_channels: int, n_classes: int,
                     generator: torch.Generator | None = None, **kw):
    """The segmenter ``name`` (``models/__init__.create_seg_model`` of the
    JAX package): ``unet`` takes ``base_features``/``bilinear``, the
    DeepLabs ``layers`` (and V2 ``output_stride``), the Swin names
    ``img_size``/``drop_path_rate``/``use_checkpoint``/..."""
    if name == "unet":
        return UNet(n_channels, n_classes, kw.get("base_features", 64),
                    kw.get("bilinear", False), generator)
    if name == "deeplab":
        return DeepLabV3(n_channels, n_classes, generator=generator, **kw)
    if name == "deeplabv2":
        return DeepLabV2(n_channels, n_classes, generator=generator, **kw)
    if name in SWIN_NAMES:
        return SwinUnet(n_channels, n_classes, generator=generator, **kw)
    raise ValueError(f"unknown segmentation model: {name}")


class SegProblem:
    """The segmentation net (on ``device``) and its loss/optimizer."""

    def __init__(self, seg_model="unet", n_channels=1, n_classes=1, lr=1e-4,
                 loss_type="dice", device="cpu",
                 generator: torch.Generator | None = None, accumulate=1,
                 **model_kw):
        self.net = create_seg_model(seg_model, n_channels, n_classes,
                                    generator, **model_kw).to(device)
        # the Swin-UNet's drop paths and DeepLabV3's ASPP dropout draw in
        # train mode
        self.stochastic = isinstance(self.net, (SwinUnet, DeepLabV3))
        self.n_classes, self.loss_type, self.lr = n_classes, loss_type, lr
        self.accumulate = accumulate

    def make_opt(self):
        opt = rmsprop_torch(self.net.parameters(), self.lr)
        return Accumulate(opt, self.accumulate) if self.accumulate > 1 \
            else opt

    def draw(self, shape, generator: torch.Generator | None = None):
        """The train-mode draws of one forward on an NCHW input of
        ``shape``, as the forward itself would draw them from
        ``generator`` (None for a net that draws nothing), so that a
        recomputed forward (``model.remat``) reads the same masks."""
        device = next(self.net.parameters()).device
        if isinstance(self.net, SwinUnet):
            return self.net.draw_drop_path(shape[0], generator, device)
        if isinstance(self.net, DeepLabV3):
            return self.net.draw_dropout(shape, generator, device)
        return None

    def apply(self, images, train: bool, params=None,
              keep_stats: bool = True, drop_masks=None,
              generator: torch.Generator | None = None):
        """Logits of NCHW images; train mode updates the BN stats (scratch
        copies of them with ``keep_stats`` False or ``params`` given, which
        replaces the net's parameters). The train-mode draws (the Swin's
        drop paths, DeepLabV3's ASPP dropout) take ``drop_masks`` or draw
        from ``generator``."""
        self.net.train(train)
        args = ((images, drop_masks, generator) if self.stochastic
                else (images,))
        return call_module(self.net, args, keep_stats, params)

    @torch.no_grad()
    def eval_logits(self, images):
        return self.apply(images, train=False)
