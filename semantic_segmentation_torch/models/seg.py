"""Segmentation problem: net + loss + optimizer factory — the port of
``semantic_segmentation_tpu/models/seg.py`` for the U-Net.

Loss parity: BCE-with-logits + Dice on sigmoid for the JSRT family
(``train_end2end_jsrt.py:181-183``). Optimizer: RMSprop(lr, wd=1e-8,
momentum=0.9), its lr stepped by ReduceLROnPlateau from the validation hook
(``train_end2end_jsrt.py:71-73``).
"""

from __future__ import annotations

import torch

from semantic_segmentation_torch.core.optim import rmsprop_torch
from semantic_segmentation_torch.models.unet import UNet
from semantic_segmentation_torch.ops import losses
from semantic_segmentation_torch.ops.layers import call_module


def seg_loss_fn(logits, masks, n_classes: int = 1, loss_type: str = "dice"):
    """criterion + region loss. ``logits`` N1HW; ``masks`` N1HW or NHW."""
    if n_classes != 1 or loss_type != "dice":
        raise NotImplementedError(
            f"seg_loss_fn: only binary BCE + dice is ported "
            f"(n_classes={n_classes}, loss_type={loss_type!r})")
    target = masks.float()
    if target.dim() == logits.dim() - 1:
        target = target[:, None]
    loss = losses.bce_with_logits(logits, target)
    probs = torch.sigmoid(logits[:, 0].float())
    return loss + losses.dice_loss(probs, target[:, 0])


class SegProblem:
    """The segmentation net (on ``device``) and its loss/optimizer."""

    def __init__(self, seg_model="unet", n_channels=1, n_classes=1, lr=1e-4,
                 loss_type="dice", base_features=64, bilinear=False,
                 device="cpu", generator: torch.Generator | None = None):
        if seg_model != "unet" or bilinear:
            raise NotImplementedError(
                f"seg model {seg_model!r} (bilinear={bilinear}) is not "
                "ported yet")
        self.net = UNet(n_channels, n_classes, base_features,
                        generator).to(device)
        self.n_classes, self.loss_type, self.lr = n_classes, loss_type, lr

    def make_opt(self):
        return rmsprop_torch(self.net.parameters(), self.lr)

    def apply(self, images, train: bool, params=None,
              keep_stats: bool = True):
        """Logits of NCHW images; train mode updates the BN stats (scratch
        copies of them with ``keep_stats`` False or ``params`` given, which
        replaces the net's parameters)."""
        self.net.train(train)
        return call_module(self.net, (images,), keep_stats, params)

    @torch.no_grad()
    def eval_logits(self, images):
        return self.apply(images, train=False)
