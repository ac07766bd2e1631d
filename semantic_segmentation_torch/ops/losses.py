"""Segmentation / GAN losses — the port of the parts of
``semantic_segmentation_tpu/ops/losses.py`` the flagship trainer uses.

Parity targets: Dice ``util/dice_score.py:5-28`` (binary, and the
multi-class mean the evaluation protocol scores); Jaccard
``running_files/train_end2end_isic.py:40-53`` (evaluation only: the Jaccard
and multi-class training losses come with the ISIC slice);
BCE-with-logits criterion ``running_files/train_end2end_jsrt.py:136``; GAN
objectives ``models_pix2pix/networks.py:215-318``. Reductions run in
float32 whatever the autocast dtype.
"""

from __future__ import annotations

import torch


def dice_coeff(pred, target, reduce_batch_first: bool = False,
               epsilon: float = 1e-6):
    """Mean Dice coefficient (``util/dice_score.py:5-18``): per leading
    element unless ``reduce_batch_first`` folds the batch into one global
    Dice; an empty union scores 1."""
    pred, target = pred.float(), target.float()
    assert pred.shape == target.shape, (pred.shape, target.shape)
    dims = (-1, -2) if pred.dim() == 2 or not reduce_batch_first \
        else (-1, -2, -3)
    inter = 2.0 * torch.sum(pred * target, dim=dims)
    sets_sum = torch.sum(pred, dim=dims) + torch.sum(target, dim=dims)
    sets_sum = torch.where(sets_sum == 0, inter, sets_sum)
    return torch.mean((inter + epsilon) / (sets_sum + epsilon))


def multiclass_dice_coeff(pred, target, reduce_batch_first: bool = False,
                          epsilon: float = 1e-6):
    """Average Dice over classes: flattens (batch, class) like
    ``util/dice_score.py:21-23``."""
    pred = pred.reshape((-1,) + tuple(pred.shape[2:]))
    target = target.reshape((-1,) + tuple(target.shape[2:]))
    return dice_coeff(pred, target, reduce_batch_first, epsilon)


def jaccard_index(y_true, y_pred, smooth: float = 1.0):
    """Smoothed IoU, averaged over the batch
    (``running_files/train_end2end_isic.py:40-53``)."""
    y_true, y_pred = y_true.float(), y_pred.float()
    if y_pred.dim() == 2:
        y_true, y_pred = y_true[None], y_pred[None]
    # all leading axes fold into one batch axis (the reference loops over
    # dim 0)
    y_true = y_true.reshape((-1,) + tuple(y_true.shape[-2:]))
    y_pred = y_pred.reshape((-1,) + tuple(y_pred.shape[-2:]))
    inter = torch.sum(torch.abs(y_true * y_pred), dim=(-1, -2))
    sum_ = torch.sum(torch.abs(y_true) + torch.abs(y_pred), dim=(-1, -2))
    return torch.mean((inter + smooth) / (sum_ - inter + smooth))


def dice_loss(pred, target):
    """1 - Dice, with the batch folded first (``util/dice_score.py:26-28``)."""
    return 1.0 - dice_coeff(pred, target, reduce_batch_first=True)


def bce_with_logits(logits, targets):
    """Mean binary cross entropy on logits (numerically stable)."""
    logits, targets = logits.float(), targets.float()
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(loss)


def gan_loss(pred, target_is_real: bool, gan_mode: str = "vanilla"):
    """GANLoss: vanilla (BCE on logits) or lsgan (MSE)."""
    pred = pred.float()
    target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
    if gan_mode == "vanilla":
        return bce_with_logits(pred, target)
    if gan_mode == "lsgan":
        return torch.mean(torch.square(pred - target))
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred.float() - target.float()))
