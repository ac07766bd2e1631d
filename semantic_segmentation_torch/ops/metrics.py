"""Evaluation protocol — parity with ``unet/evaluate.py:10-43``, the port of
``semantic_segmentation_tpu/ops/metrics.py``.

Binary: Dice of (sigmoid(logits) > 0.5) vs the true mask, per image,
averaged over the batch. Multi-class: one-hot argmax Dice over the classes
without the background. ISIC family: smoothed Jaccard of the binary
prediction. A dataset's score is the mean of its batch scores (the
reference's ``dice_score / num_batches``). Logits are NCHW (the port's
nets); masks N1HW or NHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semantic_segmentation_torch.ops.losses import (dice_coeff, jaccard_index,
                                                    multiclass_dice_coeff)


def _labels(logits, true_mask):
    if true_mask.dim() == logits.dim():
        true_mask = true_mask[:, 0]
    return true_mask


def _binary_pred(logits):
    return (torch.sigmoid(logits[:, 0].float()) > 0.5).float()


def eval_batch_dice(logits, true_mask, n_classes: int = 1):
    """One batch's Dice under the reference protocol; ``true_mask`` holds
    integer or float labels in [0, n_classes)."""
    true_mask = _labels(logits, true_mask)
    if n_classes == 1:
        return dice_coeff(_binary_pred(logits), true_mask.float(),
                          reduce_batch_first=False)
    pred_oh = F.one_hot(torch.argmax(logits, dim=1), n_classes)
    true_oh = F.one_hot(true_mask.long(), n_classes)
    # classes to axis 1 (N, C, H, W), background dropped like the
    # reference's mask_pred[:, 1:]
    pred_oh = pred_oh.permute(0, 3, 1, 2)[:, 1:].float()
    true_oh = true_oh.permute(0, 3, 1, 2)[:, 1:].float()
    return multiclass_dice_coeff(pred_oh, true_oh, reduce_batch_first=False)


def eval_batch_jaccard(logits, true_mask):
    """The ISIC scripts' metric (running_files/test_isic.py:56-84,
    train_end2end_isic.py:60-82): smoothed Jaccard of (sigmoid(logits) >
    0.5) vs the true mask, batch-averaged. Binary only, as in the
    reference."""
    true_mask = _labels(logits, true_mask)
    return jaccard_index(true_mask.float(), _binary_pred(logits))


def eval_batch_score(logits, true_mask, n_classes: int = 1,
                     metric: str = "dice"):
    """Protocol dispatch: the JSRT-family scripts score Dice
    (unet/evaluate.py), the ISIC-family scripts Jaccard (test_isic.py)."""
    if metric == "jaccard":
        return eval_batch_jaccard(logits, true_mask)
    return eval_batch_dice(logits, true_mask, n_classes)


def evaluate_dataset(apply_fn, batches, n_classes: int = 1) -> float:
    """Mean of the batch Dice over an iterable of (image, mask) batches;
    ``apply_fn(image) -> logits`` is an eval-mode forward."""
    total, count = 0.0, 0
    for image, mask in batches:
        total += float(eval_batch_dice(apply_fn(image), mask, n_classes))
        count += 1
    return total / max(count, 1)
