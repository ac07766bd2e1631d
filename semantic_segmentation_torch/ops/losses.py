"""Segmentation / GAN losses — the port of the parts of
``semantic_segmentation_tpu/ops/losses.py`` the flagship trainer uses.

Parity targets: Dice ``util/dice_score.py:5-28`` (binary, and the
multi-class mean the evaluation protocol scores); Jaccard
``running_files/train_end2end_isic.py:40-57`` (the ISIC family's metric and
training loss); BCE-with-logits and cross-entropy criteria
``running_files/train_end2end_jsrt.py:136``; GAN
objectives ``models_pix2pix/networks.py:215-318``; the GenSeg-3D criterion
(weighted cross entropy and the argmax Dice, ``GenSeg-3D/train_end2end.py:
40-57, 139``) and the 3D generator's sum-reduced L1/MSE with the
``zero_division`` guard (``GenSeg-3D/util/util.py:25-26``). Reductions run
in float32 whatever the autocast dtype.
"""

from __future__ import annotations

import torch

from semantic_segmentation_torch.parallel import collectives


def dice_coeff(pred, target, reduce_batch_first: bool = False,
               epsilon: float = 1e-6):
    """Mean Dice coefficient (``util/dice_score.py:5-18``): per leading
    element unless ``reduce_batch_first`` folds the batch into one global
    Dice (under data parallelism its sums are the global batch's); an
    empty union scores 1."""
    pred, target = pred.float(), target.float()
    assert pred.shape == target.shape, (pred.shape, target.shape)
    folded = pred.dim() > 2 and reduce_batch_first
    dims = (-1, -2, -3) if folded else (-1, -2)
    inter = 2.0 * torch.sum(pred * target, dim=dims)
    sets_sum = torch.sum(pred, dim=dims) + torch.sum(target, dim=dims)
    if folded:
        inter, sets_sum = collectives.all_reduce_sum(
            torch.stack([inter, sets_sum])).unbind(0)
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


def jaccard_index_loss(y_true, y_pred, smooth: float = 1.0):
    """(1 - smoothed IoU) * smooth (``train_end2end_isic.py:55-57``)."""
    return (1.0 - jaccard_index(y_true, y_pred, smooth)) * smooth


def dice_loss(pred, target, multiclass: bool = False):
    """1 - Dice, with the batch folded first (``util/dice_score.py:26-28``);
    ``multiclass`` averages over (batch, class) planes."""
    fn = multiclass_dice_coeff if multiclass else dice_coeff
    return 1.0 - fn(pred, target, reduce_batch_first=True)


def bce_with_logits(logits, targets):
    """Mean binary cross entropy on logits (numerically stable)."""
    logits, targets = logits.float(), targets.float()
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(loss)


def softmax_cross_entropy(logits, labels, dim: int = 1):
    """Mean cross entropy with integer class labels, the classes along
    ``dim`` (torch ``CrossEntropyLoss``, the multi-class criterion)."""
    logp = torch.log_softmax(logits.float(), dim=dim)
    return -torch.mean(logp.gather(dim, labels.long().unsqueeze(dim)))


def softmax_cross_entropy_weighted(logits, labels, class_weights,
                                   dim: int = 1):
    """torch ``CrossEntropyLoss(weight=w)``: sum(w[y] * nll) / sum(w[y]),
    the classes along ``dim`` — the GenSeg-3D criterion with
    ``BCE_WEIGHTS = (0.004, 0.996)`` (``GenSeg-3D/UNet3D/config.py:35``).
    Under data or spatial parallelism the sums are the global batch's."""
    labels = labels.long()
    logp = torch.log_softmax(logits.float(), dim=dim)
    nll = -logp.gather(dim, labels.unsqueeze(dim)).squeeze(dim)
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[labels]
    if collectives.active():
        # this rank's share of the global ratio: its numerator over the
        # global denominator, times the ranks (parallel/collectives.py)
        return torch.sum(w * nll) * collectives.world() \
            / collectives.all_reduce_sum(torch.sum(w))
    return torch.sum(w * nll) / torch.sum(w)


@torch.no_grad()
def argmax_dice_score(logits, target, dim: int = 1, epsilon: float = 1e-6):
    """GenSeg-3D's ``dice_score`` (``train_end2end.py:40-54``): the global
    Dice of the argmax prediction (over the global batch under data or
    spatial parallelism). A constant with respect to the logits (the
    reference calls ``.item()`` on it): computed detached."""
    pred = torch.argmax(logits.float(), dim=dim).float()
    target = target.float()
    inter = torch.sum(pred * target)
    union = torch.sum(pred) + torch.sum(target)
    if collectives.active():            # the global batch's sums
        inter, union = collectives.all_reduce_sum(torch.stack([inter,
                                                               union]))
    return (2.0 * inter + epsilon) / (union + epsilon)


def argmax_dice_loss(logits, target, smooth: float = 1.0, dim: int = 1):
    """``train_end2end.py:56-57``: (1 - dice_score) * smooth, a constant
    with respect to the parameters, as in the reference."""
    return (1.0 - argmax_dice_score(logits, target, dim)) * smooth


def zero_division(n, d):
    """``GenSeg-3D/util/util.py:25-26``: n / d if d else 0. The division
    runs on a safe denominator, so neither the value nor the gradient of
    the branch not taken can be NaN."""
    d = torch.as_tensor(d, dtype=torch.float32, device=n.device)
    nonzero = d != 0
    return torch.where(nonzero, n / torch.where(nonzero, d,
                                                torch.ones_like(d)),
                       torch.zeros_like(n))


def l1_loss_sum(pred, target):
    return torch.sum(torch.abs(pred.float() - target.float()))


def mse_loss_sum(pred, target):
    return torch.sum(torch.square(pred.float() - target.float()))


def seg_criterion(logits, targets, n_classes: int):
    """BCE-with-logits for one class, cross entropy (classes along dim 1)
    for several (``running_files/train_end2end_jsrt.py:136``)."""
    if n_classes > 1:
        return softmax_cross_entropy(logits, targets, dim=1)
    return bce_with_logits(logits, targets)


def gan_loss(pred, target_is_real: bool, gan_mode: str = "vanilla"):
    """GANLoss: vanilla (BCE on logits), lsgan (MSE) or wgangp (the signed
    mean: -mean for real, +mean for fake)."""
    pred = pred.float()
    if gan_mode == "wgangp":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
    if gan_mode == "vanilla":
        return bce_with_logits(pred, target)
    if gan_mode == "lsgan":
        return torch.mean(torch.square(pred - target))
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def gradient_penalty(disc_fn, real, fake, kind: str = "mixed",
                     constant: float = 1.0, lambda_gp: float = 10.0,
                     alpha=None, generator: torch.Generator | None = None):
    """The WGAN-GP penalty (``models_pix2pix/networks.py:284-318``):
    ``lambda_gp * mean((|grad_x D(x)| - constant)^2)`` at x the real
    images, the fakes or (``mixed``) ``alpha * real + (1 - alpha) * fake``
    with one ``alpha`` per image, (N, 1, ...) uniform, given or drawn from
    ``generator``. The gradient is taken of the sum of ``disc_fn``'s
    logits with its graph kept, so the penalty differentiates with
    respect to D's weights (and to the images where they carry a graph); the norm is of ``grads + 1e-16``, as the JAX
    package takes it."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device)
    real, fake = real.float(), fake.float()
    if kind == "real":
        interp = real
    elif kind == "fake":
        interp = fake
    elif kind == "mixed":
        if alpha is None:
            alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1),
                               generator=generator, device=real.device)
        interp = alpha * real + (1.0 - alpha) * fake
    else:
        raise NotImplementedError(kind)
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(interp).float().sum(), interp,
                                   create_graph=True)
    norm = torch.linalg.vector_norm(
        grads.reshape(real.shape[0], -1) + 1e-16, dim=1)
    return torch.mean(torch.square(norm - constant)) * lambda_gp


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred.float() - target.float()))


def mse_loss(pred, target):
    return torch.mean(torch.square(pred.float() - target.float()))
