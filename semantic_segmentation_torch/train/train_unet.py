"""Supervised segmentation training, the baseline GenSeg is judged against —
the port of ``semantic_segmentation_tpu/train/train_unet.py``: k-shot
training of the segmenter (any of ``model.seg_model``; from
``run.seg_pretrained`` when set) with RMSprop (``optim.accumulate``
micro-steps per update), Dice on the validation split every
``engine.valid_step`` steps, ReduceLROnPlateau on the best validation Dice,
a checkpoint at every new best, and the test and OOD Dice of the final net.

Usage: ``python -m semantic_segmentation_torch.train.train_unet
--data.dataroot=<dir> [--data.ood_roots=...] [--run.device=cpu]``
(``--data.synthetic=true`` for generated data).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import get_learning_rate
from semantic_segmentation_torch.data.pipeline import (batch_iterator,
                                                       eval_batches)
from semantic_segmentation_torch.models.seg import SegProblem, seg_loss_fn
from semantic_segmentation_torch.ops.metrics import eval_batch_score
from semantic_segmentation_torch.train.common import (autocast_for,
                                                      build_seg_problem,
                                                      load_splits)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


@torch.no_grad()
def evaluate_split(net, data, batch_size: int, n_classes: int = 1,
                   metric: str = "dice", amp=contextlib.nullcontext) -> float:
    """Mean over batches of the batch score of ``net`` in eval mode on a
    stacked NHWC split (``unet/evaluate.py``)."""
    device = next(net.parameters()).device
    net.eval()
    total, count = 0.0, 0
    for b in eval_batches(data, batch_size):
        images = _nchw(torch.from_numpy(b["image"]).float().to(device))
        with amp():
            logits = net(images)
        mask = _nchw(torch.from_numpy(b["mask"]).to(device))
        total += float(eval_batch_score(logits, mask, n_classes, metric))
        count += 1
    return total / max(count, 1)


def train_step(seg: SegProblem, optimizer, batch, amp, device,
               generator: torch.Generator | None = None):
    """One optimizer step of the seg net on a numpy NHWC batch (its
    train-mode draws, the Swin's drop paths or DeepLabV3's dropout, from
    ``generator``); returns the loss."""
    images = _nchw(torch.from_numpy(batch["image"]).float().to(device))
    masks = _nchw(torch.from_numpy(batch["mask"]).to(device))
    with amp():
        logits = seg.apply(images, train=True, generator=generator)
        loss = seg_loss_fn(logits, masks, seg.n_classes, seg.loss_type)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train(cfg: Config, train_iters: int | None = None, device=None):
    """Train on ``device`` (default ``cfg.run.device``, 'cuda') for
    ``train_iters`` steps (default ``engine.train_iters``). Returns (seg,
    results); ``results['log']`` has one record per validation: step, loss,
    val score, best, lr, and the steps since the last record with their
    wall seconds (training and validation, ending in a device sync; the
    checkpoint save is not counted)."""
    dev = resolve_device(device or cfg.run.device)
    seg = build_seg_problem(cfg, dev)
    amp = autocast_for(cfg, dev)
    optimizer = seg.make_opt()
    draw_gen = torch.Generator(device=dev).manual_seed(cfg.run.seed + 1)
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    bs, classes = cfg.data.batch_size, cfg.model.classes
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
        plateau = torch.optim.lr_scheduler.ReduceLROnPlateau(
            optimizer, mode="max", factor=cfg.optim.plateau_factor,
            patience=cfg.optim.plateau_patience)
        iters = train_iters or cfg.engine.train_iters
        best_val, step, epoch, records = 0.0, 0, 0, []
        last_step, t0 = 0, time.perf_counter()
        while step < iters:
            rng = np.random.default_rng((cfg.run.seed, epoch))
            for batch in batch_iterator(splits["train"], bs, rng):
                loss = train_step(seg, optimizer, batch, amp, dev, draw_gen)
                step += 1
                if step % cfg.engine.valid_step == 0:
                    val = evaluate_split(seg.net, splits["val"], bs, classes,
                                         amp=amp)
                    seconds = time.perf_counter() - t0
                    if val > best_val:
                        best_val = val
                        ckpt.save(step, {"unet": seg.net.state_dict(),
                                         "optimizer": optimizer.state_dict()},
                                  {"val_score": val}, force=True)
                    plateau.step(best_val)
                    rec = {"loss": float(loss), "val_score": val,
                           "best_val": best_val,
                           "lr": get_learning_rate(optimizer)}
                    log.log(rec, step)
                    records.append({"step": step, **rec,
                                    "steps": step - last_step,
                                    "seconds": seconds})
                    last_step, t0 = step, time.perf_counter()
                if step >= iters:
                    break
            epoch += 1

        results = {"best_val": best_val}
        if splits["test"] is not None:
            results["test_dice"] = evaluate_split(seg.net, splits["test"], bs,
                                                  classes, amp=amp)
        for name, data in splits["ood"]:
            results[f"ood_{name}"] = evaluate_split(seg.net, data, bs,
                                                    classes, amp=amp)
        log.log(results, step)
        log.info("final: %s", results)
        ckpt.wait()
    return seg, {**results, "log": records}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    train(parse_config(argv))


if __name__ == "__main__":
    main()
