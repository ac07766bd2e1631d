"""BBDM end-to-end bilevel training — the port of
``semantic_segmentation_tpu/train/train_end2end_bbdm.py``
(``BBDM/train_end2end.py:218-360``): a three-problem program (no
discriminator) on the port's ``BilevelEngine``:

- netG: the Brownian-bridge loss of the denoiser (``runner.loss_fn``,
  :221), Adam(1e-4, (0.9, 0.999));
- unet: BCE + Jaccard on the real pair, plus ``loss_lambda`` x the same on
  a fake pair: augment(mask) [warp kernel] -> threshold 0.1 ->
  [``--engine.fake_postprocess=photometric``: the ISIC chain on the mask,
  per-image coins, its equalize the equalize kernel] -> the 200-step
  sampler from that mask, detached (every cell assembled once for the
  run) -> global min-max -> segmenter, the target the thresholded mask.
  The reference's fake weight is 0.0 (:278), the ``end2end_bbdm`` preset's
  ``loss_lambda``: then no fake is made and neither kernel launches.
  RMSprop(unet_lr) with ``optim.accumulate``; the segmenter's BN
  statistics fold through the real forward, then the fake one;
- arch (outer): the U-Net's validation loss, over the denoiser's 21-cell
  table ``conv`` (Adam(arch_lr, 0.5, wd)); under the reference wiring the
  darts hypergradient is structurally zero and the preset runs
  ``decay_only``.

``train`` validates (Dice) every ``valid_step`` iterations, checkpoints the
engine on a better score, steps ReduceLROnPlateau(max) on the U-Net's
learning rate with the running best whenever ``it // 10`` crosses, and
writes the four-panel grid (image, mask, the denoiser's sample from the
thresholded mask, that mask) at each validation; the final U-Net's test
Dice at the end. The batch-index streams are the JAX loop's (netG seeded
``seed * 7``, unet ``seed * 7 + 1``, validation ``seed + 99``).

Usage: ``python -m semantic_segmentation_torch.train.train_end2end_bbdm
--preset=end2end_bbdm --data.dataroot=<JSRT dir> [--optim.loss_lambda=1.0]
[--data.synthetic=true] [--run.device=cpu]``.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import adam_torch
from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.engine.bilevel import (BilevelEngine,
                                                        InnerProblem)
from semantic_segmentation_torch.models.seg import SegProblem, seg_loss_fn
from semantic_segmentation_torch.ops import image as iops
from semantic_segmentation_torch.ops.augment import random_augment_batch
from semantic_segmentation_torch.ops.photometric import random_photometric
from semantic_segmentation_torch.train.common import (autocast_for,
                                                      fold_generator,
                                                      load_splits)
from semantic_segmentation_torch.train.train_bbdm import (
    BBDMModel, build_model, prefer_cudnn_heuristic_mode_b)
from semantic_segmentation_torch.train.train_end2end import index_streams
from semantic_segmentation_torch.train.train_unet import evaluate_split
from semantic_segmentation_torch.utils.visuals import save_image_grid

PROBLEMS = ("netG", "unet")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def build_problems(cfg: Config, bbdm: BBDMModel, seg: SegProblem, amp):
    """(problems, outer_loss) as engine closures. Each loss takes
    ``(batch, draws, params=None, generator=None)`` (``InnerProblem``);
    ``draws`` injects 'bridge' (netG: ``draw_losses``' t and noise),
    'affine' (B, 3, 3), 'photometric' (``draw_photometric``'s) and
    'sampler' (the per-step noises) for unet; ``params`` ({'netG' |
    'unet' | 'arch': tensors}) runs each net it names on those weights,
    the segmenter then on scratch BN buffers."""
    loss_lambda = cfg.optim.loss_lambda
    photometric = cfg.engine.fake_postprocess == "photometric"
    arch_tables = {"conv": bbdm.arch}

    def nets(params):
        if params is None:
            return None, None, arch_tables, True
        return (params.get("netG"), params.get("unet"),
                params.get("arch", arch_tables), False)

    def loss_netG(batch, draws, params=None, generator=None):
        g, _, arch, _ = nets(params)
        loss, _ = bbdm.loss_fn(batch, draws.get("bridge"), generator, g,
                               arch["conv"])
        return loss

    def loss_unet(batch, draws, params=None, generator=None):
        g, u, arch, keep = nets(params)
        images = _nchw(batch["image"].float())
        masks = batch["mask"].float()                       # NHWC
        with amp():
            logits = seg.apply(images, True, u, keep)
            loss = seg_loss_fn(logits, _nchw(masks), seg.n_classes,
                               "jaccard")
        if loss_lambda == 0.0:
            return loss
        # BBDM/train_end2end.py:240-257: augment -> threshold > 0.1; the
        # diffusion condition and the segmentation target are this mask
        fm = iops.threshold_mask(
            random_augment_batch(masks, generator, draws.get("affine")), 0.1)
        if photometric:
            fm = random_photometric((fm * 255.0).to(torch.uint8), generator,
                                    per_image=True,
                                    draws=draws.get("photometric")
                                    ).float() / 255.0
        weights = (None if g is None
                   else {k: v.detach() for k, v in g.items()})
        fake = bbdm.sample_loop(_nchw(fm * 2.0 - 1.0), weights,
                                arch["conv"].detach(), draws.get("sampler"),
                                generator)
        fake = iops.minmax_normalize(fake)
        with amp():
            fake_logits = seg.apply(fake, True, u, keep)
            fake_loss = seg_loss_fn(fake_logits, _nchw(fm), seg.n_classes,
                                    "jaccard")
        return loss + loss_lambda * fake_loss

    def outer_loss(params, val_batch):
        """The U-Net's validation loss, a train-mode forward on scratch BN
        buffers."""
        u = params.get("unet") if params is not None else None
        images = _nchw(val_batch["image"].float())
        with amp():
            logits = seg.apply(images, True, u, keep_stats=False)
            return seg_loss_fn(logits, _nchw(val_batch["mask"].float()),
                               seg.n_classes, "jaccard")

    problems = [
        InnerProblem("netG", loss_netG, bbdm.unet, bbdm.opt, bbdm.lr),
        InnerProblem("unet", loss_unet, seg.net, seg.make_opt(),
                     cfg.optim.unet_lr),
    ]
    return problems, outer_loss


def build_engine(cfg: Config, device, bbdm: BBDMModel | None = None):
    """The JAX ``build`` and ``init_state``: the denoiser and its arch table
    drawn on ``device`` from ``run.seed`` (no EMA), the U-Net from a CPU
    generator of ``run.seed`` moved there, the problems, the arch Adam and
    the engine. Returns (engine, bbdm, seg)."""
    device = torch.device(device)
    seed = cfg.run.seed
    bbdm = bbdm or build_model(cfg, device, accumulate=1, ema=False)
    m = cfg.model
    seg = SegProblem("unet", m.output_nc, m.classes, lr=cfg.optim.unet_lr,
                     loss_type="jaccard", device=device,
                     generator=torch.Generator().manual_seed(seed),
                     accumulate=cfg.optim.accumulate,
                     base_features=m.base_features)
    problems, outer_loss = build_problems(cfg, bbdm, seg,
                                          autocast_for(cfg, device))
    arch_opt = adam_torch([bbdm.arch], cfg.optim.arch_lr, 0.5,
                          weight_decay=cfg.optim.arch_weight_decay)
    e = cfg.engine
    engine = BilevelEngine(
        problems, {"conv": bbdm.arch}, arch_opt, outer_loss,
        unroll_steps=e.unroll_steps, roll_back=e.roll_back,
        hypergrad=e.hypergrad, darts_epsilon=e.darts_epsilon,
        arch_children=e.arch_children,
        generator=torch.Generator(device=device).manual_seed(seed + 5),
        hyper_generator=torch.Generator(device=device).manual_seed(seed + 6))
    return engine, bbdm, seg


def save_validation_panels(bbdm: BBDMModel, val_dev: dict, it: int,
                           save_dir: str, log, generator=None):
    """The reference's four wandb panels (BBDM/train_end2end.py:259-276):
    the first validation image, its mask, the denoiser's sample from the
    thresholded mask (min-max normalized) and that mask, as
    ``panels/it<it>.png`` and wandb images. Returns the panels."""
    masks = val_dev["mask"][:1].float()
    fm = iops.threshold_mask(masks, 0.1)
    fake = iops.minmax_normalize(bbdm.sample_loop(
        _nchw(fm * 2.0 - 1.0), generator=generator))
    panels = {"show_image": val_dev["image"][0].float().cpu().numpy(),
              "show_mask": masks[0].cpu().numpy(),
              "show_fake_image": _nhwc(fake)[0].cpu().numpy(),
              "show_fake_mask": fm[0].cpu().numpy()}
    save_image_grid(list(panels.values()),
                    os.path.join(save_dir, "panels", f"it{it}.png"), cols=4)
    log.log_images(panels, it)
    return panels


def train(cfg: Config, train_iters: int | None = None,
          bbdm: BBDMModel | None = None, device=None):
    """Train ``cfg`` on ``device`` (default ``cfg.run.device``, 'cuda').
    Returns (engine, results); ``results['chunks']`` has one record per
    validation interval (iterations, wall seconds ending in a device sync,
    losses, val Dice)."""
    dev = resolve_device(device or cfg.run.device)
    engine, bbdm, seg = build_engine(cfg, dev, bbdm)
    amp = autocast_for(cfg, dev)
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
        unet_opt = engine.problems[PROBLEMS.index("unet")].optimizer
        plateau = torch.optim.lr_scheduler.ReduceLROnPlateau(
            unet_opt, mode="max", patience=cfg.optim.plateau_patience)
        K = cfg.engine.unroll_steps
        train_dev = to_device_split(splits["train"], dev)
        val_dev = to_device_split(splits["val"], dev)
        streams, val_stream = index_streams(
            cfg, len(splits["train"]["image"]), len(splits["val"]["image"]),
            names=PROBLEMS)
        iters = train_iters or cfg.engine.train_iters
        best_val, it = 0.0, 0
        chunks = []
        while it < iters:
            t0 = time.perf_counter()
            S = min(cfg.engine.valid_step, iters - it)
            for _ in range(S):
                batch_stack = [{n: take_batch(train_dev, next(s))
                                for n, s in streams.items()}
                               for _ in range(K)]
                metrics = engine.engine_step(
                    batch_stack, take_batch(val_dev, next(val_stream)))
            it += S
            val = evaluate_split(seg.net, splits["val"], cfg.data.batch_size,
                                 seg.n_classes, "dice", amp)
            m_host = {k: float(v) for k, v in metrics.items()}
            chunks.append({"it": it, "iters": S,
                           "seconds": time.perf_counter() - t0,
                           "val_score": val, **m_host})
            if val > best_val:
                best_val = val
                ckpt.save(it, {"engine": engine.state_dict(),
                               "host": {"best_val": best_val, "it": it}},
                          {"val_score": val}, force=True)
            log.info("it %d: %s val %.4f best %.4f", it, m_host, val,
                     best_val)
            log.log({**m_host, "val_score": val, "best_val": best_val}, it)
            # ReduceLROnPlateau('max') on the unet lr, stepped with the
            # running best every 10 global steps (BBDM/train_end2end.py:192,
            # SSEngine.validation :308-309), at chunk boundaries
            if (it // 10) != ((it - S) // 10):
                plateau.step(best_val)
            save_validation_panels(bbdm, val_dev, it, save_dir, log,
                                   fold_generator(cfg.run.seed + 5,
                                                  2 ** 30 + it, dev))
        results = {"best_val": best_val}
        if splits["test"] is not None:
            results["test_dice"] = evaluate_split(
                seg.net, splits["test"], cfg.data.batch_size, seg.n_classes,
                "dice", amp)
        log.log(results, it)
        log.info("final: %s", results)
        return engine, {**results, "chunks": chunks}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    cfg.run.name = cfg.run.name or "end2end-bbdm"
    prefer_cudnn_heuristic_mode_b(cfg.run.device)
    train(cfg)


if __name__ == "__main__":
    main()
