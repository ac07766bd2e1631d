"""Soft-intro VAE end-to-end bilevel training — the port of
``semantic_segmentation_tpu/train/train_end2end_vae.py``
(``Soft-intro_VAE/train_end2end.py:120-392``) on the port's
``BilevelEngine``:

- netG, the decoder, and netD, the encoder: both minimize the conditional
  ELBO, beta_rec * rec + beta_kl * KL on the image in [0, 1] (not
  rescaled) with the mask repeated to 3 channels as the condition, each
  problem stepping its own net's Adam (optax's defaults); both problems
  run both nets in train mode, so each advances the encoder's BN
  statistics;
- unet: the Jaccard loss on the real pair plus ``loss_lambda`` x the same
  on a fake pair: augment(mask) [the warp kernel] -> threshold 0.1 ->
  decode(the mask, z ~ N(0, I)) in train mode -> global min-max, detached
  -> uint8 -> the ISIC ``fake_trans`` chain with batch-level coins [its
  equalize the equalize kernel] -> /255 (-> the channel mean at
  ``output_nc`` 1) -> segmenter, the target the thresholded mask;
  RMSprop(unet_lr);
- arch (outer): the U-Net's validation loss, over the encoder's (10, 3)
  table ``conv`` (Adam(arch_lr, 0.5, wd)). The outer loss touches the
  U-Net only and the fakes are detached, so the darts hypergradient is
  structurally zero and the preset runs ``decay_only``.

``train`` validates (Dice) every ``valid_step`` iterations, checkpoints the
engine on a better score, steps ReduceLROnPlateau(max) on the U-Net's
learning rate with the running best whenever ``it // len(train)`` crosses
(at chunk boundaries), writes the four-panel grid (image, mask, the
decoder's fake from the thresholded mask, that mask) at each chunk, and
scores the final U-Net's test Dice. The batch-index streams are the JAX
loop's (``seed * 7 + i`` per problem, validation ``seed + 99``).

Usage: ``python -m semantic_segmentation_torch.train.train_end2end_vae
--preset=end2end_sivae --data.dataroot=<ISIC dir> [--data.synthetic=true]
[--engine.hypergrad=darts] [--run.device=cpu]``.
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
from semantic_segmentation_torch.models.vae.sivae import (
    SoftIntroVAE, calc_kl, calc_reconstruction_loss, reparameterize)
from semantic_segmentation_torch.ops import image as iops
from semantic_segmentation_torch.ops.augment import random_augment_batch
from semantic_segmentation_torch.ops.layers import call_module
from semantic_segmentation_torch.ops.photometric import random_photometric
from semantic_segmentation_torch.train.common import (autocast_for,
                                                      fold_generator,
                                                      load_splits)
from semantic_segmentation_torch.train.train_end2end import index_streams
from semantic_segmentation_torch.train.train_unet import evaluate_split
from semantic_segmentation_torch.train.train_vae import (LATENT,
                                                         SIVAEParams)
from semantic_segmentation_torch.utils.visuals import save_image_grid

PROBLEMS = ("netG", "netD", "unet")


def _nchw3(x):
    """NHWC -> NCHW float32, one channel repeated to three."""
    x = x.float().permute(0, 3, 1, 2)
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def build_problems(cfg: Config, vae: SoftIntroVAE, seg: SegProblem, amp,
                   hp: SIVAEParams):
    """(problems, outer_loss) as engine closures. Each loss takes
    ``(batch, draws, params=None, generator=None)`` (``InnerProblem``):
    ``draws`` injects 'eps' (B, 8), the ELBO's reparameterization noise
    (netG, netD), and 'affine' (B, 3, 3), 'z' (B, 8) and 'photometric'
    (``draw_photometric``'s) for unet; ``params`` ({'netG' | 'netD' |
    'unet' | 'arch': tensors}) runs each net it names on those weights,
    every net then on scratch BN buffers."""
    loss_lambda = cfg.optim.loss_lambda
    gray = cfg.model.output_nc == 1
    arch_tables = {"conv": vae.arch}

    def nets(params):
        if params is None:
            return None, None, None, arch_tables, True
        return (params.get("netG"), params.get("netD"), params.get("unet"),
                params.get("arch", arch_tables), False)

    def encode(x, arch, e, keep):
        vae.encoder.train()
        return call_module(vae.encoder, (x, arch["conv"]), keep, e)

    def decode(a, z, g, keep):
        vae.decoder.train()
        return call_module(vae.decoder, (a, z), keep, g)

    def elbo(batch, draws, params, generator):
        """The shared ELBO of the netG and netD problems (:64-78)."""
        g, e, _, arch, keep = nets(params)
        a, b = _nchw3(batch["mask"]), _nchw3(batch["image"])
        with amp():
            mu, logvar = encode(b, arch, e, keep)
            eps = draws.get("eps")
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device)
            rec = decode(a, reparameterize(mu, logvar, eps), g, keep)
        return hp.beta_rec * calc_reconstruction_loss(
            b, rec, hp.recon_loss_type, "mean") + \
            hp.beta_kl * calc_kl(logvar, mu, "mean")

    def loss_unet(batch, draws, params=None, generator=None):
        g, _, u, _, keep = nets(params)
        images = _nchw(batch["image"].float())
        masks = batch["mask"].float()                       # NHWC
        with amp():
            logits = seg.apply(images, True, u, keep)
            loss = seg_loss_fn(logits, _nchw(masks), seg.n_classes,
                               "jaccard")
        # fakes: decode(aug mask, z ~ N) (sample_with_noise,
        # models.py:230-232)
        fm = iops.threshold_mask(
            random_augment_batch(masks, generator, draws.get("affine")), 0.1)
        z = draws.get("z")
        if z is None:
            z = torch.randn(fm.shape[0], vae.latent_dim, generator=generator,
                            device=fm.device)
        with torch.no_grad(), amp():
            fake = decode(_nchw3(fm), z, g, keep)
        # the fake_trans chain on the batched uint8 fake
        # (Soft-intro_VAE/train_end2end.py:182-188, applied :278): one call
        # on the whole batch, batch-level coins
        u8 = iops.to_uint8(iops.minmax_normalize(_nhwc(fake)))
        fake = random_photometric(u8, generator,
                                  draws=draws.get("photometric")
                                  ).float() / 255.0
        if gray:
            fake = fake.mean(dim=-1, keepdim=True)
        with amp():
            fake_logits = seg.apply(_nchw(fake), True, u, keep)
            fake_loss = seg_loss_fn(fake_logits, _nchw(fm), seg.n_classes,
                                    "jaccard")
        return loss + loss_lambda * fake_loss

    def outer_loss(params, val_batch):
        """The U-Net's validation loss, a train-mode forward on scratch BN
        buffers."""
        u = params.get("unet") if params is not None else None
        with amp():
            logits = seg.apply(_nchw(val_batch["image"].float()), True, u,
                               keep_stats=False)
            return seg_loss_fn(logits, _nchw(val_batch["mask"].float()),
                               seg.n_classes, "jaccard")

    problems = [
        InnerProblem("netG", elbo, vae.decoder,
                     adam_torch(vae.decoder.parameters(), hp.lr_d, 0.9),
                     hp.lr_d),
        InnerProblem("netD", elbo, vae.encoder,
                     adam_torch(vae.encoder.parameters(), hp.lr_e, 0.9),
                     hp.lr_e),
        InnerProblem("unet", loss_unet, seg.net, seg.make_opt(),
                     cfg.optim.unet_lr),
    ]
    return problems, outer_loss


def build_engine(cfg: Config, device, hp: SIVAEParams | None = None):
    """The JAX ``build`` and the start state: the VAE (latent 8, RGB,
    ``model.ngf``, the decoder's depth paired to ``data.image_size``) and
    then the U-Net drawn from one CPU generator of ``run.seed`` and moved
    to ``device``, the problems, the arch Adam and the engine. Returns
    (engine, vae, seg)."""
    device = torch.device(device)
    hp = hp or SIVAEParams()
    seed = cfg.run.seed
    init_gen = torch.Generator().manual_seed(seed)
    m = cfg.model
    vae = SoftIntroVAE(LATENT, 3, m.ngf, f"unet_{cfg.data.image_size}",
                       device=device, generator=init_gen)
    seg = SegProblem("unet", m.output_nc, m.classes, lr=cfg.optim.unet_lr,
                     loss_type="jaccard", device=device, generator=init_gen,
                     accumulate=cfg.optim.accumulate,
                     base_features=m.base_features)
    problems, outer_loss = build_problems(cfg, vae, seg,
                                          autocast_for(cfg, device), hp)
    arch_opt = adam_torch([vae.arch], cfg.optim.arch_lr, 0.5,
                          weight_decay=cfg.optim.arch_weight_decay)
    e = cfg.engine
    engine = BilevelEngine(
        problems, {"conv": vae.arch}, arch_opt, outer_loss,
        unroll_steps=e.unroll_steps, roll_back=e.roll_back,
        hypergrad=e.hypergrad, darts_epsilon=e.darts_epsilon,
        arch_children=e.arch_children,
        generator=torch.Generator(device=device).manual_seed(seed + 5),
        hyper_generator=torch.Generator(device=device).manual_seed(seed + 6))
    return engine, vae, seg


@torch.no_grad()
def save_panels(vae: SoftIntroVAE, val_dev: dict, it: int, save_dir: str,
                log, generator=None) -> dict:
    """The reference's four panels (Soft-intro_VAE/train_end2end.py:
    286-303): the first validation image, its mask, the decoder's fake
    (eval mode, z ~ N(0, I)) from the thresholded mask, min-max
    normalized, and that mask, as ``panels/it<it>.png`` and wandb
    images."""
    masks = val_dev["mask"][:1].float()
    fm = iops.threshold_mask(masks, 0.1)
    z = torch.randn(1, vae.latent_dim, generator=generator,
                    device=masks.device)
    vae.decoder.eval()
    fake = iops.minmax_normalize(vae.decoder(_nchw3(fm), z))
    panels = {"show_image": val_dev["image"][0].float().cpu().numpy(),
              "show_mask": masks[0].cpu().numpy(),
              "show_fake_image": _nhwc(fake)[0].cpu().numpy(),
              "show_fake_mask": fm[0].cpu().numpy()}
    save_image_grid(list(panels.values()),
                    os.path.join(save_dir, "panels", f"it{it}.png"), cols=4)
    log.log_images(panels, it)
    return panels


def train(cfg: Config, train_iters: int | None = None, device=None,
          hp: SIVAEParams | None = None):
    """Train ``cfg`` on ``device`` (default ``cfg.run.device``, 'cuda').
    Returns (engine, results); ``results['chunks']`` has one record per
    validation interval (iterations, wall seconds ending in a device sync,
    losses, val Dice)."""
    dev = resolve_device(device or cfg.run.device)
    engine, vae, seg = build_engine(cfg, dev, hp)
    amp = autocast_for(cfg, dev)
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
        plateau = torch.optim.lr_scheduler.ReduceLROnPlateau(
            engine.problems[PROBLEMS.index("unet")].optimizer, mode="max",
            patience=cfg.optim.plateau_patience)
        K = cfg.engine.unroll_steps
        n_train = len(splits["train"]["image"])
        train_dev = to_device_split(splits["train"], dev)
        val_dev = to_device_split(splits["val"], dev)
        streams, val_stream = index_streams(
            cfg, n_train, len(splits["val"]["image"]), names=PROBLEMS)
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
            m_host = {k: float(v) for k, v in metrics.items()}
            seconds = time.perf_counter() - t0       # float() synced
            it += S
            val = evaluate_split(seg.net, splits["val"], cfg.data.batch_size,
                                 seg.n_classes, "dice", amp)
            chunks.append({"it": it, "iters": S, "seconds": seconds,
                           "val_score": val, **m_host})
            if val > best_val:
                best_val = val
                ckpt.save(it, {"engine": engine.state_dict(),
                               "host": {"best_val": best_val, "it": it}},
                          {"val_score": val}, force=True)
            log.info("it %d: %s val %.4f best %.4f", it, m_host, val,
                     best_val)
            log.log({**m_host, "val_score": val, "best_val": best_val}, it)
            # ReduceLROnPlateau('max', patience=5) on the unet lr, stepped
            # with the running best every len(train_set) global steps
            # (Soft-intro_VAE/train_end2end.py:141, :332-333), at chunk
            # boundaries
            if (it // max(n_train, 1)) != ((it - S) // max(n_train, 1)):
                plateau.step(best_val)
            save_panels(vae, val_dev, it, save_dir, log,
                        fold_generator(cfg.run.seed + 5, 2 ** 30 + it, dev))
        results = {"best_val": best_val}
        if splits["test"] is not None:
            results["test_dice"] = evaluate_split(
                seg.net, splits["test"], cfg.data.batch_size, seg.n_classes,
                "dice", amp)
        log.log(results, it)
        log.info("final: %s", results)
        ckpt.wait()
        return engine, {**results, "chunks": chunks}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    cfg.run.name = cfg.run.name or "end2end-sivae"
    train(cfg)


if __name__ == "__main__":
    main()
