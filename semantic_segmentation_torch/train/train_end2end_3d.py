"""GenSeg-3D end-to-end bilevel training — the port of
``semantic_segmentation_tpu/train/train_end2end_3d.py``
(``GenSeg-3D/train_end2end.py:40-295``): the GenSeg program on paired
volumes with the 3D nets.

- netG (:141-161): GAN(D(A, G(A)), True) + the 3D generator objective,
  masked L1 (sum) over |mask| x lambda_L1 plus the tumour-area MSE (sum)
  over |truth| x gamma, each behind ``zero_division``.
- netD (:163-178): 0.5 * (fake + real) GAN loss, G in train mode under
  ``no_grad`` (its statistics still fold), D's statistics threaded fake ->
  real.
- unet (:180-204): ``seg3d_loss`` (weighted cross entropy with
  ``BCE_WEIGHTS`` + the constant argmax-Dice loss) on the real volume B,
  plus the same on G(A), the fake mask being A itself. The segmenter is
  ``UNet3D``.
- arch (outer): the U-Net's validation loss, read by ``darts`` and
  ``unroll``. The arch table ``conv`` (num_downs, 3) drives G's searchable
  down-convs; under the reference wiring (outer loss on the U-Net, fakes
  detached, child netG) the darts hypergradient is structurally zero, and
  the ``end2end_3d`` preset runs ``decay_only``.

Optimizers (:112-115, :240-245, :274): Adam(lr, beta1) for G and D,
RMSprop(unet_lr) for the U-Net (``optim.accumulate`` micro-steps), the
arch Adam(arch_lr, 0.5, wd); ReduceLROnPlateau on the U-Net's learning
rate at the validation boundaries that cross an epoch. The program starts
from scratch (no stage-1 checkpoint), as the JAX package's does.

Validation argmax Dice every ``valid_step`` iterations; the best U-Net
(``unet_best.pt``), the metric stream, the engine checkpoint
(``run.save_every``, ``run.final_checkpoint``) and resume; the final
U-Net's test Dice. NCDHW inside, the JAX package's NDHWC ``(N, D, H, W,
1)`` arrays outside.

Usage: ``python -m semantic_segmentation_torch.train.train_end2end_3d
--preset=end2end_3d --data.dataroot=<dir with imgsA/ imgsB/ truths/>
[--data.synthetic=true] [--run.device=cpu]``.
"""

from __future__ import annotations

import logging
import os
import time
from functools import cached_property

import torch

from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import (Accumulate, adam_torch,
                                                    rmsprop_torch)
from semantic_segmentation_torch.core.profiling import StepTimer, trace
from semantic_segmentation_torch.data.pipeline import (eval_batches,
                                                       stack_dataset,
                                                       subset_split,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.data.volume import (NiftiPairedDataset,
                                                     SyntheticVolumeDataset)
from semantic_segmentation_torch.engine.bilevel import (BilevelEngine,
                                                        InnerProblem)
from semantic_segmentation_torch.models.pix2pix.networks3d import (
    NLayerDiscriminator3D, UnetGenerator3D)
from semantic_segmentation_torch.models.unet3d import UNet3D
from semantic_segmentation_torch.ops import losses
from semantic_segmentation_torch.ops.layers import (call_module,
                                                    pix2pix_normal_, reinit_)
from semantic_segmentation_torch.ops.nas import NUM_OPS
from semantic_segmentation_torch.train.common import autocast_for
from semantic_segmentation_torch.train.train_end2end import index_streams

BCE_WEIGHTS = (0.004, 0.996)  # GenSeg-3D/UNet3D/config.py:35


def ncdhw(x):
    """(N, D, H, W, C) -> (N, C, D, H, W); a view at C = 1."""
    return x.permute(0, 4, 1, 2, 3)


def seg3d_loss(logits, target):
    """The criterion plus the (constant) argmax Dice loss
    (``train_end2end.py:189-190``). ``logits`` (N, 2, D, H, W), ``target``
    (N, D, H, W)."""
    return losses.softmax_cross_entropy_weighted(logits, target,
                                                 BCE_WEIGHTS) \
        + losses.argmax_dice_loss(logits, target)


class GenSeg3D:
    """G, D, the U-Net and the arch table on one device, with their
    optimizers, the apply helpers and the problem closures. Weights are
    drawn from ``generator`` (a CPU generator: G, D, the U-Net, the arch
    table, then the ``init_type`` re-draw of G and D) and moved to
    ``device``."""

    def __init__(self, cfg: Config, num_downs: int = 6,
                 upsampling: str = "linear", gamma_tmse: float = 0.0,
                 device="cpu", generator: torch.Generator | None = None):
        m = cfg.model
        self.cfg, self.num_downs, self.gamma_tmse = cfg, num_downs, gamma_tmse
        self.device = torch.device(device)
        self.amp = autocast_for(cfg, self.device)
        self.G = UnetGenerator3D(1, m.output_nc, num_downs, m.ngf,
                                 upsampling, not m.no_dropout, m.norm)
        self.D = NLayerDiscriminator3D(1 + m.output_nc, m.ndf, 3, m.norm)
        for net in (self.G, self.D):    # BN scale 1, as the JAX 3D nets
            pix2pix_normal_(net, 0.02, generator, draw_bn_scale=False)
        b = m.base_features
        self.seg = UNet3D(1, 2, (b, 2 * b, 4 * b), 8 * b, generator)
        self.arch = {"conv": 1e-3 * torch.randn(num_downs, NUM_OPS,
                                                generator=generator)}
        if m.init_type != "normal" or m.init_gain != 0.02:
            # init_net's laws on G and D (GenSeg-3D/models/networks.py
            # init_net); a non-default gain re-draws even under 'normal'
            reinit_(self.G, m.init_type, m.init_gain, generator)
            reinit_(self.D, m.init_type, m.init_gain, generator)
        for net in (self.G, self.D, self.seg):
            net.to(self.device)
        self.arch = {k: v.to(self.device) for k, v in self.arch.items()}

    # Optimizers are made at first use, after any checkpoint is loaded.
    @cached_property
    def opt_g(self):
        return adam_torch(self.G.parameters(), self.cfg.optim.lr,
                          self.cfg.optim.beta1)

    @cached_property
    def opt_d(self):
        return adam_torch(self.D.parameters(), self.cfg.optim.lr,
                          self.cfg.optim.beta1)

    @cached_property
    def opt_u(self):
        opt = rmsprop_torch(self.seg.parameters(), self.cfg.optim.unet_lr)
        k = self.cfg.optim.accumulate
        return Accumulate(opt, k) if k > 1 else opt

    # -- applies --------------------------------------------------------
    def g_apply(self, a, arch_conv, train: bool, dropout_masks=None,
                generator: torch.Generator | None = None,
                keep_stats: bool = True, params=None):
        """G on an NCDHW volume (its statistics on scratch buffers with
        ``keep_stats`` False or ``params`` given, which replaces G's
        parameters)."""
        self.G.train(train)
        return call_module(self.G, (a, arch_conv, dropout_masks, generator),
                           keep_stats, params)

    def d_apply(self, pair, train: bool, keep_stats: bool = True,
                params=None):
        self.D.train(train)
        return call_module(self.D, (pair,), keep_stats, params)

    def seg_apply(self, vol, train: bool, keep_stats: bool = True,
                  params=None):
        self.seg.train(train)
        return call_module(self.seg, (vol,), keep_stats, params)

    @torch.no_grad()
    def seg_eval_logits(self, vol):
        with self.amp():
            return self.seg_apply(vol, False)

    # -- problems -------------------------------------------------------
    def g_losses(self, fake, batch):
        """Masked L1 (sum) / |mask| x lambda_L1 + tumour MSE (sum) / |truth|
        x gamma (``models/pix2pix_model.py:84-100``)."""
        lam, gamma = self.cfg.optim.lambda_L1, self.gamma_tmse
        mask = ncdhw(batch["mask"].float())
        truth = ncdhw(batch["truth"].float())
        real_b = ncdhw(batch["B"].float())
        l1 = losses.zero_division(
            losses.l1_loss_sum(fake * mask, real_b * mask) * lam, mask.sum())
        tmse = losses.zero_division(
            losses.mse_loss_sum(fake * truth, real_b * truth) * gamma,
            truth.sum())
        return l1 + tmse

    def build_problems(self):
        """(problems, outer_loss) as engine closures; each loss takes
        ``(batch, draws, params=None, generator=None)`` (``InnerProblem``),
        ``draws`` injecting G's dropout keep-masks under 'dropout'. The
        outer loss draws nothing: the U-Net has no random layers."""
        gan_mode, amp = self.cfg.optim.gan_mode, self.amp

        def nets(params):
            if params is None:
                return None, None, None, self.arch, True
            return (params.get("netG"), params.get("netD"),
                    params.get("unet"), params.get("arch", self.arch), False)

        def loss_netG(batch, draws, params=None, generator=None):
            g, d, _, arch, keep = nets(params)
            a = ncdhw(batch["A"].float())
            with amp():
                fake = self.g_apply(a, arch["conv"], True,
                                    draws.get("dropout"), generator, keep, g)
                pred_fake = self.d_apply(torch.cat([a, fake], 1), True, keep,
                                         d)
            return losses.gan_loss(pred_fake, True, gan_mode) + \
                self.g_losses(fake, batch)

        def loss_netD(batch, draws, params=None, generator=None):
            g, d, _, arch, keep = nets(params)
            a = ncdhw(batch["A"].float())
            real_b = ncdhw(batch["B"].float())
            with amp():
                with torch.no_grad():
                    fake = self.g_apply(a, arch["conv"], True,
                                        draws.get("dropout"), generator,
                                        keep, g)
                pred_fake = self.d_apply(torch.cat([a, fake], 1), True, keep,
                                         d)
                pred_real = self.d_apply(torch.cat([a, real_b], 1), True,
                                         keep, d)
            return 0.5 * (losses.gan_loss(pred_fake, False, gan_mode)
                          + losses.gan_loss(pred_real, True, gan_mode))

        def loss_unet(batch, draws, params=None, generator=None):
            g, _, u, arch, keep = nets(params)
            images = ncdhw(batch["B"].float())
            true_masks = batch["mask"][..., 0].float()
            with amp():
                logits = self.seg_apply(images, True, keep, u)
                loss = seg3d_loss(logits, true_masks)
                # the fake branch (train_end2end.py:193-204): the fake mask
                # is A itself
                with torch.no_grad():
                    fake_image = self.g_apply(
                        ncdhw(batch["A"].float()), arch["conv"], True,
                        draws.get("dropout"), generator, keep, g)
                fake_logits = self.seg_apply(fake_image, True, keep, u)
                return loss + seg3d_loss(fake_logits, true_masks)

        def outer_loss(params, val_batch):
            """The U-Net's validation loss, a train-mode forward on scratch
            BN buffers."""
            u = params.get("unet") if params is not None else None
            images = ncdhw(val_batch["B"].float())
            with amp():
                logits = self.seg_apply(images, True, False, u)
                return seg3d_loss(logits, val_batch["mask"][..., 0].float())

        lr, unet_lr = self.cfg.optim.lr, self.cfg.optim.unet_lr
        return [
            InnerProblem("netG", loss_netG, self.G, self.opt_g, lr),
            InnerProblem("netD", loss_netD, self.D, self.opt_d, lr),
            InnerProblem("unet", loss_unet, self.seg, self.opt_u, unet_lr),
        ], outer_loss


def build_engine(cfg: Config, device, num_downs: int = 6,
                 upsampling: str = "linear", seed: int | None = None):
    """The model (weights from a CPU generator seeded with ``seed``, then
    moved to ``device``), its problems and the engine. Returns (engine,
    model)."""
    device = torch.device(device)
    seed = cfg.run.seed if seed is None else seed
    model = GenSeg3D(cfg, num_downs, upsampling, device=device,
                     generator=torch.Generator().manual_seed(seed))
    problems, outer_loss = model.build_problems()
    arch_opt = adam_torch(list(model.arch.values()), cfg.optim.arch_lr, 0.5,
                          weight_decay=cfg.optim.arch_weight_decay)
    e = cfg.engine
    engine = BilevelEngine(
        problems, model.arch, arch_opt, outer_loss,
        unroll_steps=e.unroll_steps, roll_back=e.roll_back,
        hypergrad=e.hypergrad, darts_epsilon=e.darts_epsilon,
        arch_children=e.arch_children,
        generator=torch.Generator(device=device).manual_seed(seed + 5),
        hyper_generator=torch.Generator(device=device).manual_seed(seed + 6))
    return engine, model


@torch.no_grad()
def evaluate_seg3d(model: GenSeg3D, data, batch_size: int) -> float:
    """GenSeg-3D's evaluate (``train_end2end.py:59-86``): the mean over
    batches of the argmax Dice of the U-Net in eval mode on (B, mask).
    ``data``: a stacked split, numpy or on the device."""
    total, count = 0.0, 0
    for b in eval_batches(data, batch_size):
        b = {k: torch.as_tensor(v, device=model.device)
             for k, v in b.items() if k in ("B", "mask")}
        logits = model.seg_eval_logits(ncdhw(b["B"].float()))
        total += float(losses.argmax_dice_score(logits,
                                                b["mask"][..., 0].float()))
        count += 1
    return total / max(count, 1)


def load_volume_splits(cfg: Config, crop: int):
    """Stacked NDHWC numpy splits train/val/test of the NIfTI folder
    ``data.dataroot`` (or the synthetic volumes), first n_train, next n_val,
    last n_test."""
    d = cfg.data
    if d.synthetic:
        ds = SyntheticVolumeDataset(n=d.n_train + d.n_val + d.n_test,
                                    size=crop, seed=cfg.run.seed)
    else:
        ds = NiftiPairedDataset(d.dataroot, crop_size=crop,
                                seed=cfg.run.seed)
    tr, va, te = subset_split(len(ds), d.n_train, d.n_val, d.n_test)
    return {"train": stack_dataset(ds, tr), "val": stack_dataset(ds, va),
            "test": stack_dataset(ds, te) if te else None}


def train(cfg: Config, train_iters: int | None = None, crop: int = 64,
          upsampling: str = "linear", num_downs: int = 6, device=None):
    """Train ``cfg`` on ``device`` (default ``cfg.run.device``, 'cuda').
    Returns (engine, results); ``results['chunks']`` has one record per
    validation interval this call ran (iterations, wall seconds ending in a
    device sync, losses, val score).

    Run artifacts under ``<save_dir>/<name>``: ``metrics.jsonl``,
    ``ckpt/<it>`` (the engine state with the host trajectory: every
    ``run.save_every`` iterations and, with ``run.final_checkpoint``, at
    the end) and ``unet_best.pt``, the U-Net of the best validation Dice.
    With ``run.resume`` the run continues from the latest checkpoint exactly
    as if it had not stopped."""
    dev = resolve_device(device or cfg.run.device)
    engine, model = build_engine(cfg, dev, num_downs, upsampling)
    splits = load_volume_splits(cfg, crop)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
        plateau = torch.optim.lr_scheduler.ReduceLROnPlateau(
            model.opt_u, mode="max", factor=cfg.optim.plateau_factor,
            patience=cfg.optim.plateau_patience)
        K = cfg.engine.unroll_steps
        n_train = len(splits["train"]["A"])
        train_dev = to_device_split(splits["train"], dev)
        val_dev = to_device_split(splits["val"], dev)

        def snapshot_unet():
            return {k: v.detach().clone()
                    for k, v in model.seg.state_dict().items()}

        iters = train_iters or cfg.engine.train_iters
        best_val, it = 0.0, 0
        best_unet = snapshot_unet()

        def save_ckpt():
            ckpt.save(it, {"engine": engine.state_dict(),
                           "host": {"best_val": best_val, "it": it,
                                    "best_unet": best_unet,
                                    "plateau": plateau.state_dict()}},
                      {"val_score": best_val}, force=True)

        if cfg.run.resume:
            restored, _ = ckpt.restore({"engine": None, "host": None})
            if restored is not None:
                engine.load_state_dict(restored["engine"])
                h = restored["host"]
                best_val, it = float(h["best_val"]), int(h["it"])
                best_unet = {k: v.to(dev) for k, v in h["best_unet"].items()}
                plateau.load_state_dict(h["plateau"])
                log.info("resumed 3D trainer at step %d", it)
        streams, val_stream = index_streams(cfg, n_train,
                                            len(splits["val"]["A"]), it)

        chunks = []
        timer = StepTimer(skip=1)
        timer.tick()
        with trace(cfg.run.profile_dir):
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
                val = evaluate_seg3d(model, val_dev, cfg.data.batch_size)
                m_host = {k: float(v) for k, v in metrics.items()}
                chunks.append({"it": it, "iters": S,
                               "seconds": time.perf_counter() - t0,
                               "val_score": val, **m_host})
                if val > best_val:
                    best_val = val
                    best_unet = snapshot_unet()
                log.info("it %d: %s val %.4f best %.4f", it, m_host, val,
                         best_val)
                log.log({**m_host, "val_score": val, "best_val": best_val},
                        it)
                if (it // max(n_train, 1)) != ((it - S) // max(n_train, 1)):
                    plateau.step(best_val)
                if cfg.run.save_every and it % cfg.run.save_every == 0:
                    save_ckpt()
                timer.tick()
                log.log({"iters_per_sec": timer.steps_per_sec * S}, it)

        if cfg.run.final_checkpoint:
            save_ckpt()
        results = {"best_val": best_val}
        if splits["test"] is not None:
            results["test_dice"] = evaluate_seg3d(model, splits["test"],
                                                  cfg.data.batch_size)
        torch.save(best_unet, os.path.join(save_dir, "unet_best.pt"))
        log.log(results, it)
        log.info("final: %s", results)
        ckpt.wait()
        return engine, {**results, "chunks": chunks}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    cfg.run.name = cfg.run.name or "end2end-3d"
    train(cfg)


if __name__ == "__main__":
    main()
