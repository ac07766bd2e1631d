"""Pix2Pix training — the port of
``semantic_segmentation_tpu/models/pix2pix/model.py``: the G/D modules, the
NAS arch tables, the problem losses, the fused D-then-G ``train_step``
(``pix2pix_model.py:102-143``), the arch step (``:145-166``) and
``generate``, with the Adam(beta1) optimizers of ``pix2pix_model.py:75-82``.

State is the modules' own: parameters, and BN running stats as buffers that
a train-mode forward updates in place. The JAX package threads the stats
explicitly and keeps only some of them; where it drops a forward's stats the
port runs that forward on scratch copies of the buffers (``keep_stats``
False), so the modules' buffers follow the JAX package step for step.

``train_step``, ``architect_step`` and ``generate`` take NHWC batches, as
the JAX package's do; ``g_apply``/``d_apply``/``loss_G``/``loss_D`` work on
NCHW tensors.
"""

from __future__ import annotations

import contextlib
from functools import cached_property

import torch

from semantic_segmentation_torch.core.optim import adam_torch
from semantic_segmentation_torch.models.pix2pix.networks import (define_D,
                                                                 define_G)
from semantic_segmentation_torch.ops import nas
from semantic_segmentation_torch.ops.layers import call_module, reinit_
from semantic_segmentation_torch.ops.losses import gan_loss, l1_loss


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Pix2Pix:
    """G, D and the arch tables on one device. ``amp`` makes the context
    each G/D forward runs in (``torch.autocast`` for bf16; losses are taken
    in float32 outside it)."""

    def __init__(self, input_nc=1, output_nc=1, ngf=64, ndf=64,
                 netG="unet_256", netD="basic", n_layers_D=3,
                 use_dropout=True,
                 gan_mode="vanilla", lambda_L1=100.0, lr=2e-4, beta1=0.5,
                 arch_lr=1e-4, amp=None,
                 device="cpu", generator: torch.Generator | None = None,
                 norm="batch", init_type="normal", init_gain=0.02):
        self.lr, self.beta1 = lr, beta1
        self.arch_lr = arch_lr
        self.gan_mode, self.lambda_L1 = gan_mode, lambda_L1
        self.amp = amp or contextlib.nullcontext
        # weights are drawn on the CPU generator, then moved
        self.G = define_G(input_nc, output_nc, netG, ngf, use_dropout,
                          generator, norm)
        self.D = define_D(input_nc + output_nc, netD, ndf, n_layers_D,
                          generator, norm)
        self.arch = {k: v.to(device) for k, v in
                     nas.init_arch_params(generator).items()}
        if init_type != "normal" or init_gain != 0.02:
            # init_net's non-default laws (networks.py:84-98), a re-draw
            # after construction as torch's net.apply(init_func) does; a
            # non-default gain re-draws even under 'normal' (JAX
            # models/pix2pix/model.py:72-85)
            reinit_(self.G, init_type, init_gain, generator)
            reinit_(self.D, init_type, init_gain, generator)
        self.G.to(device)
        self.D.to(device)

    # Optimizers are made at first use, after any checkpoint is loaded.
    @cached_property
    def opt_g(self):
        return adam_torch(self.G.parameters(), self.lr, self.beta1)

    @cached_property
    def opt_d(self):
        return adam_torch(self.D.parameters(), self.lr, self.beta1)

    @cached_property
    def opt_arch(self):
        """pix2pix_model.py:79-80: one Adam over both arch tables, weight
        decay 1e-3."""
        return adam_torch(list(self.arch.values()), self.arch_lr, 0.5,
                          weight_decay=1e-3)

    # -- forward helpers ------------------------------------------------
    def g_apply(self, mask, arch_upconv, train: bool, dropout_masks=None,
                generator: torch.Generator | None = None,
                keep_stats: bool = True, params=None):
        """G on an NCHW mask; train mode updates G's BN stats (scratch
        copies of them with ``keep_stats`` False or ``params`` given, which
        replaces G's parameters)."""
        self.G.train(train)
        return call_module(self.G,
                           (mask, arch_upconv, dropout_masks, generator),
                           keep_stats, params)

    def d_apply(self, pair, train: bool, keep_stats: bool = True,
                params=None):
        """D on an NCHW (mask, image) pair; train mode updates D's BN stats
        (scratch copies of them with ``keep_stats`` False or ``params``
        given, which replaces D's parameters)."""
        self.D.train(train)
        return call_module(self.D, (pair,), keep_stats, params)

    # -- problem losses (shared with the end-to-end engine) -------------
    def loss_G(self, mask, image, dropout_masks=None,
               generator: torch.Generator | None = None,
               keep_g_stats: bool = True):
        """GAN(D(mask, G(mask)), real) + lambda_L1 * L1(G(mask), image)
        (``pix2pix_model.py:120-130``), G and D in train mode. Returns
        (loss, fake)."""
        with self.amp():
            fake = self.g_apply(mask, self.arch["upconv"], True,
                                dropout_masks, generator, keep_g_stats)
            pred_fake = self.d_apply(torch.cat([mask, fake], 1), True)
        loss = gan_loss(pred_fake, True, self.gan_mode) + \
            self.lambda_L1 * l1_loss(fake, image)
        return loss, fake

    def loss_D(self, mask, image, fake):
        """0.5 * (GAN(D(mask, fake), fake) + GAN(D(mask, image), real)), the
        fake detached, D's stats threaded fake -> real. Returns (loss,
        loss_fake, loss_real)."""
        with self.amp():
            pred_fake = self.d_apply(torch.cat([mask, fake.detach()], 1),
                                     True)
            pred_real = self.d_apply(torch.cat([mask, image], 1), True)
        loss_fake = gan_loss(pred_fake, False, self.gan_mode)
        loss_real = gan_loss(pred_real, True, self.gan_mode)
        return 0.5 * (loss_fake + loss_real), loss_fake, loss_real

    # -- optimize_parameters (pix2pix_model.py:132-143) -----------------
    def train_step(self, batch, dropout_masks=None,
                   generator: torch.Generator | None = None):
        """One D step on a detached fake, then one G step against the
        updated D. ``batch``: NHWC ``mask_pix2pix``/``image_pix2pix``.
        ``dropout_masks``: (masks of the fake forward, masks of the G-step
        forward), each {depth: keep-mask} or None to draw from
        ``generator``. Returns the losses as 0-d tensors (no sync).

        G runs forward twice, as in the JAX package: the fake forward's BN
        stats are kept; the G step's forward runs on scratch stats, since
        the JAX step keeps only the D stats of that call. D's stats thread
        fake -> real in the D step and fake again in the G step."""
        mask = _nchw(batch["mask_pix2pix"].float())
        image = _nchw(batch["image_pix2pix"].float())
        masks_fake, masks_g = dropout_masks or (None, None)

        with torch.no_grad(), self.amp():
            fake = self.g_apply(mask, self.arch["upconv"], True, masks_fake,
                                generator)

        loss_d, loss_d_fake, loss_d_real = self.loss_D(mask, image, fake)
        self.opt_d.zero_grad(set_to_none=True)
        loss_d.backward(inputs=list(self.D.parameters()))
        self.opt_d.step()

        loss_g, _ = self.loss_G(mask, image, masks_g, generator,
                                keep_g_stats=False)
        self.opt_g.zero_grad(set_to_none=True)
        loss_g.backward(inputs=list(self.G.parameters()))
        self.opt_g.step()
        return {"loss_G": loss_g.detach(), "loss_D": loss_d.detach(),
                "loss_D_fake": loss_d_fake.detach(),
                "loss_D_real": loss_d_real.detach()}

    # -- optimize_architect (pix2pix_model.py:145-166) ------------------
    def architect_step(self, batch, dropout_masks=None,
                       generator: torch.Generator | None = None):
        """One Adam step of the arch tables on the G objective, G and D in
        train mode on scratch BN stats (no buffer changes). The 'conv'
        table, which G does not read, gets a zero gradient, so it moves by
        weight decay as in the JAX package."""
        mask = _nchw(batch["mask_pix2pix"].float())
        image = _nchw(batch["image_pix2pix"].float())
        up = self.arch["upconv"].detach().requires_grad_(True)
        with torch.enable_grad():
            with self.amp():
                fake = self.g_apply(mask, up, True, dropout_masks, generator,
                                    keep_stats=False)
                pred_fake = self.d_apply(torch.cat([mask, fake], 1), True,
                                         keep_stats=False)
            loss = gan_loss(pred_fake, True, self.gan_mode) + \
                self.lambda_L1 * l1_loss(fake, image)
            # a ResNet generator does not read the tables: zero gradient
            (grad,) = torch.autograd.grad(loss, up, allow_unused=True)
        if grad is None:
            grad = torch.zeros_like(up)
        for k, a in self.arch.items():
            a.grad = grad if k == "upconv" else torch.zeros_like(a)
        self.opt_arch.step()
        return {"loss_arch": loss.detach()}

    # -- inference --------------------------------------------------------
    @torch.no_grad()
    def generate(self, mask):
        """G in eval mode on an NHWC mask -> NHWC float32 image."""
        with self.amp():
            fake = self.g_apply(_nchw(mask.float()), self.arch["upconv"],
                                False)
        return fake.float().permute(0, 2, 3, 1)
