"""Soft-intro VAE pre-training — the port of
``semantic_segmentation_tpu/train/train_vae.py``
(``Soft-intro_VAE/train_vae.py:28-324``): ``num_vae`` steps of a plain
conditional VAE (one joint Adam step of each net on beta_rec * rec +
beta_kl * KL), then the soft-introspective phase, each step an encoder
step and a decoder step:

- encoder step (the decoder's parameters fixed; ``backward`` into the
  encoder's only): the real ELBO, scaled by 1 / (3 H W), plus a quarter of
  the exp-ELBO repulsion of the sampled fake and the reconstruction, each
  through a re-encoding of the detached image (exponents clipped to
  +-50);
- decoder step (the updated encoder's parameters fixed, its activations
  differentiated through): the reconstruction, the KL of the re-encoded
  fake and reconstruction, and gamma_r times their reconstructions'
  losses, all scaled by 1 / (3 H W).

Every net call is a train-mode forward, so the encoder's BN running
statistics advance at each of its calls (three per sub-step), in the JAX
order, and the decoder step starts from the encoder step's statistics.
The Gaussian draws are inputs (``draws``) or come from a
``torch.Generator``: the step's ``noise`` and the three reparameterization
noises ``eps``, ``eps_fake``, ``eps_rec`` (the JAX step's
``jax.random.split(rng, 4)``).

``recon_loss_type='vgg'`` replaces every reconstruction term by the VGG16
perceptual loss (relu2_2 + relu3_3 MSE, in float32), which ignores its
reduction and returns a scalar that broadcasts into the exp terms (the
reference's quirk, ``train_vae.py:80-89`` of the JAX package). Without
given VGG weights the net is drawn from the run's seeded generator.

Both Adams (optax's defaults: betas (0.9, 0.999), eps 1e-8) take their
learning rate from the epoch's MultiStepLR (milestones 25 and 38, gamma
0.1), set at each epoch's start. The images enter in [-1, 1]; the
condition is the mask repeated to 3 channels. Checkpoints are the port's
own ``sivae.pt`` (and ``sivae_epoch<N>.pt`` every ``run.save_every``
epochs): the encoder's and decoder's state dicts and the arch table.

Usage: ``python -m semantic_segmentation_torch.train.train_vae
--preset=sivae --data.dataroot=<ISIC dir> [--data.synthetic=true]
[--run.device=cpu]``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import (adam_torch,
                                                    set_learning_rate)
from semantic_segmentation_torch.data.pipeline import batch_iterator
from semantic_segmentation_torch.models.vae.sivae import (
    SoftIntroVAE, calc_kl, calc_reconstruction_loss, init_weights_,
    reparameterize)
from semantic_segmentation_torch.models.vgg import (VGG16Features,
                                                    vgg_perceptual_loss)
from semantic_segmentation_torch.train.common import (autocast_for,
                                                      fold_generator,
                                                      load_splits)

LATENT = 8
MILESTONES, GAMMA = (25, 38), 0.1


@dataclass
class SIVAEParams:
    """The config tree's defaults (Soft-intro_VAE/config)."""
    beta_rec: float = 1.0
    beta_kl: float = 1.0
    beta_neg: float = 256.0
    gamma_r: float = 1e-8
    lr_e: float = 2e-4
    lr_d: float = 2e-4
    recon_loss_type: str = "mse"
    num_vae: int = 2000          # warmup iterations of the plain VAE


def multistep_lr(base: float, epoch: int, milestones=MILESTONES,
                 gamma: float = GAMMA) -> float:
    """MultiStepLR(milestones=[25, 38], gamma=0.1) at ``epoch``
    (config/schedulers/defaults_vae.yaml; stepped at each epoch's end,
    train_vae.py:308-309)."""
    return base * gamma ** sum(epoch >= m for m in milestones)


def build_model(cfg: Config, device) -> SoftIntroVAE:
    """The VAE of ``cfg``: latent 8, RGB, ``model.ngf``, the decoder's
    depth paired to ``data.image_size`` (unet_128 at 128^2, unet_256 at
    256^2), drawn from ``run.seed``."""
    return SoftIntroVAE(LATENT, 3, cfg.model.ngf,
                        f"unet_{cfg.data.image_size}", device=device,
                        generator=torch.Generator().manual_seed(cfg.run.seed))


def draw_vae(n: int, latent: int, generator=None, device=None) -> dict:
    """``vae_step``'s draw: the reparameterization noise."""
    return {"eps": torch.randn(n, latent, generator=generator, device=device)}


def draw_soft_intro(n: int, latent: int, generator=None, device=None):
    """``soft_intro_step``'s draws: the fake's latent ``noise`` and the
    real, fake and reconstruction reparameterization noises."""
    return {k: torch.randn(n, latent, generator=generator, device=device)
            for k in ("noise", "eps", "eps_fake", "eps_rec")}


class SIVAETrainer:
    """The two phases' steps on ``model`` (its modules hold the weights and
    BN statistics; two Adams). ``amp`` is the autocast context of
    ``model.compute_dtype``; ``vgg`` the perceptual loss's net (under
    ``recon_loss_type='vgg'``; drawn from ``generator`` if not given)."""

    def __init__(self, model: SoftIntroVAE, hp: SIVAEParams,
                 image_size: int, vgg: VGG16Features | None = None,
                 amp=contextlib.nullcontext,
                 generator: torch.Generator | None = None):
        self.m, self.hp, self.amp = model, hp, amp
        self.scale = 1.0 / (3 * image_size * image_size)   # 1 / (C H W)
        self.vgg = None
        if hp.recon_loss_type == "vgg":
            if vgg is None:
                vgg = init_weights_(VGG16Features(), generator)
            self.vgg = vgg.to(model.arch.device).requires_grad_(False)
        self.opt_e = adam_torch(model.encoder.parameters(), hp.lr_e, 0.9)
        self.opt_d = adam_torch(model.decoder.parameters(), hp.lr_d, 0.9)

    def set_epoch(self, epoch: int):
        set_learning_rate(self.opt_e, multistep_lr(self.hp.lr_e, epoch))
        set_learning_rate(self.opt_d, multistep_lr(self.hp.lr_d, epoch))

    def rec_loss(self, x, rec, reduction: str):
        if self.vgg is not None:
            # the JAX package runs the VGG in float32 whatever the compute
            # dtype; a scalar whatever the reduction
            with torch.autocast(x.device.type, enabled=False):
                return vgg_perceptual_loss(self.vgg(x.float()),
                                           self.vgg(rec.float()))
        return calc_reconstruction_loss(x, rec, self.hp.recon_loss_type,
                                        reduction)

    def _draws(self, draws, maker, n, generator):
        if draws is None:
            draws = maker(n, self.m.latent_dim, generator,
                          self.m.arch.device)
        return draws

    def _encode(self, x):
        return self.m.encoder(x, self.m.arch)

    # -- phase 1: the plain VAE ----------------------------------------------
    def vae_step(self, a, b, draws: dict | None = None,
                 generator: torch.Generator | None = None) -> dict:
        """One joint step; ``a`` the condition, ``b`` the image, NCHW."""
        hp, m = self.hp, self.m
        d = self._draws(draws, draw_vae, a.shape[0], generator)
        m.train()
        with self.amp():
            mu, logvar = self._encode(b)
            rec = m.decoder(a, reparameterize(mu, logvar, d["eps"]))
        loss_rec = self.rec_loss(b, rec, "mean")
        loss_kl = calc_kl(logvar, mu, "mean")
        loss = hp.beta_rec * loss_rec + hp.beta_kl * loss_kl
        self.opt_e.zero_grad(set_to_none=True)
        self.opt_d.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_e.step()
        self.opt_d.step()
        return {"loss": loss.detach(), "loss_rec": loss_rec.detach(),
                "loss_kl": loss_kl.detach()}

    # -- phase 2: soft-intro ---------------------------------------------------
    def soft_intro_step(self, a, b, draws: dict | None = None,
                        generator: torch.Generator | None = None) -> dict:
        hp, s, m = self.hp, self.scale, self.m
        d = self._draws(draws, draw_soft_intro, a.shape[0], generator)
        enc, dec = m.encoder, m.decoder
        m.train()

        def exp_elbo(l_rec, kl):
            return torch.exp(torch.clamp(
                -2 * s * (hp.beta_rec * l_rec + hp.beta_neg * kl),
                -50, 50)).mean()

        # ===== encoder step (the decoder's parameters fixed) =====
        with self.amp():
            fake = dec(a, d["noise"])
            mu, logvar = self._encode(b)
            rec = dec(a, reparameterize(mu, logvar, d["eps"]))
        loss_rec = self.rec_loss(b, rec, "mean")
        real_kl = calc_kl(logvar, mu, "mean")
        with self.amp():
            fmu, flv = self._encode(fake.detach())
            rmu, rlv = self._encode(rec.detach())
            rec_fake = dec(a, reparameterize(fmu, flv, d["eps_fake"]))
            rec_rec = dec(a, reparameterize(rmu, rlv, d["eps_rec"]))
        exp_fake = exp_elbo(self.rec_loss(fake, rec_fake, "none"),
                            calc_kl(flv, fmu, "none"))
        exp_rec = exp_elbo(self.rec_loss(rec, rec_rec, "none"),
                           calc_kl(rlv, rmu, "none"))
        loss_e = s * (hp.beta_rec * loss_rec + hp.beta_kl * real_kl) + \
            0.25 * (exp_fake + exp_rec)
        self.opt_e.zero_grad(set_to_none=True)
        loss_e.backward(inputs=list(enc.parameters()))
        self.opt_e.step()

        # ===== decoder step (the updated encoder's parameters fixed) =====
        with self.amp():
            fake = dec(a, d["noise"])
            mu, logvar = self._encode(b)
            z = reparameterize(mu, logvar, d["eps"]).detach()
            rec = dec(a, z)
        loss_rec_d = self.rec_loss(b, rec, "mean")
        with self.amp():
            rmu, rlv = self._encode(rec)
            fmu, flv = self._encode(fake)
            # the JAX step draws zr from kd1 and zf from kd2 here
            zr = reparameterize(rmu, rlv, d["eps_fake"]).detach()
            zf = reparameterize(fmu, flv, d["eps_rec"]).detach()
            rec_rec = dec(a, zr)
            rec_fake = dec(a, zf)
        l_rr = self.rec_loss(rec.detach(), rec_rec, "mean")
        l_rf = self.rec_loss(fake.detach(), rec_fake, "mean")
        fake_kl = calc_kl(flv, fmu, "mean")
        rec_kl = calc_kl(rlv, rmu, "mean")
        loss_d = s * (hp.beta_rec * loss_rec_d
                      + 0.5 * hp.beta_kl * (fake_kl + rec_kl)
                      + hp.gamma_r * 0.5 * hp.beta_rec * (l_rr + l_rf))
        self.opt_d.zero_grad(set_to_none=True)
        loss_d.backward(inputs=list(dec.parameters()))
        self.opt_d.step()
        return {"lossE": loss_e.detach(), "lossD": loss_d.detach(),
                "loss_rec": loss_rec.detach(), "loss_kl": real_kl.detach()}


def prep(batch: dict, device):
    """(condition, image) NCHW on ``device``: the mask repeated to 3
    channels, the image (gray repeated) mapped to [-1, 1]."""
    a = np.repeat(batch["mask"].astype(np.float32), 3, axis=-1)
    b = batch["image"].astype(np.float32)
    if b.shape[-1] == 1:
        b = np.repeat(b, 3, axis=-1)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2))).to(device) for v in (a, b * 2.0 - 1.0))


def checkpoint_state(model: SoftIntroVAE) -> dict:
    return {"encoder": model.encoder.state_dict(),
            "decoder": model.decoder.state_dict(), "arch": model.arch}


def load_checkpoint(model: SoftIntroVAE, path: str) -> SoftIntroVAE:
    """``model`` with the weights, BN statistics and arch table of a
    ``sivae*.pt`` checkpoint."""
    state = torch.load(path, map_location=model.arch.device,
                       weights_only=True)
    model.encoder.load_state_dict(state["encoder"])
    model.decoder.load_state_dict(state["decoder"])
    with torch.no_grad():
        model.arch.copy_(state["arch"])
    return model


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Config, train_iters: int | None = None,
          hp: SIVAEParams | None = None, model: SoftIntroVAE | None = None,
          device=None):
    """Train on ``device`` (default ``cfg.run.device``, 'cuda'). Returns
    (trainer, results): ``results`` has the step count, the last metrics,
    each phase's steps, wall seconds (ending in a device sync) and the
    seconds to the end of its first step, and the final checkpoint's
    path, bytes and write seconds."""
    dev = resolve_device(device or cfg.run.device)
    hp = hp or SIVAEParams()
    model = model or build_model(cfg, dev)
    trainer = SIVAETrainer(model, hp, cfg.data.image_size, None,
                           autocast_for(cfg, dev),
                           torch.Generator().manual_seed(cfg.run.seed))
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    iters = train_iters or cfg.engine.train_iters
    phases = {"vae": {"steps": 0, "seconds": 0.0},
              "soft_intro": {"steps": 0, "seconds": 0.0}}

    def save(tag: str) -> dict:
        path = os.path.join(save_dir, f"sivae{tag}.pt")
        _sync(dev)
        t0 = time.perf_counter()
        torch.save(checkpoint_state(model), path)
        return {"path": path, "bytes": os.path.getsize(path),
                "seconds": time.perf_counter() - t0}

    def close_phase(phase: str, t0: float) -> float:
        _sync(dev)
        now = time.perf_counter()
        phases[phase]["seconds"] += now - t0
        return now

    it, epoch, metrics = 0, 0, {}
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        t0 = time.perf_counter()
        while it < iters:
            trainer.set_epoch(epoch)
            rng = np.random.default_rng((cfg.run.seed, epoch))
            for batch in batch_iterator(splits["train"], cfg.data.batch_size,
                                        rng):
                if it == hp.num_vae and it > 0:
                    t0 = close_phase("vae", t0)
                phase = "vae" if it < hp.num_vae else "soft_intro"
                a, b = prep(batch, dev)
                step = (trainer.vae_step if phase == "vae"
                        else trainer.soft_intro_step)
                metrics = step(a, b, generator=fold_generator(
                    cfg.run.seed + 11, it, dev))
                if phases[phase]["steps"] == 0:
                    # the first step of a phase builds (cuDNN plans, the
                    # allocator's pool): timed apart, for the steady rate
                    _sync(dev)
                    phases[phase]["first_step_seconds"] = \
                        time.perf_counter() - t0
                phases[phase]["steps"] += 1
                it += 1
                if it % cfg.run.log_every == 0:
                    log.log({k: float(v) for k, v in metrics.items()}, it)
                if it >= iters:
                    break
            epoch += 1
            # periodic checkpoints (train_vae.py:97-99 save_interval)
            if cfg.run.save_every and epoch % cfg.run.save_every == 0:
                save(f"_epoch{epoch}")
        close_phase("vae" if it <= hp.num_vae else "soft_intro", t0)
        ckpt = save("")
        results = {"steps": it, "epochs": epoch, "phases": phases,
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "checkpoint": ckpt}
        log.info("train_vae: %s", results)
    return trainer, results


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    cfg.run.name = cfg.run.name or "sivae"
    train(cfg)


if __name__ == "__main__":
    main()
