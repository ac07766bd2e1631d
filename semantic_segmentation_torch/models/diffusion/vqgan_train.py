"""VQGAN training — the port of
``semantic_segmentation_tpu/models/diffusion/vqgan_train.py`` (taming's
``VQLPIPSWithDiscriminator``, ``BBDM/model/VQGAN/vqperceptual.py`` and
``vqgan.py:116-160``):

- the autoencoder step: nll = mean(|x - recon| + w_p * LPIPS(vgg)) +
  d_weight * adopt_weight(disc_factor, step, disc_start) * (-mean(D(recon)))
  + codebook_weight * qloss;
- the adaptive ``d_weight``: the norm of the nll's gradient at the
  decoder's ``conv_out.weight`` over the norm of the G loss's gradient
  there, + 1e-4, clipped to [0, 1e4] and detached, times ``disc_weight``
  (vqperceptual.py:64-76);
- the discriminator step: adopt_weight * the hinge (or vanilla) loss on the
  real images and the detached reconstructions (vqperceptual.py:119-130);
- two ``Adam(lr, betas=(0.5, 0.9))`` over the VQ model's and D's
  parameters (vqgan.py:140-150).

D is the pix2pix PatchGAN (``NLayerDiscriminator``, taming's
discriminator.py points at the CycleGAN one) on the VQ model's
``out_channels``, in train mode (batch statistics) in both steps. Its BN
running statistics follow the JAX package's: the autoencoder step's D
forward runs on scratch copies of them (JAX discards its stats), the D
step's two forwards fold them real then fake and keep them.

Batches are NHWC (the JAX package's layout); the nets are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semantic_segmentation_torch.models.diffusion.vqgan import VQModel
from semantic_segmentation_torch.models.pix2pix.networks import define_D
from semantic_segmentation_torch.models.vgg import vgg_lpips
from semantic_segmentation_torch.ops.layers import call_module


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """vqperceptual.py:15-18: ``value`` before ``threshold`` steps."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VQGANTrainer:
    """The two-optimizer VQGAN step on ``vq``'s device. ``perceptual`` is
    an optional (``models/vgg.VGG16Features`` on that device, its five
    LPIPS lin weights); without it the perceptual term is off. D's weights
    are drawn from ``generator`` (pix2pix's N(0, 0.02) law)."""

    def __init__(self, vq: VQModel, lr: float = 4.5e-6,
                 disc_start: int = 10000, disc_ndf: int = 64,
                 disc_num_layers: int = 3, disc_factor: float = 1.0,
                 disc_weight: float = 1.0, codebook_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_loss: str = "hinge",
                 perceptual=None, generator: torch.Generator | None = None):
        self.vq = vq
        device = next(vq.parameters()).device
        self.disc = define_D(vq.out_channels, "n_layers", disc_ndf,
                             disc_num_layers, generator).to(device)
        self.disc_start = disc_start
        self.disc_factor = disc_factor
        self.disc_weight = disc_weight
        self.codebook_weight = codebook_weight
        self.perceptual = perceptual
        self.perceptual_weight = perceptual_weight if perceptual else 0.0
        if perceptual:
            perceptual[0].requires_grad_(False)
        self.d_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.opt_ae = torch.optim.Adam(vq.parameters(), lr=lr,
                                       betas=(0.5, 0.9), eps=1e-8)
        self.opt_disc = torch.optim.Adam(self.disc.parameters(), lr=lr,
                                         betas=(0.5, 0.9), eps=1e-8)
        self.step = 0

    # -- loss pieces --------------------------------------------------------
    def nll(self, x, recon):
        """mean(|x - recon| + w_p * LPIPS(x, recon)), the per-image LPIPS
        added to every element before the one global mean, as the
        reference does. NCHW float32."""
        rec = torch.abs(x - recon)
        if self.perceptual_weight > 0:
            net, lins = self.perceptual
            with torch.autocast(x.device.type, enabled=False):
                p = vgg_lpips(net, lins, _nhwc(x), _nhwc(recon))
            rec = rec + self.perceptual_weight * p.reshape(-1, 1, 1, 1)
        return torch.mean(rec)

    def d_logits(self, x, keep_stats: bool):
        """D in train mode on an NCHW batch, float32 logits; with
        ``keep_stats`` False its BN statistics go to scratch copies."""
        self.disc.train()
        with self.vq.amp():
            return call_module(self.disc, (x,), keep_stats).float()

    # -- the two optimizer steps ---------------------------------------------
    def train_step_ae(self, x) -> dict:
        """optimizer_idx 0 (vqgan.py:116-127) on an NHWC batch. Returns the
        losses and weights as floats-to-be (0-d tensors)."""
        x = _nchw(x.float())
        recon, qloss, _ = self.vq(x)
        nll = self.nll(x, recon)
        g_loss = -torch.mean(self.d_logits(recon, keep_stats=False))
        last = self.vq.decoder.conv_out.weight
        (g_nll,) = torch.autograd.grad(nll, last, retain_graph=True)
        (g_g,) = torch.autograd.grad(g_loss, last, retain_graph=True)
        d_weight = torch.clamp(torch.linalg.vector_norm(g_nll)
                               / (torch.linalg.vector_norm(g_g) + 1e-4),
                               0.0, 1e4).detach() * self.disc_weight
        disc_factor = adopt_weight(self.disc_factor, self.step,
                                   self.disc_start)
        loss = nll + d_weight * disc_factor * g_loss \
            + self.codebook_weight * qloss
        self.opt_ae.zero_grad(set_to_none=True)
        loss.backward(inputs=list(self.vq.parameters()))
        self.opt_ae.step()
        return {"aeloss": loss.detach(), "d_weight": d_weight,
                "disc_factor": torch.tensor(disc_factor),
                "nll_loss": nll.detach(), "g_loss": g_loss.detach(),
                "qloss": qloss.detach()}

    def train_step_disc(self, x) -> dict:
        """optimizer_idx 1 (vqgan.py:129-135, vqperceptual.py:119-134) on an
        NHWC batch; counts the step."""
        x = _nchw(x.float())
        with torch.no_grad():
            recon, _, _ = self.vq(x)
        disc_factor = adopt_weight(self.disc_factor, self.step,
                                   self.disc_start)
        logits_real = self.d_logits(x, keep_stats=True)
        logits_fake = self.d_logits(recon, keep_stats=True)
        loss = disc_factor * self.d_loss(logits_real, logits_fake)
        self.opt_disc.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_disc.step()
        self.step += 1
        return {"discloss": loss.detach()}

    def train_step(self, x) -> dict:
        """One iteration: the autoencoder step, then the D step."""
        return {**self.train_step_ae(x), **self.train_step_disc(x)}
