"""Latent-space BBDM — the port of
``semantic_segmentation_tpu/models/diffusion/latent_bbdm.py``
(``BBDM/model/BrownianBridge/LatentBrownianBridgeModel.py:20-147``): the
Brownian bridge run in the latent space of a FROZEN VQGAN, with the
optional latent mean/std normalization (estimated over the training set,
the ``BBDMRunner`` latent statistics) and the condition stage
``first_stage`` (the condition's latent is the context) or ``nocond``;
and ``SpatialRescaler``, the other condition stage of the reference.

NCHW. The denoiser is the bridge's ``denoise(x_t, t, context, train)``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semantic_segmentation_torch.models.diffusion.bbdm import (BridgeSchedule,
                                                               BrownianBridge)
from semantic_segmentation_torch.models.diffusion.vqgan import VQModel
from semantic_segmentation_torch.models.extractors import resize_weights
from semantic_segmentation_torch.ops.layers import lecun_normal_


def half_bilinear(x):
    """``jax.image.resize(x, (B, H // 2, W // 2, C), 'bilinear')`` on NCHW:
    the JAX-rule weight matrices (antialiased, since it shrinks) of
    ``models/extractors.resize_weights``, contracted in float32."""
    h, w = x.shape[-2:]
    wh = resize_weights(h, h // 2).to(x.device)
    ww = resize_weights(w, w // 2).to(x.device)
    return torch.einsum("nchw,hy,wx->ncyx", x.float(), wh, ww)


class SpatialRescaler(nn.Module):
    """encoders/modules.py SpatialRescaler: ``n_stages`` bilinear halvings
    and, with ``out_channels``, a bias-free 1x1 channel map (LeCun-normal,
    flax's default)."""

    def __init__(self, n_stages: int = 2, in_channels: int | None = None,
                 out_channels: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_stages = n_stages
        self.remap = None
        if out_channels is not None:
            self.remap = nn.Conv2d(in_channels, out_channels, 1, bias=False)
            lecun_normal_(self.remap.weight, generator)

    def forward(self, x):
        for _ in range(self.n_stages):
            x = half_bilinear(x)
        return x if self.remap is None else self.remap(x)


class LatentBrownianBridge:
    """The bridge around (denoiser, frozen ``VQModel``). ``stats`` is the
    ``{'mean', 'std'}`` of ``estimate_latent_stats``, used where
    ``normalize_latent``."""

    def __init__(self, vqgan: VQModel, schedule: BridgeSchedule,
                 objective: str = "grad", loss_type: str = "l1",
                 condition_key: str = "nocond",
                 normalize_latent: bool = False):
        self.vqgan = vqgan
        self.condition_key = condition_key
        self.normalize_latent = normalize_latent
        self.bridge = BrownianBridge(
            schedule, objective, loss_type,
            condition_key="nocond" if condition_key == "nocond"
            else "first_stage")

    # -- latent helpers -----------------------------------------------------
    @torch.no_grad()
    def get_latent(self, x, stats=None):
        """E(x) before quantization, detached; normalized with ``stats``
        under ``normalize_latent``."""
        z = self.vqgan.encode_pre_quant(x).float()
        if self.normalize_latent and stats is not None:
            z = (z - stats["mean"]) / stats["std"]
        return z

    @torch.no_grad()
    def decode_latent(self, z, stats=None):
        if self.normalize_latent and stats is not None:
            z = z * stats["std"] + stats["mean"]
        return self.vqgan.decode_from_pre_quant(z)

    @torch.no_grad()
    def estimate_latent_stats(self, images) -> dict:
        """The latent's mean and (population) std over ``images`` (the
        reference estimates them over up to 30k training samples)."""
        z = self.vqgan.encode_pre_quant(images).float()
        return {"mean": z.mean(), "std": z.std(unbiased=False)}

    # -- training loss ------------------------------------------------------
    def p_losses(self, denoise, x_img, y_img, draws=None, generator=None,
                 stats=None, train: bool = True):
        """The bridge loss between the latents of ``x_img`` (the target)
        and ``y_img`` (the condition), NCHW images; ``draws`` as
        ``BrownianBridge.draw_losses`` gives them for the latent."""
        x0 = self.get_latent(x_img, stats)
        y = self.get_latent(y_img, stats)
        context = None if self.condition_key == "nocond" else y
        return self.bridge.p_losses(denoise, x0, y, draws, generator,
                                    context=context, train=train)

    # -- sampling -----------------------------------------------------------
    @torch.no_grad()
    def sample(self, denoise, y_img, noises=None, generator=None,
               stats=None, clip_denoised: bool = False):
        """The whole sampler from the condition's latent, decoded to an
        image (NCHW, float32)."""
        y = self.get_latent(y_img, stats)
        context = None if self.condition_key == "nocond" else y
        z = self.bridge.p_sample_loop(denoise, y, noises, generator,
                                      context=context,
                                      clip_denoised=clip_denoised)
        return self.decode_latent(z, stats)
