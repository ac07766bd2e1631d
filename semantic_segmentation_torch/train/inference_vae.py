"""Soft-intro VAE multi-style inference — the port of
``semantic_segmentation_tpu/train/inference_vae.py``
(``Soft-intro_VAE/inference.py:21-100``): load ``train_vae``'s checkpoint
(the port's ``sivae.pt``), decode ``num_styles`` latents per validation
condition, save each style's image and the ``FID_real`` / ``FID_fake``
directories, and score each image's style diversity as the mean pairwise
distance of its styles: LPIPS-alex when the feature net is given
(``alex`` = (``AlexNetFeatures`` on the device, its five lin weights), as
``utils/torch_port.port_alexnet_lpips`` maps them), the reference
``PerceptualLoss``'s l1 branch otherwise (``Soft-intro_VAE/metrics.py:
19-27``). The styles go to LPIPS as the decoder gives them, in [-1, 1], as
the JAX package passes them.

The latent of style ``k`` of validation batch ``bi`` is drawn from fold
``bi * 131 + k`` of ``run.seed + 101``.

Usage: ``python -m semantic_segmentation_torch.train.inference_vae
--preset=sivae --run.save_dir=<train_vae's> [--run.device=cpu]``.
"""

from __future__ import annotations

import itertools
import logging
import os

import numpy as np
import torch

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.data.pipeline import eval_batches
from semantic_segmentation_torch.models.vae.sivae import SoftIntroVAE
from semantic_segmentation_torch.ops.gen_metrics import lpips
from semantic_segmentation_torch.train.common import (autocast_for,
                                                      fold_generator,
                                                      load_splits)
from semantic_segmentation_torch.train.train_vae import (build_model,
                                                         load_checkpoint)
from semantic_segmentation_torch.utils.visuals import save_image

log = logging.getLogger(__name__)


def style_distance(styles: list, j: int, alex=None) -> float:
    """The mean pairwise distance of image ``j``'s styles (each style an
    NHWC numpy batch): LPIPS-alex with ``alex``, else the mean absolute
    difference (inference.py:84-94)."""
    pair_d = []
    for k1, k2 in itertools.combinations(range(len(styles)), 2):
        if alex is not None:
            d = float(np.mean(lpips(alex[0], alex[1], styles[k1][j:j + 1],
                                    styles[k2][j:j + 1])))
        else:
            d = float(np.mean(np.abs(styles[k1][j] - styles[k2][j])))
        pair_d.append(d)
    return float(np.mean(pair_d))


@torch.no_grad()
def run(cfg: Config, num_styles: int = 3, limit: int | None = None,
        alex=None, model: SoftIntroVAE | None = None, device=None,
        draws: list | None = None) -> dict:
    """Returns {'diversity': the mean over images, 'per_image': [...],
    'images': the count}. ``draws`` (optional) injects the latents: one
    list of ``num_styles`` (B, 8) tensors per validation batch."""
    dev = resolve_device(device or cfg.run.device)
    model = model or build_model(cfg, dev)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    load_checkpoint(model, os.path.join(save_dir, "sivae.pt"))
    model.decoder.eval()
    amp = autocast_for(cfg, dev)
    out_dir = os.path.join(save_dir, "inference")
    for sub in ("FID_real", "FID_fake", "styles"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    dists, idx = [], 0
    for bi, b in enumerate(eval_batches(load_splits(cfg)["val"],
                                        cfg.data.batch_size)):
        # the training condition (train_vae.prep): the 3-channel mask
        cond = torch.from_numpy(np.ascontiguousarray(np.repeat(
            b["mask"].astype(np.float32), 3, -1).transpose(0, 3, 1, 2))
            ).to(dev)
        img = np.asarray(b["image"], np.float32)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        styles = []
        for k in range(num_styles):
            z = (draws[bi][k].to(dev) if draws is not None else torch.randn(
                cond.shape[0], model.latent_dim, generator=fold_generator(
                    cfg.run.seed + 101, bi * 131 + k, dev), device=dev))
            with amp():
                y = model.decoder(cond, z)
            styles.append(y.permute(0, 2, 3, 1).cpu().numpy())
        for j in range(cond.shape[0]):
            if limit is not None and idx >= limit:
                break
            save_image(img[j], os.path.join(out_dir, "FID_real",
                                            f"real{idx}.png"))
            save_image(styles[-1][j], os.path.join(out_dir, "FID_fake",
                                                   f"fake{idx}.png"))
            for k in range(num_styles):
                save_image(styles[k][j], os.path.join(
                    out_dir, "styles", f"style{k}_image{idx}.png"))
            dists.append(style_distance(styles, j, alex))
            idx += 1
        if limit is not None and idx >= limit:
            break
    result = {"diversity": float(np.mean(dists)) if dists else 0.0,
              "per_image": dists, "images": idx}
    log.info("SIVAE inference: %d images, mean style diversity %.5f", idx,
             result["diversity"])
    return result


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    run(parse_config(argv, preset="sivae"))


if __name__ == "__main__":
    main()
