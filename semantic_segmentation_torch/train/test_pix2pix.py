"""Generator-only pix2pix inference — the port of
``semantic_segmentation_tpu/train/test_pix2pix.py`` (the reference's
``TestModel``, ``models_pix2pix/test_model.py:5-69``, with its generic
``test.py`` script's webpage): build G from the config, load a stage-1
checkpoint (``train_pix2pix.load_model``: the port's ``.pt``, the JAX
package's ``.msgpack`` or the reference's ``.pkl``) from
``run.pretrained_pix2pix`` (default ``<save_dir>/<name>``), map every
``mask_pix2pix`` condition of the dataset through G in eval mode, batch
by batch, under ``torch.no_grad`` and the model's autocast, and write an
``HTMLReport`` of (input, fake[, target]) rows under
``<save_dir>/<name>/test_results``. Under colorization (``output_nc`` 2)
the fake and the target render through ``lab_to_rgb`` with the input's L.

Usage: ``python -m semantic_segmentation_torch.train.test_pix2pix
--data.dataroot=<dir> --run.pretrained_pix2pix=<checkpoint dir>
[--preset=pix2pix_colorization] [--run.device=cpu]``.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.data.extra import lab_to_rgb
from semantic_segmentation_torch.data.folder import make_dataset
from semantic_segmentation_torch.data.pipeline import stack_dataset
from semantic_segmentation_torch.train.train_pix2pix import (build_pix2pix,
                                                             load_model)
from semantic_segmentation_torch.utils.visuals import HTMLReport

log = logging.getLogger(__name__)


def run(cfg: Config, limit: int | None = None, device=None) -> str:
    """Write the report for the first ``limit`` items (all by default, the
    reference's ``--num_test``) on ``device`` (default ``cfg.run.device``,
    'cuda'). Returns the report's directory."""
    dev = resolve_device(device or cfg.run.device)
    model = build_pix2pix(cfg, dev,
                          torch.Generator().manual_seed(cfg.run.seed))
    load_model(model, cfg.run.pretrained_pix2pix
               or os.path.join(cfg.run.save_dir, cfg.run.name))

    ds = make_dataset(cfg.data.dataset, cfg.data.dataroot,
                      cfg.data.mask_suffix, image_size=cfg.data.image_size)
    n = len(ds) if limit is None else min(limit, len(ds))
    data = stack_dataset(ds, list(range(n)))

    out_dir = os.path.join(cfg.run.save_dir, cfg.run.name, "test_results")
    report = HTMLReport(out_dir, title=cfg.run.name)
    B = max(1, cfg.data.batch_size)
    for i in range(0, n, B):
        cond = data["mask_pix2pix"][i:i + B].astype(np.float32)
        fake = model.generate(torch.from_numpy(cond).to(dev)).cpu().numpy()
        for j in range(cond.shape[0]):
            report.add_row(f"item{i + j:04d}", report_row(
                cond[j], fake[j], data["image_pix2pix"][i + j]
                if "image_pix2pix" in data else None, cfg.model.output_nc))
    report.write()
    log.info("test_pix2pix: %d items in %s", n, out_dir)
    return out_dir


def report_row(cond, fake, target, output_nc: int) -> dict:
    """One report row: ``real`` (the input), ``fake`` and, where the item
    has one, ``target``; under colorization the fake (clipped to [0, 1])
    and the target as RGB through ``lab_to_rgb`` with the input's L."""
    row = {"real": cond, "fake": fake}
    if output_nc == 2:
        row["fake"] = lab_to_rgb(np.concatenate(
            [cond, np.clip(fake, 0.0, 1.0)], axis=-1)).astype(np.float32)
        if target is not None:
            target = lab_to_rgb(np.concatenate(
                [cond, target], axis=-1)).astype(np.float32)
    if target is not None:
        row["target"] = target
    return row


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s: %(message)s")
    run(parse_config(argv))


if __name__ == "__main__":
    main()
