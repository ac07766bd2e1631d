"""Stage-1 3D Pix2Pix (Pix2PixNIfTI) pre-training — the port of
``semantic_segmentation_tpu/train/train_pix2pix_3d.py``
(``GenSeg-3D/train.py:31-106``): the epoch loop of ``optimize_parameters``
on paired volumes (one D step on a detached fake, then one G step, with the
masked-L1 + tumour-MSE generator objective of ``train_end2end_3d``), the
losses logged every ``run.log_every`` steps, and G (parameters and
statistics) with its arch table saved as ``pix2pix3d_generator.pt``; and
``evaluate_generation`` (``GenSeg-3D/test.py`` with ExcelEvaluate): fake
volumes scored against the real ones (masked MAE / MSE / PSNR, SSIM),
written to CSV.

Usage: ``python -m semantic_segmentation_torch.train.train_pix2pix_3d
--data.dataroot=<dir with imgsA/ imgsB/ truths/> [--data.synthetic=true]
[--run.device=cpu]``.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.data.pipeline import (batch_iterator,
                                                       eval_batches)
from semantic_segmentation_torch.ops import gen_metrics
from semantic_segmentation_torch.train.train_end2end_3d import (
    GenSeg3D, load_volume_splits, ncdhw)

GENERATOR_FILE = "pix2pix3d_generator.pt"


def train_step(problems, batch, generator: torch.Generator | None = None):
    """One D step on a detached fake, then one G step against the updated
    D (``optimize_parameters``), with the netD and netG problems of
    ``GenSeg3D.build_problems``. Returns the losses as 0-d tensors."""
    out = {}
    for p, key in ((problems[1], "loss_D"), (problems[0], "loss_G")):
        loss = p.loss(batch, {}, None, generator)
        p.optimizer.zero_grad(set_to_none=True)
        loss.backward(inputs=list(p.module.parameters()))
        p.optimizer.step()
        out[key] = loss.detach()
    return out


def train(cfg: Config, train_iters: int | None = None, crop: int = 64,
          num_downs: int = 6, upsampling: str = "linear",
          gamma_tmse: float = 0.0, device=None):
    """Train G and D on ``device`` (default ``cfg.run.device``, 'cuda') for
    ``train_iters`` steps (default ``engine.train_iters``) and save G.
    Returns (model, results); ``results['log']`` has the logged records."""
    dev = resolve_device(device or cfg.run.device)
    model = GenSeg3D(cfg, num_downs, upsampling, gamma_tmse, dev,
                     torch.Generator().manual_seed(cfg.run.seed))
    problems, _ = model.build_problems()
    draw_gen = torch.Generator(device=dev).manual_seed(cfg.run.seed + 1)
    splits = load_volume_splits(cfg, crop)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    records = []
    with MetricsLogger(save_dir) as log:
        it, epoch = 0, 0
        iters = train_iters or cfg.engine.train_iters
        while it < iters:
            rng_np = np.random.default_rng((cfg.run.seed, epoch))
            for batch in batch_iterator(splits["train"], cfg.data.batch_size,
                                        rng_np):
                metrics = train_step(
                    problems, {k: torch.from_numpy(v).to(dev)
                               for k, v in batch.items()}, draw_gen)
                it += 1
                if it % cfg.run.log_every == 0:
                    rec = {k: float(v) for k, v in metrics.items()}
                    records.append({"step": it, **rec})
                    log.info("step %d: %s", it, rec)
                    log.log(rec, it)
                if it >= iters:
                    break
            epoch += 1
        save_generator(model, save_dir)
    return model, {"steps": it, "log": records}


def save_generator(model: GenSeg3D, save_dir: str):
    """``torch.save`` of G's parameters and statistics with the arch table
    (the JAX package's ``pix2pix3d_generator.msgpack``)."""
    os.makedirs(save_dir, exist_ok=True)
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    torch.save({"G": cpu(model.G.state_dict()), "arch": cpu(model.arch)},
               os.path.join(save_dir, GENERATOR_FILE))


@torch.no_grad()
def evaluate_generation(model: GenSeg3D, data, batch_size: int,
                        out_csv: str):
    """``test.py`` + ExcelEvaluate: G in eval mode on each volume's A,
    scored against B inside A's foreground mask; one CSV row per volume."""
    rows = []
    for i, b in enumerate(eval_batches(data, batch_size)):
        a = ncdhw(torch.from_numpy(b["A"]).float().to(model.device))
        with model.amp():
            fake = model.g_apply(a, model.arch["conv"], False)
        fake = fake.float().permute(0, 2, 3, 4, 1).cpu().numpy()
        for j in range(fake.shape[0]):
            m = gen_metrics.volume_metrics(fake[j], b["B"][j],
                                           mask=b["mask"][j])
            rows.append({"volume": i * batch_size + j, **m})
    gen_metrics.write_metrics_csv(rows, out_csv)
    return rows


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    cfg.run.name = cfg.run.name or "pix2pix-3d"
    train(cfg)


if __name__ == "__main__":
    main()
