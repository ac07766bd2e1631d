"""Stage-1 Pix2Pix pre-training — the port of
``semantic_segmentation_tpu/train/train_pix2pix.py``
(``running_files/train_pix2pix_lung.py:30-104``): the epoch loop of
``train_step`` (D then G), the learning-rate policy set at the start of
every epoch, losses logged every ``run.log_every`` steps to the metric
stream ``<save_dir>/<name>/metrics.jsonl``, and the G/D/arch checkpoint that
``train_end2end --run.pretrained_pix2pix=<dir>`` loads.

Not ported yet: the sample-grid panels (they need ``utils/visuals.py``), the
colorization branch and loading the upstream ``.pkl`` or the JAX package's
``.msgpack`` checkpoints.

Usage: ``python -m semantic_segmentation_torch.train.train_pix2pix
--preset=pix2pix_jsrt --data.synthetic=true [--run.device=cpu]``.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import (lr_schedule,
                                                    set_learning_rate)
from semantic_segmentation_torch.data.pipeline import batch_iterator
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.train.common import autocast_for, load_splits

GENERATOR_FILE = "pix2pix_generator.pt"
DISCRIMINATOR_FILE = "pix2pix_discriminator.pt"


def build_pix2pix(cfg: Config, device, generator: torch.Generator | None =
                  None) -> Pix2Pix:
    """The Pix2Pix of ``cfg`` on ``device``, its weights drawn from
    ``generator`` (G, then D, then the arch tables)."""
    m = cfg.model
    if m.norm != "batch":
        raise NotImplementedError(f"norm={m.norm!r} is not ported yet")
    device = torch.device(device)
    return Pix2Pix(m.input_nc, m.output_nc, m.ngf, m.ndf, m.netG, m.netD,
                   use_dropout=not m.no_dropout, gan_mode=cfg.optim.gan_mode,
                   lambda_L1=cfg.optim.lambda_L1, lr=cfg.optim.lr,
                   beta1=cfg.optim.beta1, arch_lr=cfg.optim.arch_lr,
                   amp=autocast_for(cfg, device), device=device,
                   generator=generator)


def train(cfg: Config, train_iters: int | None = None, device=None):
    """Train ``cfg`` on ``device`` (default ``cfg.run.device``, 'cuda') for
    ``train_iters`` steps (default ``engine.train_iters``) and save the
    checkpoint. Returns (model, results); ``results['log']`` has one record
    per ``log_every`` steps: steps and wall seconds since the last record
    (ending in a device sync) and the losses."""
    dev = resolve_device(device or cfg.run.device)
    model = build_pix2pix(cfg, dev, torch.Generator().manual_seed(cfg.run.seed))
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    draw_gen = torch.Generator(device=dev).manual_seed(cfg.run.seed + 1)
    o = cfg.optim
    # update_learning_rate() at the start of every epoch; torch's LambdaLR
    # has stepped epoch + 1 times when the epoch's batches run
    sched = (None if o.lr_policy == "plateau" else
             lr_schedule(o.lr_policy, o.lr, o.n_epochs,
                         epoch_count=o.epoch_count,
                         n_epochs_decay=o.n_epochs_decay,
                         lr_decay_iters=o.lr_decay_iters))
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        step, epoch, records = 0, 0, []
        max_iters = train_iters or cfg.engine.train_iters
        last_step, t0 = 0, time.perf_counter()
        while step < max_iters:
            if sched is not None:
                lr_now = sched(epoch + 1)
                set_learning_rate(model.opt_g, lr_now)
                set_learning_rate(model.opt_d, lr_now)
            rng_np = np.random.default_rng((cfg.run.seed, epoch))
            for batch in batch_iterator(splits["train"], cfg.data.batch_size,
                                        rng_np):
                metrics = model.train_step(
                    {k: torch.from_numpy(batch[k]).to(dev)
                     for k in ("mask_pix2pix", "image_pix2pix")},
                    generator=draw_gen)
                step += 1
                if step % cfg.run.log_every == 0:
                    rec = {"step": step, **{k: float(v)
                                            for k, v in metrics.items()}}
                    rec.update(steps=step - last_step,
                               seconds=time.perf_counter() - t0)
                    records.append(rec)
                    log.info("step %d: %s", step, rec)
                    log.log(metrics, step)
                    last_step, t0 = step, time.perf_counter()
                if step >= max_iters:
                    break
            epoch += 1
            if cfg.run.save_every and epoch % cfg.run.save_every == 0:
                save_model(model, save_dir)
        save_model(model, save_dir)
    return model, {"steps": step, "epochs": epoch, "log": records}


def save_model(model: Pix2Pix, save_dir: str):
    """``torch.save`` of G (parameters and BN stats) with the arch tables,
    and of D, as ``pix2pix_generator.pt``/``pix2pix_discriminator.pt`` —
    the ``.pkl`` pair of ``pix2pix_model.py:168-173``."""
    os.makedirs(save_dir, exist_ok=True)
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    torch.save({"G": cpu(model.G.state_dict()), "arch": cpu(model.arch)},
               os.path.join(save_dir, GENERATOR_FILE))
    torch.save({"D": cpu(model.D.state_dict())},
               os.path.join(save_dir, DISCRIMINATOR_FILE))


def load_model(model: Pix2Pix, save_dir: str) -> Pix2Pix:
    """Load ``save_model``'s files into ``model`` in place (strict), so
    optimizers over its tensors keep pointing at the loaded values."""
    dev = next(model.G.parameters()).device
    g = torch.load(os.path.join(save_dir, GENERATOR_FILE), map_location=dev,
                   weights_only=True)
    d = torch.load(os.path.join(save_dir, DISCRIMINATOR_FILE),
                   map_location=dev, weights_only=True)
    model.G.load_state_dict(g["G"])
    model.D.load_state_dict(d["D"])
    if g["arch"].keys() != model.arch.keys():
        raise ValueError(f"arch tables {sorted(g['arch'])} in {save_dir}, "
                         f"expected {sorted(model.arch)}")
    with torch.no_grad():
        for k, v in model.arch.items():
            v.copy_(g["arch"][k])
    return model


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv, preset="pix2pix_jsrt")
    train(cfg)


if __name__ == "__main__":
    main()
