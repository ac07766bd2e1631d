"""Stage-1 Pix2Pix pre-training — the port of
``semantic_segmentation_tpu/train/train_pix2pix.py``
(``running_files/train_pix2pix_lung.py:30-104``): the epoch loop of
``train_step`` (D then G), the learning-rate policy set at the start of
every epoch, losses logged every ``run.log_every`` steps to the metric
stream ``<save_dir>/<name>/metrics.jsonl``, and the G/D/arch checkpoint that
``train_end2end --run.pretrained_pix2pix=<dir>`` loads; every
``run.log_every`` steps a mask / fake / real sample grid
``<save_dir>/<name>/samples/step<n>.png`` (the display_freq visuals of
``train_pix2pix_lung.py:83-91``), under colorization (``output_nc`` 2,
``--preset=pix2pix_colorization``) the L / real RGB / fake RGB grid through
``lab_to_rgb`` (``colorization_model.py:46-68``).

``load_model`` reads the port's own ``.pt`` pair, else the JAX package's
``.msgpack`` pair (``utils/serialization.py``, through the weight bridge),
else the reference's ``.pkl`` pair (``utils/torch_port.py``'s key maps;
the arch tables keep their values, the reference keeps them in module
globals, not in the file).

Usage: ``python -m semantic_segmentation_torch.train.train_pix2pix
--preset=pix2pix_jsrt --data.synthetic=true [--run.device=cpu]``
(``--preset=pix2pix_colorization --data.dataroot=<image dir>``,
``--optim.gan_mode=wgangp``).
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
from semantic_segmentation_torch.data.extra import lab_to_rgb
from semantic_segmentation_torch.data.pipeline import batch_iterator
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.train.common import autocast_for, load_splits
from semantic_segmentation_torch.utils import bridge, serialization
from semantic_segmentation_torch.utils.torch_port import (
    load_state_dict, port_pix2pix_discriminator, port_pix2pix_generator)
from semantic_segmentation_torch.utils.visuals import save_image_grid

GENERATOR_FILE = "pix2pix_generator.pt"
DISCRIMINATOR_FILE = "pix2pix_discriminator.pt"
# the JAX package's pair, and the reference's
JAX_FILES = ("pix2pix_generator.msgpack", "pix2pix_discriminator.msgpack")
PKL_FILES = ("pix2pix_generator.pkl", "pix2pix_discriminator.pkl")


def build_pix2pix(cfg: Config, device, generator: torch.Generator | None =
                  None) -> Pix2Pix:
    """The Pix2Pix of ``cfg`` on ``device``, its weights drawn from
    ``generator`` (G, then D, then the arch tables, then the
    ``model.init_type`` re-draw of G and D)."""
    m = cfg.model
    device = torch.device(device)
    return Pix2Pix(m.input_nc, m.output_nc, m.ngf, m.ndf, m.netG, m.netD,
                   m.n_layers_D, use_dropout=not m.no_dropout,
                   gan_mode=cfg.optim.gan_mode,
                   lambda_L1=cfg.optim.lambda_L1, lr=cfg.optim.lr,
                   beta1=cfg.optim.beta1, arch_lr=cfg.optim.arch_lr,
                   amp=autocast_for(cfg, device), device=device,
                   generator=generator, norm=m.norm, init_type=m.init_type,
                   init_gain=m.init_gain)


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
                    fake = model.generate(torch.from_numpy(
                        batch["mask_pix2pix"][:1]).to(dev)).cpu().numpy()
                    save_image_grid(
                        sample_panel(batch["mask_pix2pix"][0], fake[0],
                                     batch["image_pix2pix"][0],
                                     cfg.model.output_nc),
                        os.path.join(save_dir, "samples", f"step{step}.png"),
                        cols=3)
                    last_step, t0 = step, time.perf_counter()
                if step >= max_iters:
                    break
            epoch += 1
            if cfg.run.save_every and epoch % cfg.run.save_every == 0:
                save_model(model, save_dir)
        save_model(model, save_dir)
    return model, {"steps": step, "epochs": epoch, "log": records}


def sample_panel(mask, fake, image, output_nc: int) -> list:
    """The three HWC float32 panels of a sample grid: mask, fake, real; for
    colorization (``output_nc`` 2) the L channel as gray RGB, the real and
    the fake (clipped to [0, 1]) ab rendered with it through
    ``lab_to_rgb``."""
    if output_nc == 2:
        L = np.asarray(mask, np.float32)
        real_rgb = lab_to_rgb(np.concatenate([L, image], axis=-1))
        fake_rgb = lab_to_rgb(np.concatenate(
            [L, np.clip(np.asarray(fake, np.float32), 0, 1)], axis=-1))
        return [np.repeat(L, 3, axis=-1), real_rgb.astype(np.float32),
                fake_rgb.astype(np.float32)]
    return [np.asarray(mask, np.float32), np.asarray(fake), image]


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


def _set_arch(model: Pix2Pix, arch: dict, source: str):
    if arch.keys() != model.arch.keys():
        raise ValueError(f"arch tables {sorted(arch)} in {source}, "
                         f"expected {sorted(model.arch)}")
    with torch.no_grad():
        for k, v in model.arch.items():
            v.copy_(arch[k])


def load_model(model: Pix2Pix, save_dir: str) -> Pix2Pix:
    """Load a stage-1 checkpoint pair from ``save_dir`` into ``model`` in
    place (strict), so optimizers over its tensors keep pointing at the
    loaded values: the port's ``.pt`` files (``save_model``), else the JAX
    package's ``.msgpack`` files, else the reference's ``.pkl`` files."""
    dev = next(model.G.parameters()).device
    path = lambda f: os.path.join(save_dir, f)  # noqa: E731
    if os.path.exists(path(GENERATOR_FILE)):
        g = torch.load(path(GENERATOR_FILE), map_location=dev,
                       weights_only=True)
        d = torch.load(path(DISCRIMINATOR_FILE), map_location=dev,
                       weights_only=True)
        model.G.load_state_dict(g["G"])
        model.D.load_state_dict(d["D"])
        _set_arch(model, g["arch"], save_dir)
    elif os.path.exists(path(JAX_FILES[0])):
        g = serialization.to_numpy_tree(
            serialization.load_pytree(path(JAX_FILES[0])))
        d = serialization.to_numpy_tree(
            serialization.load_pytree(path(JAX_FILES[1])))
        bridge.load_flax(model.G, g["g_params"], g["g_stats"])
        bridge.load_flax(model.D, d["d_params"], d["d_stats"])
        _set_arch(model, bridge.arch_to_torch(g["arch"], dev), save_dir)
    elif os.path.exists(path(PKL_FILES[0])):
        _load_torch_pkl(model, save_dir)
    else:
        raise FileNotFoundError(
            f"no stage-1 checkpoint in {save_dir}: expected "
            f"{GENERATOR_FILE}, {JAX_FILES[0]} or {PKL_FILES[0]}")
    return model


def _load_torch_pkl(model: Pix2Pix, save_dir: str):
    """The reference's network ``state_dict``s (``pix2pix_model.py:
    168-173``, DataParallel-wrapped), mapped onto the port's names; the
    arch tables keep their values (the reference's live in module-level
    globals, ``networks.py:476-484``, not in the files)."""
    if not hasattr(model.G, "num_downs"):
        raise NotImplementedError(
            "the reference's .pkl maps the U-Net generator only "
            f"(netG is {type(model.G).__name__})")
    g = port_pix2pix_generator(
        load_state_dict(os.path.join(save_dir, PKL_FILES[0])),
        num_downs=model.G.num_downs)
    d = port_pix2pix_discriminator(
        load_state_dict(os.path.join(save_dir, PKL_FILES[1])),
        n_layers=model.D.n_layers)
    model.G.load_state_dict(g)
    model.D.load_state_dict(d)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv, preset="pix2pix_jsrt")
    train(cfg)


if __name__ == "__main__":
    main()
