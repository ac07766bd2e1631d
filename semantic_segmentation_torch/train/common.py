"""Shared entry-point plumbing — the port of
``semantic_segmentation_tpu/train/common.py``: dataset assembly and split
policy, the segmentation problem as the entries build it, the pretrained
start (``run.seg_pretrained``) and resolving trained weights onto it, and
the autocast context of ``model.compute_dtype``."""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch

from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import Config
from semantic_segmentation_torch.data.folder import make_dataset
from semantic_segmentation_torch.data.pipeline import (stack_dataset,
                                                       subset_split)
from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
from semantic_segmentation_torch.models.seg import SWIN_NAMES, SegProblem
from semantic_segmentation_torch.utils.torch_port import (
    is_milesial, load_milesial, load_state_dict, overlay, port_seg_checkpoint)

log = logging.getLogger(__name__)


def load_splits(cfg: Config):
    """Stacked NHWC numpy splits: train/val/test, and ``ood``, a list of
    (name, split) for ``data.ood_roots``.

    Split policy matches train_end2end_jsrt.py:82-89: first n_train, next
    n_val, last n_test of the deterministic id ordering. An OOD root is
    ``path``, ``name:path`` or ``name:path:mask_suffix``; it loads at its
    family's own size, whatever ``data.image_size`` is (the JAX package's
    call)."""
    d = cfg.data
    if d.synthetic:
        n = d.n_train + d.n_val + max(d.n_test, 4)
        ds = SyntheticSegDataset(n=n, size=d.image_size,
                                 channels=cfg.model.input_nc, seed=cfg.run.seed)
    else:
        ds = make_dataset(d.dataset, d.dataroot, d.mask_suffix,
                          image_size=d.image_size)
    tr, va, te = subset_split(len(ds), d.n_train, d.n_val, d.n_test)
    splits = {
        "train": stack_dataset(ds, tr),
        "val": stack_dataset(ds, va),
        "test": stack_dataset(ds, te) if te else None,
    }
    oods = []
    for root in d.ood_roots:
        name, path, *suffix = (root.split(":") if ":" in root
                               else (d.dataset, root))
        ood_ds = make_dataset(name, path, suffix[0] if suffix else "")
        oods.append((name, stack_dataset(ood_ds)))
    splits["ood"] = oods
    return splits


def as_float_images(batch: dict) -> dict:
    return {k: v.astype(np.float32) if k.startswith("image") else v
            for k, v in batch.items()}


def seg_model_kwargs(cfg: Config) -> dict:
    """Per-backbone construction kwargs from the config: the U-Net's width
    and ups (--bilinear, base_features), the Swin-UNet's stochastic depth,
    recompute and input size (DROP_PATH_RATE yaml:4, --use-checkpoint
    train_options.py:87); the DeepLabs take their defaults."""
    m = cfg.model
    if m.seg_model == "unet":
        return {"bilinear": m.bilinear, "base_features": m.base_features}
    if m.seg_model in SWIN_NAMES:
        return {"drop_path_rate": m.drop_path_rate,
                "use_checkpoint": m.use_checkpoint,
                "img_size": cfg.data.image_size}
    return {}


def seg_metric(cfg: Config) -> str:
    """The evaluation metric of the dataset's family: the ISIC scripts score
    Jaccard (test_isic.py:56-84), the JSRT family Dice."""
    return "jaccard" if cfg.data.dataset.startswith("isic") else "dice"


def build_seg_problem(cfg: Config, device) -> SegProblem:
    """The seg net as train_unet, test_seg and export_seg build it
    (backbone, width, classes, ``optim.accumulate`` from the config), its
    weights drawn from a CPU generator seeded with ``run.seed``, on
    ``device``, started from ``run.seg_pretrained`` when it is set."""
    m = cfg.model
    seg = SegProblem(m.seg_model, m.output_nc, m.classes,
                     lr=cfg.optim.unet_lr, device=device,
                     generator=torch.Generator().manual_seed(cfg.run.seed),
                     accumulate=cfg.optim.accumulate,
                     **seg_model_kwargs(cfg))
    apply_seg_pretrained(cfg, seg.net)
    return seg


def apply_seg_pretrained(cfg: Config, net: torch.nn.Module):
    """``run.seg_pretrained``: overlay a reference torch checkpoint, mapped
    onto the port's names (``utils/torch_port``), on the fresh init in
    place (JAX ``train/common.py:64-77``). A partial one (an ImageNet
    resnet50: the backbone) keeps the fresh init elsewhere."""
    if cfg.run.seg_pretrained:
        overlay(net, port_seg_checkpoint(
            cfg.model.seg_model, load_state_dict(cfg.run.seg_pretrained),
            cfg.model.classes))
        log.info("seg net started from %s", cfg.run.seg_pretrained)
    return net


def _unet_state_from_checkpoint(state: dict) -> dict:
    """The U-Net ``state_dict`` of a checkpoint tree: the best U-Net of the
    engine layout (``train_end2end``: its ``host`` part), or the net of the
    supervised layout (``train_unet``)."""
    if "host" in state:
        return state["host"]["best_unet"]
    if "unet" in state:
        return state["unet"]
    raise ValueError(f"not a trainer checkpoint: keys {sorted(state)}")


def load_seg_state(cfg: Config, net: torch.nn.Module, model_file: str = ""):
    """Load trained weights into ``net`` in place: an explicit file (the
    port's ``.pt`` ``state_dict``, e.g. ``unet_best.pt``, of any
    segmenter, or for ``unet`` a reference milesial ``state_dict``
    ``.pkl``/``.pth``, mapped on the fly — test_lung.py:67's opt.model_dir
    analogue), else the run's best checkpoint in ``<save_dir>/<name>/ckpt``
    (engine or supervised layout).

    Returns ``(net, loaded)``: ``loaded`` is False when nothing resolved and
    ``net`` keeps its fresh init. A failed lookup creates no directory."""
    if model_file:
        if model_file.endswith(".msgpack"):
            raise NotImplementedError(
                "loading the JAX package's .msgpack checkpoints comes with "
                "ROADMAP.md section 1 item 4")
        if not model_file.endswith((".pt", ".pth", ".pkl")):
            raise ValueError(f"model_file {model_file!r}: expected a .pt, "
                             ".pth or .pkl state_dict")
        sd = load_state_dict(model_file)
        if cfg.model.seg_model == "unet" and is_milesial(sd):
            load_milesial(net, sd)
        else:
            net.load_state_dict(sd)
        return net, True
    ckpt_dir = os.path.join(cfg.run.save_dir, cfg.run.name, "ckpt")
    if not os.path.isdir(ckpt_dir):
        return net, False
    mgr = CheckpointManager(ckpt_dir)
    state, step = mgr.restore(None, mgr.best_step())
    if state is None:
        return net, False
    net.load_state_dict(_unet_state_from_checkpoint(state))
    log.info("loaded the segmenter of %s step %d", ckpt_dir, step)
    return net, True


def autocast_for(cfg: Config, device: torch.device):
    """``model.compute_dtype=bfloat16`` -> torch.autocast in bf16 (params
    and BN statistics stay float32, as in the JAX package)."""
    if cfg.model.compute_dtype == "bfloat16":
        return lambda: torch.autocast(device.type, dtype=torch.bfloat16)
    if cfg.model.compute_dtype != "float32":
        raise ValueError(f"compute_dtype {cfg.model.compute_dtype!r}")
    return contextlib.nullcontext
