"""Shared entry-point plumbing: dataset assembly and split policy (the port
of ``semantic_segmentation_tpu/train/common.load_splits``, synthetic branch),
and the autocast context of ``model.compute_dtype``."""

from __future__ import annotations

import contextlib

import torch

from semantic_segmentation_torch.core.config import Config
from semantic_segmentation_torch.data.pipeline import (stack_dataset,
                                                       subset_split)
from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset


def load_splits(cfg: Config):
    """Stacked NHWC numpy splits: train/val/test.

    Split policy matches train_end2end_jsrt.py:82-89: first n_train, next
    n_val, last n_test of the deterministic id ordering."""
    d = cfg.data
    if not d.synthetic:
        raise NotImplementedError(
            "the port loads synthetic data only so far "
            "(--data.synthetic=true); the folder datasets come later")
    n = d.n_train + d.n_val + max(d.n_test, 4)
    ds = SyntheticSegDataset(n=n, size=d.image_size,
                             channels=cfg.model.input_nc, seed=cfg.run.seed)
    tr, va, te = subset_split(len(ds), d.n_train, d.n_val, d.n_test)
    return {
        "train": stack_dataset(ds, tr),
        "val": stack_dataset(ds, va),
        "test": stack_dataset(ds, te) if te else None,
    }


def autocast_for(cfg: Config, device: torch.device):
    """``model.compute_dtype=bfloat16`` -> torch.autocast in bf16 (params
    and BN statistics stay float32, as in the JAX package)."""
    if cfg.model.compute_dtype == "bfloat16":
        return lambda: torch.autocast(device.type, dtype=torch.bfloat16)
    if cfg.model.compute_dtype != "float32":
        raise ValueError(f"compute_dtype {cfg.model.compute_dtype!r}")
    return contextlib.nullcontext
