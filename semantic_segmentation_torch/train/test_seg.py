"""Inference/eval entry — the port of
``semantic_segmentation_tpu/train/test_seg.py`` (parity with
``running_files/test_lung.py:36-74`` and test_isic.py): load a trained
segmentation checkpoint and report its mean score on the in-domain test
split and on each OOD set; Dice for the JSRT family, Jaccard for ISIC.

Usage: ``python -m semantic_segmentation_torch.train.test_seg
--data.dataroot=<JSRT dir> --run.name=end2end-JSRT-9-unet
--data.ood_roots=nlm:<dir>,sz:<dir>:_mask [--run.model_file=<file>]
[--run.device=cpu]``.
"""

from __future__ import annotations

import logging
import os

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.train.common import (autocast_for,
                                                      build_seg_problem,
                                                      load_seg_state,
                                                      load_splits, seg_metric)
from semantic_segmentation_torch.train.train_unet import evaluate_split


def run(cfg: Config, model_file: str = "", device=None) -> dict:
    """Scores of the weights ``load_seg_state`` resolves (``model_file``,
    else the run's best checkpoint); with none it warns and scores the
    fresh init, as the JAX entry does. Appends the results to the run's
    ``metrics.jsonl``."""
    dev = resolve_device(device or cfg.run.device)
    seg = build_seg_problem(cfg, dev)
    _, loaded = load_seg_state(cfg, seg.net, model_file)
    if not loaded:
        print(f"test_seg: WARNING — no checkpoint resolved for "
              f"run.name={cfg.run.name!r}; evaluating the fresh init")
    splits = load_splits(cfg)
    amp = autocast_for(cfg, dev)
    metric = seg_metric(cfg)
    bs, classes = cfg.data.batch_size, cfg.model.classes
    results = {}
    if splits["test"] is not None:
        results[f"test_{metric}"] = evaluate_split(
            seg.net, splits["test"], bs, classes, metric, amp)
    for name, data in splits["ood"]:
        results[f"ood_{name}"] = evaluate_split(seg.net, data, bs, classes,
                                                metric, amp)
    with MetricsLogger(os.path.join(cfg.run.save_dir, cfg.run.name)) as log:
        for k, v in results.items():
            log.info("%s: %.5f", k, v)
        log.log(results)
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    run(cfg, model_file=cfg.run.model_file)


if __name__ == "__main__":
    main()
