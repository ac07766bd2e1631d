"""Serving-export entry: freeze a trained segmenter into one
``torch.export`` artifact (program and weights, symbolic batch) — the port
of ``semantic_segmentation_tpu/train/export_seg.py`` (``core/export.py``).
The reference deploys by re-running the torch module over the saved .pth
(``running_files/test_lung.py:64-74``); here the deployable is one file a
serving process loads with ``torch.export.load`` and calls with no model
code.

Usage:
  python -m semantic_segmentation_torch.train.export_seg \\
      --run.name=end2end-JSRT-9-unet [--model.seg_model=deeplab] \\
      [--run.export_path=serving/unet_jsrt.pt2] \\
      [--run.model_file=<.pt|milesial .pkl/.pth>] \\
      [--run.export_platforms=cpu,cuda] [--run.export_batch=0]

``run.export_platforms`` names the devices (``cpu``, ``cuda``) to export
for, one artifact each: with one (by default ``run.device``) the file is
``run.export_path`` (default ``<save_dir>/<name>/serving.pt2``); with
several, each file carries its device before the suffix
(``serving.cuda.pt2``).
"""

from __future__ import annotations

import os

import torch

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.export import export_seg
from semantic_segmentation_torch.train.common import (build_seg_problem,
                                                      load_seg_state)

PLATFORMS = ("cpu", "cuda")


def _platforms(cfg: Config) -> list[str]:
    names = [p for p in cfg.run.export_platforms.split(",") if p] or \
        [torch.device(cfg.run.device).type]
    for p in names:
        if p not in PLATFORMS:
            raise ValueError(f"export platform {p!r}: the port exports for "
                             f"{PLATFORMS} (it has no TPU)")
    return names


def run(cfg: Config) -> dict:
    """Export the weights ``load_seg_state`` resolves (``run.model_file``,
    else the run's best checkpoint; ``run.seg_pretrained`` also counts).
    Returns {platform: artifact path}."""
    platforms = _platforms(cfg)
    seg = build_seg_problem(cfg, "cpu")
    _, loaded = load_seg_state(cfg, seg.net, cfg.run.model_file)
    if not (loaded or cfg.run.seg_pretrained or cfg.run.export_allow_fresh):
        raise FileNotFoundError(
            f"export_seg: no trained weights resolved for "
            f"run.name={cfg.run.name!r} / run.model_file="
            f"{cfg.run.model_file!r} — refusing to serialize a random init "
            f"into a serving artifact. Pass --run.export_allow_fresh=true "
            f"to override deliberately.")
    path = cfg.run.export_path or os.path.join(
        cfg.run.save_dir, cfg.run.name, "serving.pt2")
    paths = {}
    for p in platforms:
        out = path if len(platforms) == 1 else \
            "{0}.{2}{1}".format(*os.path.splitext(path), p)
        net = seg.net.to(resolve_device(p))
        program = export_seg(net, cfg.model.classes, cfg.data.image_size,
                             cfg.model.output_nc, cfg.run.export_batch,
                             cfg.model.compute_dtype)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        torch.export.save(program, out)
        batch = cfg.run.export_batch or "symbolic"
        print(f"exported {cfg.model.seg_model} ({cfg.data.image_size}^2, "
              f"batch={batch}, {cfg.model.compute_dtype}, {p}) -> {out} "
              f"({os.path.getsize(out) / 1e6:.1f} MB)")
        paths[p] = out
    return paths


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()
