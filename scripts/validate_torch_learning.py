"""Learning validation of the port on the card — the port of
``scripts/validate_learning_tpu.py``: the flagship ``end2end_jsrt`` preset
(``decay_only``, 256^2, batch 2, ``unet_256``, ngf = ndf = 64, U-Net base
64, bf16 autocast) trained from its fresh init on synthetic JSRT-shaped data
(7 train, 2 val, 8 test images), validated every 25 iterations, no final
checkpoint, so that the validation Dice can be seen to climb over the
reference's horizon (5,000 iterations, ``running_files/
train_end2end_jsrt.py:129``).

Usage: ``VALIDATE_ITERS=5000 python3 scripts/validate_torch_learning.py
[--out FILE] [--device cpu] [--equalized] [--a.b=c ...]`` (400 iterations
by default). Prints one JSON line: best and first validation Dice, test
Dice, the validation trajectory, steady it/s, wall seconds, peak device
bytes, the kernels' launches and the card.

``--equalized`` writes the same synthetic split as a JSRT-layout folder of
PNGs and trains from it, so that the segmenter's real images pass the JSRT
loader's equalize and gamma(0.5) (``util/JSRT_loader.py:62``), as the
``uint8_chain`` fakes do; the synthetic arrays themselves skip that chain.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from semantic_segmentation_torch import kernels  # noqa: E402
from semantic_segmentation_torch.core.config import parse_config  # noqa: E402
from semantic_segmentation_torch.train.train_end2end import train  # noqa: E402

SAVE_DIR = os.path.join(ROOT, "build", "validate_torch")
ARGV = ["--data.synthetic=true", "--data.image_size=256",
        "--data.n_train=7", "--data.n_val=2", "--data.n_test=8",
        "--engine.valid_step=25", "--run.final_checkpoint=false",
        "--run.name=validate-e2e"]


def write_jsrt_folder(cfg, root: str) -> str:
    """The synthetic split of ``cfg`` (same seed, size and count) as PNGs in
    ``<root>/Images`` and ``<root>/Masks``, named in split order."""
    import numpy as np
    from PIL import Image

    from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
    d = cfg.data
    n = d.n_train + d.n_val + max(d.n_test, 4)
    ds = SyntheticSegDataset(n=n, size=d.image_size, seed=cfg.run.seed)
    for sub in ("Images", "Masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        item = ds[i]
        for sub, key, scale in (("Images", "image", 255.0),
                                ("Masks", "mask", 255)):
            Image.fromarray((item[key][..., 0] * scale).astype(np.uint8),
                            "L").save(os.path.join(root, sub,
                                                   f"case{i:02d}.png"))
    return root


def validate(iters: int, device: str = "cuda", argv=(),
             save_dir: str = SAVE_DIR, equalized: bool = False) -> dict:
    """Train the preset for ``iters`` iterations on ``device`` (``argv``
    overrides after the script's own options; ``equalized``: from the
    synthetic split written as a JSRT folder) and return the record."""
    cfg = parse_config(ARGV + [f"--run.save_dir={save_dir}",
                               f"--run.device={device}", *argv],
                       preset="end2end_jsrt")
    if equalized:
        cfg.data.dataroot = write_jsrt_folder(
            cfg, os.path.join(save_dir, f"jsrt_{cfg.data.image_size}"))
        cfg.data.synthetic, cfg.data.dataset = False, "jsrt"
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train(cfg, train_iters=iters, device=device)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    chunks = results["chunks"]
    steady = chunks[1:] or chunks
    its = sum(c["iters"] for c in steady) / sum(c["seconds"] for c in steady)
    m = cfg.model
    rec = {
        "summary": "validate_torch_learning", "iters": iters,
        "preset": "end2end_jsrt", "hypergrad": cfg.engine.hypergrad,
        "data": ("synthetic, JSRT folder (equalize, gamma 0.5)"
                 if equalized else "synthetic"),
        "config": {"image_size": cfg.data.image_size,
                   "batch_size": cfg.data.batch_size, "netG": m.netG,
                   "ngf": m.ngf, "ndf": m.ndf,
                   "base_features": m.base_features,
                   "compute_dtype": m.compute_dtype,
                   "n_train": cfg.data.n_train, "n_val": cfg.data.n_val,
                   "n_test": cfg.data.n_test, "seed": cfg.run.seed,
                   "valid_step": cfg.engine.valid_step},
        "best_val": results["best_val"],
        "first_val": chunks[0]["val_score"],
        "test_dice": results.get("test_dice"),
        "val_trajectory": [[c["it"], c["val_score"]] for c in chunks],
        "last_losses": {k: chunks[-1][k] for k in
                        ("loss_netG", "loss_netD", "loss_unet")},
        "losses_finite": all(math.isfinite(c[k]) for c in chunks for k in
                             ("loss_netG", "loss_netD", "loss_unet")),
        "steady_it_per_s": its, "wall_s": wall,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                           else None),
        "launches": launches,
    }
    del engine
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the record to this file")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--equalized", action="store_true",
                    help="train from the synthetic split as a JSRT folder")
    args, rest = ap.parse_known_args(argv)
    iters = int(os.environ.get("VALIDATE_ITERS", "400"))
    rec = validate(iters, args.device, rest, equalized=args.equalized)
    if args.device != "cpu":
        from semantic_segmentation_torch.bench.timing import card_line
        rec["card"] = card_line()
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if rec["losses_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
