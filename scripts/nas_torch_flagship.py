"""The live architecture search at the flagship's regime on the card — the
port of ``scripts/nas_flagship_tpu.py``.

The reference's wiring never moves its architecture tables (the ``darts``
hypergradient is structurally zero: the outer loss reads only the U-Net and
the fakes are detached). The ``end2end_nas`` preset is what the reference
meant: the exact unrolled hypergradient (``unroll``) through the generator,
with live fakes and the differentiable ``minmax`` post-process, into the
mixed up-convs' table (reference ``models_pix2pix/networks.py:476-484``).

Two runs of the port's ``train_end2end.train`` at 256^2, batch 2,
``unet_256``, ngf = ndf = 64, U-Net base 64, bf16, on synthetic JSRT-shaped
data (7 train, 2 val, 8 test), validated every 25 iterations: the live
search, and the same configuration with ``hypergrad=none`` (the tables
never move). The record: the genotype (the argmax of each ``upconv`` row
over the k4/k6/k8 candidates), the live and frozen largest |arch|, the
search's trajectory of the largest |arch| from its ``metrics.jsonl``
(``arch_upconv``), its ``arch_grad_norm``, both runs' Dice and seconds.

Usage: ``NAS_ITERS=2000 [NAS_ARCH_LR=...] python3
scripts/nas_torch_flagship.py [--out FILE] [--device cpu]`` (extra
``--a.b=c`` options go to both runs). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semantic_segmentation_torch import kernels  # noqa: E402
from semantic_segmentation_torch.core.config import parse_config  # noqa: E402
from semantic_segmentation_torch.train.train_end2end import train  # noqa: E402

KERNELS = (4, 6, 8)   # the candidates' taps, in the arch table's column
                      # order (architecture_pix2pix/operations.py:4-87)
SAVE_DIR = os.path.join(ROOT, "build", "nas_torch")
ARGV = ["--data.synthetic=true", "--data.image_size=256",
        "--data.n_train=7", "--data.n_val=2", "--data.n_test=8",
        "--engine.valid_step=25", "--run.final_checkpoint=false"]


def softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def run(tag: str, hypergrad: str, iters: int, device: str, argv=(),
        save_dir: str = SAVE_DIR):
    """One run of the ``end2end_nas`` preset under ``hypergrad``. Returns
    (cfg, results with 'wall_s' and 'launches', arch tables as numpy)."""
    cfg = parse_config(ARGV + [f"--engine.hypergrad={hypergrad}",
                               f"--run.save_dir={save_dir}",
                               f"--run.name=nas-flagship-{tag}",
                               f"--run.device={device}", *argv],
                       preset="end2end_nas")
    # the reference's arch_lr (1e-6) barely moves the tables in 5,000
    # iterations even under a live hypergradient; NAS_ARCH_LR lets the
    # demonstration show the search's movement
    cfg.optim.arch_lr = float(os.environ.get("NAS_ARCH_LR",
                                             cfg.optim.arch_lr))
    # a fresh run directory: metrics.jsonl is appended to
    shutil.rmtree(os.path.join(save_dir, cfg.run.name), ignore_errors=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train(cfg, train_iters=iters, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    results["wall_s"] = time.perf_counter() - t0
    results["launches"] = dict(kernels.LAUNCHES)
    arch = {k: v.detach().cpu().numpy() for k, v in engine.arch.items()}
    del engine
    return cfg, results, arch


def read_metrics(path: str):
    """(step, largest |arch_upconv|) and the ``arch_grad_norm`` values of a
    run's ``metrics.jsonl``."""
    traj, norms = [], []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            if "arch_upconv" in d:
                traj.append([d.get("step"), float(np.abs(np.asarray(
                    d["arch_upconv"])).max())])
            if "arch_grad_norm" in d:
                norms.append(float(d["arch_grad_norm"]))
    return traj, norms


def nas_flagship(iters: int, device: str = "cuda", argv=(),
                 save_dir: str = SAVE_DIR) -> dict:
    """Both runs and the record."""
    cfg, res_nas, arch_nas = run("live", "unroll", iters, device, argv,
                                 save_dir)
    _, res_ctl, arch_ctl = run("frozen", "none", iters, device, argv,
                               save_dir)
    table = arch_nas["upconv"]
    w = softmax(table)
    traj, norms = read_metrics(os.path.join(save_dir, "nas-flagship-live",
                                            "metrics.jsonl"))
    return {
        "summary": "nas_torch_flagship", "iters": iters,
        "arch_lr": cfg.optim.arch_lr,
        "config": {"image_size": cfg.data.image_size,
                   "batch_size": cfg.data.batch_size,
                   "netG": cfg.model.netG, "ngf": cfg.model.ngf,
                   "base_features": cfg.model.base_features,
                   "compute_dtype": cfg.model.compute_dtype,
                   "valid_step": cfg.engine.valid_step},
        "genotype_upconv": [f"re_conv_{KERNELS[int(i)]}"
                            for i in np.argmax(w, axis=-1)],
        "arch_abs_max_final": float(np.abs(table).max()),
        "arch_abs_max_frozen_control": float(np.abs(arch_ctl["upconv"])
                                             .max()),
        "arch_max_moved_vs_frozen": float(np.abs(table - arch_ctl["upconv"])
                                          .max()),
        "arch_abs_max_trajectory": traj,
        "arch_grad_norm_mean": float(np.mean(norms)) if norms else None,
        "arch_grad_norm_max": float(np.max(norms)) if norms else None,
        "softmax_rows": np.round(w, 4).tolist(),
        "best_val_nas": res_nas["best_val"],
        "test_dice_nas": res_nas.get("test_dice"),
        "best_val_frozen": res_ctl["best_val"],
        "test_dice_frozen": res_ctl.get("test_dice"),
        "wall_s": {"nas": res_nas["wall_s"], "frozen": res_ctl["wall_s"]},
        "launches": {"nas": res_nas["launches"],
                     "frozen": res_ctl["launches"]},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the record to this file")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    iters = int(os.environ.get("NAS_ITERS", "2000"))
    rec = nas_flagship(iters, args.device, rest)
    if args.device != "cpu":
        from semantic_segmentation_torch.bench.timing import card_line
        rec["card"] = card_line()
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
