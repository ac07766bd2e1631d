"""Chaos control of the port's long-horizon trajectory — the port of
``scripts/drift_chaos_control.py``.

The JAX script asks whether a final-Dice gap between two implementations
at the reference's horizon (5,000 iterations) says anything, by running one
implementation twice: bit-identical but for the initial weights of one run,
multiplied by (1 + 1e-7), about one float32 ulp. This script does the same
with the port's ``BilevelEngine``:

- both runs start from the port's own init at one seed (``build_engine``),
  see the same numpy-seeded batches (the JAX script's noise pairs: masks
  ``random > 0.6``, images uniform) and draw the same augment affines from
  their engines' explicitly seeded generators;
- the perturbed run multiplies every parameter of G and D and the U-Net's
  whole state (parameters and BN statistics) by (1 + 1e-7), the JAX
  scripts' law; the arch tables are not moved;
- each run's U-Net is scored on a numpy-seeded held-out set every 1,000
  iterations and at the end; the record gives each run's final Dice, the
  gaps at each of those points and the largest 25-iteration windowed
  relative gap of the U-Net loss.

Two modes:

- card (the default, ``--device cuda``): the ``end2end_jsrt`` preset at full
  width (256^2, batch 2, ``unet_256``, ngf = ndf = 64, U-Net base 64, bf16
  autocast, ``decay_only``, the ``uint8_chain`` post-process with its
  equalize kernel, the warp kernel) for N iterations (default 1,000), with a
  third run, the base repeated with no perturbation: the card need not be
  deterministic (a backward pass that adds atomically parts two identical
  runs), so the repeat measures the card's run-to-run spread beside the
  1-ulp chaos.
- CPU (``--device cpu``): the JAX script's configuration (32^2, ``unet_32``,
  ngf = ndf = U-Net base 8, float32, ``minmax``, ``decay_only``, no dropout),
  one torch thread, 5,000 iterations by default, base and 1-ulp runs; its
  record has the JAX script's fields.

Usage:
  python3 scripts/drift_torch_chaos_control.py [N_STEPS] [--device cpu]
      [--seed S] [--out FILE]
Prints one JSON line (and writes it to FILE with ``--out``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semantic_segmentation_torch.core.config import (  # noqa: E402
    parse_config, resolve_device)

ULP = 1e-7
WINDOW = 25
EVERY = 1000
# tests/test_torch_long_drift.py's ARGV (the JAX script's tiny_cfg with its
# overrides): a script without JAX cannot import that test
CPU_ARGV = ["--data.synthetic=true", "--data.image_size=32",
            "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
            "--model.compute_dtype=float32", "--model.netG=unet_32",
            "--model.ngf=8", "--model.ndf=8", "--model.base_features=8",
            "--model.no_dropout=true", "--engine.fake_postprocess=minmax",
            "--engine.hypergrad=decay_only", "--run.device=cpu"]
CARD_ARGV = ["--data.synthetic=true", "--run.device=cuda"]


def config(device: str, seed: int = 0):
    """The mode's configuration: CPU_ARGV on the CPU, else the full-width
    ``end2end_jsrt`` preset."""
    argv = CPU_ARGV if device == "cpu" else CARD_ARGV
    return parse_config(argv + [f"--run.seed={seed}"], preset="end2end_jsrt")


@torch.no_grad()
def scale_state(engine, eps: float):
    """The JAX drift scripts' perturbation, in place: every parameter of G
    and D, and the U-Net's whole floating state (parameters and BN
    statistics), times (1 + eps)."""
    if not eps:
        return
    for p in engine.problems:
        if p.name == "unet":
            tensors = [v for v in p.module.state_dict().values()
                       if v.is_floating_point()]
        else:
            tensors = list(p.module.parameters())
        for t in tensors:
            t.mul_(1.0 + eps)


def noise_pair(rng: np.random.Generator, batch: int, size: int):
    """The JAX drift scripts' batch: (mask, image), NHWC float32."""
    mask = (rng.random((batch, size, size, 1)) > 0.6).astype(np.float32)
    image = rng.random((batch, size, size, 1)).astype(np.float32)
    return mask, image


def noise_batches(rng: np.random.Generator, batch: int, size: int) -> dict:
    """One engine iteration's batches: a noise pair for each inner problem,
    drawn in the JAX scripts' order (netG, netD, unet)."""
    (mg, ig), (md, idd), (mu, iu) = (noise_pair(rng, batch, size)
                                     for _ in range(3))
    return {"netG": {"mask_pix2pix": mg, "image_pix2pix": ig},
            "netD": {"mask_pix2pix": md, "image_pix2pix": idd},
            "unet": {"image": iu, "mask": mu}}


def held_out(seed: int, size: int, n: int = 8):
    """The held-out set every run is scored on: (images, masks), NHWC."""
    mask, image = noise_pair(np.random.default_rng(12 + seed), n, size)
    return image, mask


@torch.no_grad()
def dice(seg, amp, images, masks) -> float:
    """The U-Net's Dice on NHWC numpy ``images``/``masks``, as the trainer
    scores its validation split."""
    from semantic_segmentation_torch.ops.metrics import eval_batch_score
    dev = next(seg.net.parameters()).device
    x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2)
    y = torch.from_numpy(masks).to(dev).permute(0, 3, 1, 2)
    with amp():
        return float(eval_batch_score(seg.eval_logits(x), y, seg.n_classes,
                                      "dice"))


def run_trajectory(cfg, n_steps: int, eps: float, device) -> dict:
    """One run of the port's engine from its init at ``cfg.run.seed``,
    perturbed by ``eps``: {'losses': {problem: per-iteration list},
    'dice': {iteration: held-out Dice}, 'seconds'}."""
    from semantic_segmentation_torch.train.common import autocast_for
    from semantic_segmentation_torch.train.train_end2end import build_engine
    dev = resolve_device(str(device))
    engine, _, seg = build_engine(cfg, dev)
    scale_state(engine, eps)
    amp = autocast_for(cfg, dev)
    size, batch = cfg.data.image_size, cfg.data.batch_size
    rng = np.random.default_rng(11 + cfg.run.seed)
    test_images, test_masks = held_out(cfg.run.seed, size)
    losses = {k: [] for k in ("netG", "netD", "unet")}
    scores = {}
    t0 = time.perf_counter()
    for step in range(1, n_steps + 1):
        batches = noise_batches(rng, batch, size)
        metrics = engine.engine_step(
            [{n: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for n, b in batches.items()}], None)
        for k in losses:      # kept on the device: no sync an iteration
            losses[k].append(metrics[f"loss_{k}"].detach().float())
        if step % EVERY == 0 or step == n_steps:
            scores[step] = dice(seg, amp, test_images, test_masks)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"losses": {k: torch.stack(v).cpu().tolist()
                       for k, v in losses.items()},
            "dice": scores, "seconds": seconds}


def windowed_rel(a, b, win: int = WINDOW) -> float | None:
    """The largest relative gap of ``win``-iteration means of ``a`` from
    ``b`` (whole windows only); None under one window."""
    n = (min(len(a), len(b)) // win) * win
    if n == 0:
        return None
    aa = np.asarray(a[:n]).reshape(-1, win).mean(axis=1)
    bb = np.asarray(b[:n]).reshape(-1, win).mean(axis=1)
    return float(np.max(np.abs(aa - bb) / np.maximum(np.abs(bb), 1e-6)))


def loss_rel(a: dict, b: dict) -> dict:
    """Per problem, the largest and the last per-iteration relative loss gap
    of run ``a`` from run ``b``."""
    out = {}
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-12)
        out[k] = {"max": float(rel.max()), "last": float(rel[-1])}
    return out


def chaos_control(n_steps: int, device: str = "cuda", seed: int = 0,
                  repeat: bool | None = None) -> dict:
    """The control's record. ``repeat`` (default: on the card) adds the
    unperturbed base again."""
    if device == "cpu":
        torch.set_num_threads(1)
    cfg = config(device, seed)
    repeat = device != "cpu" if repeat is None else repeat
    runs = {"base": 0.0, **({"repeat": 0.0} if repeat else {}), "ulp": ULP}
    out = {name: run_trajectory(cfg, n_steps, eps, device)
           for name, eps in runs.items()}
    base = out["base"]
    d_final = {name: r["dice"][n_steps] for name, r in out.items()}
    gaps = [{"step": s, **{f"{name}_gap_pt": abs(r["dice"][s] -
                                                 base["dice"][s]) * 100
                           for name, r in out.items() if name != "base"}}
            for s in sorted(base["dice"])]
    rec = {
        "n_steps": n_steps, "device": device, "seed": seed,
        "config": {"image_size": cfg.data.image_size,
                   "batch_size": cfg.data.batch_size,
                   "netG": cfg.model.netG, "ngf": cfg.model.ngf,
                   "ndf": cfg.model.ndf,
                   "base_features": cfg.model.base_features,
                   "compute_dtype": cfg.model.compute_dtype,
                   "hypergrad": cfg.engine.hypergrad,
                   "fake_postprocess": cfg.engine.fake_postprocess,
                   "no_dropout": cfg.model.no_dropout},
        "final_dice_base": round(d_final["base"], 4),
        "final_dice_ulp": round(d_final["ulp"], 4),
        "torch_vs_torch_ulp_dice_gap_pt": round(
            abs(d_final["base"] - d_final["ulp"]) * 100, 2),
        "windowed_unet_loss_rel_max": windowed_rel(
            out["ulp"]["losses"]["unet"], base["losses"]["unet"]),
        "perturbation": "G and D parameters, the U-Net's whole state, "
                        f"* (1 + {ULP:g})",
        "gaps_by_step": gaps,
        "loss_rel_ulp": loss_rel(out["ulp"]["losses"], base["losses"]),
        "seconds": {name: r["seconds"] for name, r in out.items()},
    }
    if repeat:
        rec.update({
            "final_dice_repeat": round(d_final["repeat"], 4),
            "run_to_run_dice_gap_pt": round(
                abs(d_final["base"] - d_final["repeat"]) * 100, 2),
            "windowed_unet_loss_rel_max_repeat": windowed_rel(
                out["repeat"]["losses"]["unet"], base["losses"]["unet"]),
            "loss_rel_repeat": loss_rel(out["repeat"]["losses"],
                                        base["losses"]),
        })
    finite = all(math.isfinite(v) for r in out.values()
                 for ls in r["losses"].values() for v in ls)
    rec["losses_finite"] = finite
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_steps", nargs="?", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the record to this file")
    args = ap.parse_args(argv)
    n = args.n_steps or (5000 if args.device == "cpu" else 1000)
    rec = chaos_control(n, args.device, args.seed)
    if args.device == "cuda":
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
