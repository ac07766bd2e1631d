"""Can the live search win? — the port of ``scripts/nas_win_tpu.py``, on
the card.

At the flagship's regime the final Dice saturates and the kernel choice is
absorbed by the inner convs' weights, so a searched genotype cannot be seen
to beat a frozen one there. This experiment builds the regime where it can:
a search started from a deliberately bad frozen genotype, few-shot and
short, where the fakes' quality still matters.

- Probe: each of the three pure kernel genotypes frozen (a logit bias of
  +BIAS on its column of the ``upconv`` table, ``hypergrad=none``), seed 0:
  does the kernel matter here, and which is worst and best?
- Arms (SEEDS seeds, paired by seed): from the worst kernel W, (a) frozen
  at W, (b) searched from W (``end2end_nas``'s ``unroll``, arch lr
  ARCH_LR), (c) frozen at the best. The search wins if (b) beats (a) beyond
  the seeds' spread, its tables moving off W.

Each arm is the port's ``train_end2end.train`` of the ``end2end_nas`` preset
at SIZE^2 (``unet_<SIZE>``, ngf = ndf = 64, U-Net base 64, bf16), NTRAIN
train, 2 val and 8 test images, validated every 50 iterations, started
through ``train``'s ``init_state`` from ``build_state``'s fresh state with
BIAS added to the kernel's column and a fresh arch optimizer (the JAX
script's ``opt_arch = engine.arch_tx.init(arch)``). Each arm runs in a child
process of its own (``NASWIN_RUN`` in its environment), one after another,
under the budget, so every arm frees the card before the next starts; the
kernels are built once, before the first child. The output file is
re-written after every arm; a child that fails is recorded with its exit
code and the tail of its errors, and the script then exits non-zero.

Usage: ``python3 scripts/nas_torch_win.py [--device cpu] [OUT.json]``
(default ``NAS_WIN_torch.json``, on ``cuda``). Environment: NASWIN_ITERS
(800), NASWIN_BIAS (2.0), NASWIN_ARCH_LR (5e-3), NASWIN_SEEDS (3),
NASWIN_SIZE (64), NASWIN_NTRAIN (4), NASWIN_BUDGET_SEC (5400).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNELS = (4, 6, 8)   # the arch table's column order
                      # (architecture_pix2pix/operations.py:4-87)

ITERS = int(os.environ.get("NASWIN_ITERS", "800"))
BIAS = float(os.environ.get("NASWIN_BIAS", "2.0"))
ARCH_LR = float(os.environ.get("NASWIN_ARCH_LR", "5e-3"))
N_SEEDS = int(os.environ.get("NASWIN_SEEDS", "3"))
SIZE = int(os.environ.get("NASWIN_SIZE", "64"))
N_TRAIN = int(os.environ.get("NASWIN_NTRAIN", "4"))
SAVE_DIR = os.path.join(ROOT, "build", "nas_torch_win")


def arm_config(spec: dict, device: str = "cuda", argv=(),
               save_dir: str = SAVE_DIR, size: int = SIZE):
    """The ``end2end_nas`` configuration of one arm ({mode: frozen |
    searched, kernel: 4 | 6 | 8, seed})."""
    from semantic_segmentation_torch.core.config import parse_config
    cfg = parse_config([
        "--data.synthetic=true", f"--data.image_size={size}",
        f"--model.netG=unet_{size}", f"--data.n_train={N_TRAIN}",
        "--data.n_val=2", "--data.n_test=8", "--engine.valid_step=50",
        f"--optim.arch_lr={ARCH_LR}", f"--run.seed={spec['seed']}",
        "--run.final_checkpoint=false", f"--run.save_dir={save_dir}",
        f"--run.name={spec['mode']}-k{spec['kernel']}-s{spec['seed']}",
        f"--run.device={device}", *argv], preset="end2end_nas")
    if spec["mode"] == "frozen":
        cfg.engine.hypergrad = "none"          # the tables never move
    return cfg


def biased_state(cfg, kernel: int, device=None):
    """``build_state``'s fresh state with BIAS added to ``kernel``'s
    column of the ``upconv`` table and no arch optimizer state (``train``
    starts a fresh one). The init is 1e-3 randn (networks.py:476-484), so
    +2 fixes the genotype (softmax weight about 0.79) while a search with a
    boosted arch lr can still leave it."""
    from semantic_segmentation_torch.train.train_end2end import build_state
    state = build_state(cfg, device)
    up = state["arch"]["upconv"].clone()
    up[:, KERNELS.index(kernel)] += BIAS
    state["arch"] = {**state["arch"], "upconv": up}
    state["arch_optimizer"] = None
    return state


def run_arm(spec: dict, iters: int = ITERS, device: str = "cuda", argv=(),
            save_dir: str = SAVE_DIR, size: int = SIZE):
    """One arm in this process. Returns (record, biased upconv table, final
    upconv table), the tables on the CPU."""
    import math
    import shutil

    import numpy as np
    import torch

    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.train.train_end2end import train

    t0 = time.time()
    cfg = arm_config(spec, device, argv, save_dir, size)
    shutil.rmtree(os.path.join(save_dir, cfg.run.name), ignore_errors=True)
    state = biased_state(cfg, spec["kernel"], device)
    start = state["arch"]["upconv"].clone()
    kernels.reset_launches()
    engine, results = train(cfg, train_iters=iters, device=device,
                            init_state=state)
    final = engine.arch["upconv"].detach().cpu().clone()
    del engine
    if device != "cpu":
        torch.cuda.empty_cache()
    up = final.numpy()
    col = KERNELS.index(spec["kernel"])
    e = np.exp(up - up.max(axis=-1, keepdims=True))
    w = e / e.sum(axis=-1, keepdims=True)
    norms = [c["arch_grad_norm"] for c in results["chunks"]
             if "arch_grad_norm" in c]
    rec = {
        **spec, "iters": iters, "bias": BIAS, "arch_lr": ARCH_LR,
        "size": size, "n_train": N_TRAIN,
        "test_dice": round(float(results.get("test_dice", math.nan)), 4),
        "best_val": round(float(results["best_val"]), 4),
        "genotype_final": [f"k{KERNELS[int(i)]}"
                           for i in np.argmax(w, axis=-1)],
        "arch_col_means_final": np.round(up.mean(axis=0), 3).tolist(),
        # the biased column's logit lead over the best other column, over
        # the rows: about BIAS at the start; a search that leaves the bad
        # kernel drives it down
        "bias_col_lead_final": round(float(np.mean(
            up[:, col] - np.max(np.delete(up, col, axis=1), axis=1))), 3),
        "arch_max_moved": float((final - start).abs().max()),
        "arch_grad_norm_mean": float(np.mean(norms)) if norms else None,
        "launches": dict(kernels.LAUNCHES),
        "wall_sec": round(time.time() - t0, 1),
    }
    return rec, start, final


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    out_path = argv[0] if argv else os.path.join(ROOT, "NAS_WIN_torch.json")
    budget = float(os.environ.get("NASWIN_BUDGET_SEC", "5400"))
    t0 = time.time()
    out = {"experiment": "nas_torch_win", "iters": ITERS, "bias": BIAS,
           "arch_lr": ARCH_LR, "size": SIZE, "n_train": N_TRAIN,
           "device": device, "probe": [], "arms": []}
    if device != "cpu":
        from semantic_segmentation_torch.bench.timing import card_line
        from semantic_segmentation_torch.kernels import build
        out["card"] = card_line()
        build.build()            # once, before any child loads a library
    failed = []

    def flush(note=""):
        out["elapsed_sec"] = round(time.time() - t0, 1)
        if note:
            out["note"] = note
        with open(out_path + ".tmp", "w") as f:
            json.dump(out, f, indent=1)
        os.replace(out_path + ".tmp", out_path)

    def launch(spec) -> dict | None:
        remaining = budget - (time.time() - t0)
        if remaining < 60:
            flush(f"budget exhausted before {spec}")
            return None
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), device],
                env={**os.environ, "NASWIN_RUN": json.dumps(spec)},
                capture_output=True, text=True, timeout=remaining)
        except subprocess.TimeoutExpired:
            flush(f"run {spec} hit the budget")
            return None
        last = [ln for ln in proc.stdout.strip().splitlines() if ln][-1:]
        if proc.returncode != 0 or not last:
            rec = {**spec, "rc": proc.returncode,
                   "stderr_tail": proc.stderr[-2000:]}
            failed.append(rec)
        else:
            rec = json.loads(last[0])
        print(json.dumps(rec), flush=True)
        return rec

    # the probe: does the kernel matter here?
    for k in KERNELS:
        rec = launch({"mode": "frozen", "kernel": k, "seed": 0})
        if rec is None:
            return 1
        out["probe"].append(rec)
        flush()
    ok = [r for r in out["probe"] if "test_dice" in r]
    if len(ok) < len(KERNELS):
        flush("probe incomplete")
        return 1
    ranked = sorted(ok, key=lambda r: r["test_dice"])
    worst, best = ranked[0]["kernel"], ranked[-1]["kernel"]
    out["probe_spread_pt"] = round(
        (ranked[-1]["test_dice"] - ranked[0]["test_dice"]) * 100, 2)
    out["worst_kernel"], out["best_kernel"] = worst, best
    flush()

    # the arms, paired by seed
    for seed in range(N_SEEDS):
        for mode, k in (("frozen", worst), ("searched", worst),
                        ("frozen", best)):
            rec = launch({"mode": mode, "kernel": k, "seed": seed})
            if rec is None:
                return 1
            out["arms"].append(rec)
            flush()

    def arm(mode, k):
        return [r["test_dice"] for r in out["arms"]
                if r.get("mode") == mode and r.get("kernel") == k
                and "test_dice" in r]

    fw, sw, fb = arm("frozen", worst), arm("searched", worst), \
        arm("frozen", best)
    if fw and sw:
        import numpy as np
        diffs = [s - f for s, f in zip(sw, fw)]      # paired by seed
        out["summary"] = {
            "frozen_worst_dice": fw, "searched_from_worst_dice": sw,
            "frozen_best_dice": fb,
            "paired_diff_searched_minus_frozen": [round(d, 4)
                                                  for d in diffs],
            "mean_gain_pt": round(float(np.mean(diffs)) * 100, 2),
            "searched_wins_all_seeds": bool(all(d > 0 for d in diffs)),
        }
    flush()
    return 1 if failed else 0


if __name__ == "__main__":
    spec = os.environ.get("NASWIN_RUN")
    if spec:                       # a child: argv is the device
        print(json.dumps(run_arm(json.loads(spec), device=sys.argv[1])[0]))
    else:
        sys.exit(main())
