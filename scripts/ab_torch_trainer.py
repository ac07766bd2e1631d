#!/usr/bin/env python3
"""A/B the port's flagship trainer between checkouts on one card.

    python3 scripts/ab_torch_trainer.py --tree parent=DIR --tree change=DIR \\
        --order parent,change,change+p2p,parent [--iters 20] [--out FILE]

Each entry of ``--order`` is one fresh process, run in the named checkout:
``train_end2end.train()`` of the end2end_jsrt preset at full width (256^2,
batch 2, unet_256, ngf = ndf = 64, U-Net base 64, bf16 autocast,
synthetic data) for ``--iters`` iterations with valid_step 10. A name with
``+p2p`` first trains ``train_pix2pix`` (pix2pix_jsrt, full width, 20 steps)
in the same process, as ``chip_smoke.py`` does, and starts the flagship
from its checkpoint (``--run.pretrained_pix2pix``); that checkout needs the
stage-1 trainer. Per run: steady it/s (the validation chunks after the
first), peak device memory, and the device memory still allocated when the
flagship starts. Prints one JSON line per run and a summary line with the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import gc, json, sys, time
import torch
sys.path.insert(0, ".")
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.train import train_end2end
iters, p2p_first = int(sys.argv[1]), sys.argv[2] == "1"
save = "build/ab_trainer_run"
argv = ["--data.synthetic=true", "--engine.valid_step=10",
        f"--run.save_dir={save}"]
out = {}
if p2p_first:
    from semantic_segmentation_torch.train import train_pix2pix
    cfg = parse_config(["--data.synthetic=true", "--run.log_every=5",
                        f"--run.save_dir={save}"], preset="pix2pix_jsrt")
    torch.cuda.reset_peak_memory_stats()
    model, res = train_pix2pix.train(cfg, train_iters=20, device="cuda")
    steady = res["log"][1:]
    out["pix2pix_it_per_s"] = (sum(r["steps"] for r in steady)
                               / sum(r["seconds"] for r in steady))
    out["pix2pix_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del model, res
    out["allocated_after_pix2pix_bytes"] = torch.cuda.memory_allocated()
    gc.collect()
    out["allocated_after_pix2pix_gc_bytes"] = torch.cuda.memory_allocated()
    argv.append(f"--run.pretrained_pix2pix={save}/{cfg.run.name}")
cfg = parse_config(argv, preset="end2end_jsrt")
torch.cuda.reset_peak_memory_stats()
out["allocated_at_start_bytes"] = torch.cuda.memory_allocated()
engine, results = train_end2end.train(cfg, train_iters=iters, device="cuda")
torch.cuda.synchronize()
steady = results["chunks"][1:]
out["steady_it_per_s"] = (sum(c["iters"] for c in steady)
                          / sum(c["seconds"] for c in steady))
out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
print("AB_RESULT " + json.dumps(out), flush=True)
'''


def run_one(tree: str, iters: int, p2p_first: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(iters), "1" if p2p_first else "0"],
        cwd=tree, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("AB_RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"run in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("AB_RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR of a checkout (repeatable)")
    ap.add_argument("--order", required=True,
                    help="comma-separated NAME or NAME+p2p, one run each")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for entry in args.order.split(","):
        name, _, flag = entry.partition("+")
        rec = {"run": entry, "tree": name,
               **run_one(os.path.abspath(trees[name]), args.iters,
                         flag == "p2p")}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"card": card, "iters": args.iters, "runs": runs}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
