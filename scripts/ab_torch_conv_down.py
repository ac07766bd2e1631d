#!/usr/bin/env python3
"""A/B the port's down-conv benchmark between checkouts on one card.

    python3 scripts/ab_torch_conv_down.py --tree parent=DIR --tree change=DIR \\
        --order parent,change,change,parent [--out FILE]

Each entry of ``--order`` is one fresh process that runs
``python -m semantic_segmentation_torch.bench.conv_down`` in the named
checkout (the kernels build there, into its own ``build/kernels``). Prints
each run's per-layer records as JSON lines tagged with the run, then a
table of the kernel's warm device µs per layer and run beside cuDNN's, and
the weighted sums, with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def run_bench(tree: str) -> list[dict]:
    proc = subprocess.run([sys.executable, "-m",
                           "semantic_segmentation_torch.bench.conv_down"],
                          cwd=tree, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise SystemExit(f"bench.conv_down failed in {tree}:\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout holding the package")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one process each")
    ap.add_argument("--out", help="also write every record here (JSONL)")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    runs = []
    for i, name in enumerate(args.order.split(",")):
        records = run_bench(trees[name])
        for r in records:
            r["run"], r["tree"] = i, name
            print(json.dumps(r), flush=True)
        runs.append((name, records))
    if args.out:
        with open(args.out, "w") as f:
            for _, records in runs:
                for r in records:
                    f.write(json.dumps(r) + "\n")
    card = next(r["card"] for r in runs[0][1] if "card" in r)
    layers = [r["layer"] for r in runs[0][1] if "layer" in r]
    print(f"# kernel warm device µs per layer, {card}")
    print("layer " + " ".join(f"{i}:{n}" for i, (n, _) in enumerate(runs))
          + " cudnn(run 0)")
    for layer in layers:
        cells = []
        for _, records in runs:
            row = next(r for r in records if r.get("layer") == layer)
            cells.append(f"{row['kernel_us']:.2f}" if "kernel_us" in row
                         else "refused")
        row0 = next(r for r in runs[0][1] if r.get("layer") == layer)
        print(f"{layer} " + " ".join(cells) + f" {row0['cudnn_us']:.2f}")
    for i, (name, records) in enumerate(runs):
        s = next(r for r in records if r.get("summary") == "conv_down")
        print(json.dumps({"run": i, "tree": name,
                          "kernel_layers_fwd_us": s["kernel_layers_fwd_us"],
                          "kernel_layers_fwd_cold_us": s.get(
                              "kernel_layers_fwd_cold_us"),
                          "kernel_layers_bound_us":
                              s["kernel_layers_bound_us"]}))


if __name__ == "__main__":
    main()
