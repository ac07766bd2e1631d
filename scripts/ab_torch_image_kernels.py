#!/usr/bin/env python3
"""A/B the port's cluster image kernels (equalize, histogram) between
checkouts on one card.

    python3 scripts/ab_torch_image_kernels.py --tree parent=DIR \\
        --tree change=DIR --order parent,change,change,parent [--out FILE]

Each entry of ``--order`` is one fresh process that puts the named
checkout's package first on ``sys.path`` (its kernels build there, into its
own ``build/kernels``) and runs this checkout's
``semantic_segmentation_torch/bench/kernels.py`` ``time_cases`` against it:
the same inputs and timing code through each tree's own wrappers. Prints each
run's records as JSON lines tagged with the run, then a table of the
kernel's and the call's device µs per case and run, with the card's name
and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BENCH = (Path(__file__).resolve().parents[1] / "semantic_segmentation_torch"
         / "bench" / "kernels.py")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def worker(tree: str):
    """Time ``CASES`` through the package in ``tree``, with this checkout's
    timing code (``bench/timing.py``) in place of the tree's own."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import semantic_segmentation_torch.bench
    pkg = Path(semantic_segmentation_torch.bench.__file__).resolve().parents[1]
    if pkg.parent != Path(tree).resolve():
        raise SystemExit(f"imported {pkg}, not the package in {tree}")
    _load("semantic_segmentation_torch.bench.timing",
          BENCH.parent / "timing.py")
    bench = _load("ab_bench_kernels", BENCH)
    print(json.dumps({"card": bench.card_line()}), flush=True)
    for rec in bench.time_cases():
        print(json.dumps(rec), flush=True)


def run_tree(tree: str) -> list[dict]:
    tree = str(Path(tree).resolve())
    proc = subprocess.run([sys.executable, __file__, "--worker", tree],
                          cwd=tree, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise SystemExit(f"worker failed in {tree}:\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout holding the package")
    ap.add_argument("--order", help="comma-separated tree names, one "
                    "process each")
    ap.add_argument("--out", help="also write every record here (JSONL)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    trees = dict(t.split("=", 1) for t in args.tree)
    runs, cards = [], []
    for i, name in enumerate(args.order.split(",")):
        records = run_tree(trees[name])
        for r in records:
            r["run"], r["tree"] = i, name
            print(json.dumps(r), flush=True)
        cards += [r["card"] for r in records if "card" in r]
        runs.append((name, [r for r in records if "kernel" in r]))
    if args.out:
        with open(args.out, "w") as f:
            for _, records in runs:
                for r in records:
                    f.write(json.dumps(r) + "\n")
    print("# device µs per call, kernel / call; "
          + " | ".join(sorted(set(cards))))
    print("case " + " ".join(f"{i}:{n}" for i, (n, _) in enumerate(runs))
          + " bound")
    for j, case in enumerate(runs[0][1]):
        cells = [f"{rs[j]['kernel_ms'] * 1e3:.2f}/{rs[j]['call_ms'] * 1e3:.2f}"
                 for _, rs in runs]
        tag = (f"{case['kernel']}:{case['family']}:"
               f"{'x'.join(map(str, case['shape']))}:"
               f"{'cold' if case['cold'] else 'warm'}")
        print(f"{tag} " + " ".join(cells) + f" {case['bound_ms'] * 1e3:.3f}")


if __name__ == "__main__":
    main()
