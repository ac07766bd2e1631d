#!/usr/bin/env python3
"""Time the cluster histogram kernels' layouts on the card.

    python3 scripts/sweep_torch_hist.py [--iters N]

For the equalize and the histogram, at the trainer's and benchmark's
shapes warm ((2, 256, 256, 1) and (4, 256, 256)) and at (64, 512, 512)
cold (L2 flushed before each call), on random, constant, two-value and
generator-like images, the plan of ``ops/image.hist256_plan`` is launched
as it is and with each cluster size of ``CLUSTERS`` in its place (the
slices and shared memory laid out again for that size, as the plan would).
Each variant is checked bit for bit against the plain version, then timed:
device µs per launch (torch.profiler). One JSON line per case and variant,
then the card's name and power limit. This is the measurement behind the
plan's cluster sizes. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from semantic_segmentation_torch.bench.kernels import (  # noqa: E402
    SYMBOLS, case_bound, family)
from semantic_segmentation_torch.bench.timing import (  # noqa: E402
    card_line, device_ms)
from semantic_segmentation_torch.kernels.build import launch  # noqa: E402
from semantic_segmentation_torch.ops import image  # noqa: E402

CLUSTERS = (None, 4, 8, 16)     # None: the plan's own
SHAPES = [("equalize_uint8", (2, 256, 256, 1), False),
          ("equalize_uint8", (64, 512, 512, 1), True),
          ("histogram256", (4, 256, 256), False),
          ("histogram256", (64, 512, 512), True)]
FAMILIES = ("random", "constant", "two_value", "generator_like")


def with_cluster(plan, cluster: int, nbytes: int, c: int, equalize: bool):
    """``plan`` laid out again for clusters of ``cluster`` CTAs, as
    ``hist256_plan`` lays out the size it picks (the C entry points refuse
    a layout that does not cover the image or fit its shared memory)."""
    per_cta = -(-nbytes // cluster)
    slice_bytes = max(16, -(-per_cta // 16) * 16)
    counts = 4 * (c * 256 + (cluster * c * 256 if equalize else 256))
    keep = equalize and counts + slice_bytes + 16 <= image.SMEM_MAX
    return image.Hist256Plan(cluster, cluster * plan.ctas // plan.cluster,
                             slice_bytes, keep,
                             counts + (slice_bytes + 16 if keep else 0))


def launcher(kernel: str, x, cluster):
    """(plan, fn): fn launches ``kernel`` on ``x`` with the plan's layout,
    or that layout at clusters of ``cluster`` CTAs."""
    equalize = kernel == "equalize_uint8"
    n, h, w = x.shape[:3]
    c = x.shape[3] if equalize else 1
    plan = image.hist256_plan(n, h * w, c, equalize)
    if cluster is not None:
        plan = with_cluster(plan, cluster, h * w * c, c, equalize)
    if equalize:
        def fn():
            out = torch.empty_like(x)
            launch(kernel, x.device, x.data_ptr(), out.data_ptr(), n, h * w,
                   c, plan.cluster, plan.slice_bytes, int(plan.keep),
                   plan.smem_bytes)
            return out
    else:
        def fn():
            out = torch.empty(n, 256, dtype=torch.int32, device=x.device)
            launch(kernel, x.device, x.data_ptr(), out.data_ptr(), n, h * w,
                   plan.cluster, plan.slice_bytes, plan.smem_bytes)
            return out
    return plan, fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100,
                    help="timed calls per case warm; a quarter cold")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_hist needs a CUDA card")
    for kernel, shape, cold in SHAPES:
        bound, _ = case_bound(kernel, shape)
        for fam in FAMILIES:
            x = family(fam, shape)
            ref = (image.equalize_uint8_ref(x) if kernel == "equalize_uint8"
                   else image.histogram256_ref(x))
            for cluster in CLUSTERS:
                plan, fn = launcher(kernel, x, cluster)
                if not torch.equal(fn(), ref):
                    raise SystemExit(f"{kernel} {fam} {shape} cluster "
                                     f"{cluster}: not bit-exact")
                us = 1e3 * device_ms(fn, args.iters // 4 if cold else
                                     args.iters, SYMBOLS[kernel], cold=cold)
                print(json.dumps({
                    "kernel": kernel, "family": fam, "shape": list(shape),
                    "cold": cold, "variant": cluster or "plan",
                    "plan": plan._asdict(), "us": us,
                    "bound_us": bound * 1e3,
                    "share_of_bound": bound * 1e3 / us}), flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
