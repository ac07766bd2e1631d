#!/usr/bin/env python3
"""Time the down-conv kernel's pixel-tile loads both ways on the card.

    python3 scripts/sweep_torch_conv_down.py

At each flagship layer the kernel takes (``bench.conv_down.LAYERS``, batch
2, bf16) where the pixel tile fits one TMA box (``ops/conv.x_tma_box``),
the plan of ``conv_down4_plan`` is launched with the pixel tile by TMA and
by cp.async, all else equal: device µs per launch (torch.profiler, warm in
L2) and the error against the plain version. The plan takes TMA for tiles
of 32 pixels and more; this is the measurement behind that rule. One JSON
line per layer and path, then the card's name and power limit. Needs a
CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from semantic_segmentation_torch.bench.conv_down import (  # noqa: E402
    BATCH, ITERS, LAYERS, layer_inputs)
from semantic_segmentation_torch.bench.timing import (  # noqa: E402
    card_line, device_ms)
from semantic_segmentation_torch.ops.conv import (  # noqa: E402
    conv_down4_plan, conv_down4_ref, launch_with_plan, x_tma_box)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_conv_down needs a CUDA card")
    rng = np.random.default_rng(0)
    for tag, hw, cin, cout, _ in LAYERS:
        if cin < 8:
            continue
        x, w = layer_inputs(hw, cin, cout, rng, "cuda")
        plan = conv_down4_plan(BATCH, hw, hw, cin, cout)
        if x_tma_box(plan.rows, hw // 2, hw // 2, cin) is None:
            continue
        ref = conv_down4_ref(x, w).float()
        for x_tma in (True, False):
            p = plan._replace(x_tma=x_tma)
            out = launch_with_plan(x, w, p).float()
            err = float((out - ref).abs().max() / ref.abs().max())
            us = 1e3 * device_ms(lambda: launch_with_plan(x, w, p), ITERS,
                                 "conv_down4")
            print(json.dumps({"layer": tag, "rows": p.rows, "swap": p.swap,
                              "split": p.split, "pixel_tile": "tma" if x_tma
                              else "cp.async", "plan_takes": x_tma ==
                              plan.x_tma, "us": us, "rel_err": err}),
                  flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
