#!/usr/bin/env python3
"""How cuDNN runs the full-width BBDM denoiser's bf16 convs on the card.

    python3 scripts/probe_torch_bbdm_convs.py [--variants nchw,channels_last,
        benchmark,mode_b,benchmark_limit3] [--profile]

Each variant runs in a fresh process (cuDNN's plans and the autotuner's
results are cached per process): the ``bbdm`` preset's denoiser
(model_channels 128, mult (1, 4, 8), 2 res blocks, 1,211,895,425 parameters)
at 256^2 under bf16 autocast, its cells assembled once, then a batch-2
forward (the sampler's step), a batch-8 training step
(``BBDMModel.train_step``) and a training step of ``end2end_bbdm``'s
segmenter (the U-Net at base 64, batch 2, NCHW in every variant: the forward
and backward of its Jaccard loss), each its first call and the mean of the
next ones (host clock, ending in a sync). The variants: ``nchw`` (the
default memory format and cuDNN's instant heuristics), ``channels_last``,
``benchmark`` (channels-last with ``cudnn.benchmark``), ``benchmark_limit3``
(the same with ``benchmark_limit`` 3) and ``mode_b`` (channels-last with
``TORCH_CUDNN_USE_HEURISTIC_MODE_B``, what the BBDM entry points ask for: it
holds for every conv of the process, the segmenter's too). ``--profile``
adds the top kernels of one forward (``torch.profiler``). Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("nchw", "channels_last", "benchmark", "benchmark_limit3",
            "mode_b")


def run_variant(variant: str, profile: bool, steps: bool) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_bbdm
    model = train_bbdm.build_model(parse_config(["--preset=bbdm"]), "cuda")
    if variant == "nchw":
        model.unet.to(memory_format=torch.contiguous_format)
    torch.backends.cudnn.benchmark = variant.startswith("benchmark")
    if variant == "benchmark_limit3":
        torch.backends.cudnn.benchmark_limit = 3

    def timed(label, fn, n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        print(f"[{variant}] {label}: first {first * 1e3:.0f} ms, then "
              f"{(time.perf_counter() - t0) / n * 1e3:.1f} ms", flush=True)

    y = torch.zeros(2, 1, 256, 256, device="cuda")
    t = torch.full((2,), 500, device="cuda")
    with torch.no_grad():
        den = model.denoiser(None, None, model.unet.assemble(
            model.arch, None, torch.bfloat16))
        timed("forward, batch 2", lambda: den(y, t, y, False), 3)
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_
            with prof_(activities=[ProfilerActivity.CUDA]) as prof:
                den(y, t, y, False)
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=8), flush=True)
        del den
    if steps:
        batch = {k: torch.rand(8, 256, 256, 1, device="cuda")
                 for k in ("image_pix2pix", "mask_pix2pix")}
        gen = torch.Generator(device="cuda").manual_seed(0)
        timed("train step, batch 8",
              lambda: model.train_step(batch, generator=gen), 2)
        print(f"[{variant}] peak {torch.cuda.max_memory_allocated()} bytes",
              flush=True)
    del model
    seg_step(timed)


def seg_step(timed) -> None:
    """``end2end_bbdm``'s segmenter: a batch-2 forward and backward of the
    Jaccard loss under bf16 autocast, as its unet inner step runs it."""
    import torch

    from semantic_segmentation_torch.models.seg import (SegProblem,
                                                        seg_loss_fn)
    seg = SegProblem("unet", 1, 1, lr=1e-4, loss_type="jaccard",
                     device="cuda", base_features=64,
                     generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 1, 256, 256, device="cuda")
    m = (torch.rand(2, 1, 256, 256, device="cuda") > 0.5).float()

    def step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = seg_loss_fn(seg.apply(x, True), m, 1, "jaccard")
        loss.backward()
    timed("segmenter step, batch 2", step, 5)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="nchw,mode_b")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--no-steps", action="store_true",
                    help="no batch-8 training step (the autotuner can take "
                         "minutes over its convs)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        run_variant(args.child, args.profile, not args.no_steps)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rc = 0
    for v in args.variants.split(","):
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; one of {VARIANTS}")
        env = dict(os.environ,
                   TORCH_CUDNN_USE_HEURISTIC_MODE_B="1" if v == "mode_b"
                   else "0")
        cmd = [sys.executable, "-u", __file__, "--child", v]
        cmd += ["--profile"] if args.profile else []
        cmd += ["--no-steps"] if args.no_steps else []
        rc |= subprocess.run(cmd, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
