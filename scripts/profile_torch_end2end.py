#!/usr/bin/env python3
"""Where the PyTorch port's end-to-end engine iteration spends its time on
the GPU.

    python3 scripts/profile_torch_end2end.py [--preset end2end_jsrt]
        [--hypergrad darts] [--iters 30] [--profile-iters 5]
        [--out build/profile_torch_end2end.json]

Builds the engine of ``--preset`` (``end2end_jsrt``, ``end2end_nas``,
``end2end_isic``, ``end2end_isic224``, ``end2end_3d`` or ``end2end_bbdm``;
its hypergradient
mode, or ``--hypergrad``) of ``semantic_segmentation_torch`` at the
preset's full width (the flagship's: 256^2, batch 2, unet_256, ngf = ndf =
64, U-Net base 64; ``end2end_isic224``: 224^2, resnet_9blocks, the lite
Swin-UNet; ``end2end_3d``: 64^3 crops, batch 1, the 3D NAS generator with
6 downs at ngf 64, the 3D PatchGAN at ndf 64, UNet3D at base 64;
``end2end_bbdm``: 256^2, batch 2, the ADM denoiser at full width, U-Net
base 64, the preset's ``loss_lambda`` 0, under cuDNN's heuristic mode B as
its entry point runs; bf16
autocast, synthetic data), warms it up, times ``--iters`` engine iterations
(host clock, ending in a device sync), then traces ``--profile-iters`` more
with ``torch.profiler`` and reports: device busy and idle share of the
traced window (union of kernel intervals over first-kernel-start to
last-kernel-end) and, since tracing slows the host, the idle share of the
untraced iteration time; kernel launches per iteration, and device time per
kernel category and for the top kernels. For ``end2end_3d`` it also times
the assembly of the ``MixedConv`` kernels (the 8^3 mixture of three pads
and a weighted sum, cast to bf16, forward and backward) alone with CUDA
events, layer by layer, and reports its share of the iteration: G runs
three times an iteration (netG's forward with its backward, netD's and the
U-Net's without), so the assembly runs three forwards and one backward.
The full report goes to ``--out``; a summary to stdout, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CATEGORIES = (   # first match wins; matched against the lower-cased name
    ("port kernels (warp, equalize)", ("warp_affine_kernel",
                                       "equalize_kernel")),
    ("attention (softmax)", ("softmax",)),
    ("conv / gemm", ("conv", "gemm", "xmma", "cutlass", "sm90_", "sm80_",
                     "cudnn", "implicit", "wgrad", "dgrad", "nchwtonhwc",
                     "nhwctonchw")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce", "welford", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copies / layout", ("copy", "memcpy", "memset", "transpose", "cat")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def mixed_conv_assembly_ms(torch, model, iter_ms: float, reps: int = 10):
    """Device time of the ``MixedConv`` kernel assembly of G's downs (the
    mixture of the three embedded kernels, cast to bf16 as autocast casts it
    for the conv), forward alone and forward + backward, by CUDA events over
    ``reps`` repetitions; and its share of an iteration of ``iter_ms``
    (three forwards and one backward an iteration)."""
    from semantic_segmentation_torch.ops.nas import MixedConv, arch_softmax
    downs = [m for m in model.G.modules() if isinstance(m, MixedConv)]
    w = arch_softmax(model.arch["conv"][0])

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def fwd(m):
        with torch.no_grad():
            m.mixed_kernel(w).to(torch.bfloat16)

    def fwd_bwd(m):
        k = m.mixed_kernel(w).to(torch.bfloat16)
        torch.autograd.grad(k, [getattr(m, f"kernel_{s}")
                                for s in m.kernel_sizes],
                            torch.ones_like(k))

    per_layer = [{"weights": sum(getattr(m, f"kernel_{s}").numel()
                                 for s in m.kernel_sizes),
                  "fwd_ms": timed(lambda: fwd(m)),
                  "fwd_bwd_ms": timed(lambda: fwd_bwd(m))} for m in downs]
    fwd_ms = sum(r["fwd_ms"] for r in per_layer)
    bwd_ms = sum(r["fwd_bwd_ms"] for r in per_layer) - fwd_ms
    per_iter = 3 * fwd_ms + bwd_ms
    return {"per_layer": per_layer, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "ms_per_iter": per_iter, "share_of_iter": per_iter / iter_ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="end2end_jsrt",
                    choices=("end2end_jsrt", "end2end_nas", "end2end_isic",
                             "end2end_isic224", "end2end_3d",
                             "end2end_bbdm"))
    ap.add_argument("--hypergrad", default=None,
                    choices=("darts", "unroll", "decay_only", "none"),
                    help="default: the preset's")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--profile-iters", type=int, default=5)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "profile_torch_end2end.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_end2end: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile, schedule

    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.pipeline import (
        epoch_index_batches, take_batch, to_device_split)
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import (PROBLEMS,
                                                                 build_engine)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    argv = ["--data.synthetic=true"]
    if args.hypergrad:
        argv.append(f"--engine.hypergrad={args.hypergrad}")
    dev = torch.device("cuda")
    model3d = None
    names = PROBLEMS
    if args.preset == "end2end_3d":
        from semantic_segmentation_torch.train import train_end2end_3d as e3d
        cfg = parse_config(argv + ["--preset=end2end_3d", "--data.n_train=4",
                                   "--data.n_val=2", "--data.n_test=0"])
        engine, model3d = e3d.build_engine(cfg, dev, 6, "linear")
        splits = e3d.load_volume_splits(cfg, 64)
    elif args.preset == "end2end_bbdm":
        from semantic_segmentation_torch.train import train_end2end_bbdm
        # as the entry point does, before the process's first conv
        train_end2end_bbdm.prefer_cudnn_heuristic_mode_b(dev)
        cfg = parse_config(argv + ["--data.n_train=4", "--data.n_val=2",
                                   "--data.n_test=0"], preset=args.preset)
        engine, _, _ = train_end2end_bbdm.build_engine(cfg, dev)
        splits = load_splits(cfg)
        names = train_end2end_bbdm.PROBLEMS
    else:
        cfg = parse_config(argv, preset=args.preset)
        engine, _, _ = build_engine(cfg, dev)
        splits = load_splits(cfg)
    train_dev = to_device_split(splits["train"], dev)
    val_dev = to_device_split(splits["val"], dev)
    n_train = len(next(iter(splits["train"].values())))
    streams = {n: epoch_index_batches(n_train, cfg.data.batch_size,
                                      seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(names)}
    val_stream = epoch_index_batches(len(next(iter(splits["val"].values()))),
                                     cfg.data.batch_size,
                                     seed=cfg.run.seed + 99)

    def step():
        return engine.engine_step([{n: take_batch(train_dev, next(s))
                                    for n, s in streams.items()}],
                                  take_batch(val_dev, next(val_stream)))

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        metrics = step()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    losses = {k: float(v) for k, v in metrics.items()}

    # one engine iteration in the profiler's warm-up step, which keeps
    # nothing: the profiler can drop kernels near the start of a trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for n in (1, args.profile_iters):
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            prof.step()
    # device work only: the optimizers' user annotations also sit on the
    # device timeline, spanning their kernels and the gaps between them
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile_torch_end2end: the trace holds no device kernels",
              file=sys.stderr)
        return 1
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = union_us(spans)
    by_cat, by_name, n_by_name = defaultdict(float), defaultdict(float), \
        defaultdict(int)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] += dur
        by_name[e.name] += dur
        n_by_name[e.name] += 1
    P = args.profile_iters
    assembly = (None if model3d is None else
                mixed_conv_assembly_ms(torch, model3d, 1e3 * host_s
                                       / args.iters))
    report = {
        "card": card, "torch": torch.__version__,
        "config": (f"{args.preset}, hypergrad {cfg.engine.hypergrad}, "
                   "64^3, batch 1, UnetGenerator3D nd 6 linear instance, "
                   f"ngf=ndf={cfg.model.ngf}, UNet3D base "
                   f"{cfg.model.base_features}, bf16 autocast, synthetic"
                   if model3d is not None else
                   f"{args.preset}, hypergrad {cfg.engine.hypergrad}, "
                   "256^2, batch 2, the ADM denoiser at model_channels 128, "
                   f"mult (1, 4, 8), loss_lambda {cfg.optim.loss_lambda}, "
                   f"U-Net base {cfg.model.base_features}, bf16 autocast, "
                   "synthetic"
                   if args.preset == "end2end_bbdm" else
                   f"{args.preset}, hypergrad {cfg.engine.hypergrad}, "
                   f"{cfg.data.image_size}^2, batch {cfg.data.batch_size}, "
                   f"{cfg.model.netG}, ngf=ndf={cfg.model.ngf}, "
                   f"segmenter {cfg.model.seg_model}, "
                   f"{cfg.engine.fake_postprocess} fakes, bf16 autocast, "
                   "synthetic"),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "timed_iters": args.iters,
        "host_it_per_s": args.iters / host_s,
        "host_iter_ms": 1e3 * host_s / args.iters,
        "profiled_iters": P,
        "device_window_ms_per_iter": window / 1e3 / P,
        "device_busy_ms_per_iter": busy / 1e3 / P,
        "device_idle_share": 1.0 - busy / window,
        # the profiler slows the host, so the traced window overstates the
        # idle time; against the untraced iteration time instead:
        "device_idle_share_untraced": 1.0 - busy / 1e3 / P
        / (1e3 * host_s / args.iters),
        "kernel_launches_per_iter": len(kernels) / P,
        "kernel_ms_per_iter_by_category": {
            k: v / 1e3 / P for k, v in sorted(by_cat.items(),
                                              key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": k[:160], "ms_per_iter": v / 1e3 / P,
             "launches_per_iter": n_by_name[k] / P,
             "category": category(k)}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]],
        "port_kernels": {
            k[:60]: {"device_us_per_launch": 1e3 * by_name[k] / 1e3 /
                     n_by_name[k], "launches_per_iter": n_by_name[k] / P}
            for k in by_name if category(k).startswith("port")},
        "last_losses": losses,
        "mixed_conv_assembly": assembly,
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    summary = {k: report[k] for k in (
        "card", "config", "peak_mem_bytes", "host_it_per_s", "host_iter_ms", "device_busy_ms_per_iter",
        "device_window_ms_per_iter", "device_idle_share",
        "device_idle_share_untraced",
        "kernel_launches_per_iter", "kernel_ms_per_iter_by_category",
        "port_kernels", "mixed_conv_assembly")}
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
