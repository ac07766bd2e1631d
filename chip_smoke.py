#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``semantic_segmentation_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which stops the script with a nonzero exit on failure:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA source of ``semantic_segmentation_torch/kernels/csrc``
   compiled with nvcc (one process each, in parallel) into build/kernels/;
3. kernels against their plain PyTorch versions on the card, TF32 off:
   - warp: (2, 256, 256, 1) binary masks under ``sample_affine_batch``
     draws and (2, 256, 256, 3) random floats, max |err| 0 and an
     identical > 0.1 mask; identity and flip matrices exact;
   - equalize and histogram (one thread-block cluster per image): each
     bit-exact against its plain version (the histogram also against
     ``np.bincount``) on random uint8 (2, 256, 256, 1), a constant plane, a
     two-value plane and the uint8 image of a full-width unet_256
     generator's output (the histogram also at (4, 256, 256)), at c = 3,
     at hw off multiples of 16, on views 1 byte off a 16-byte boundary,
     and at (64, 512, 512); each call one launch of one kernel;
   - down-conv: bf16, within 1e-2 of the plain version's largest magnitude
     at the 9 flagship layers with C_in >= 8 (``bench.conv_down.LAYERS``;
     G_d5's last split-K range is shorter than the others), at M = 2, 8,
     32 and 130, and at C_in / C_out off multiples of 8 (12 -> 64,
     16 -> 20, 12 -> 20); two calls bit-identical at G_d5 and G_d8 (split-K,
     swap-AB); C_in = 1 and 2 raise ``NotImplementedError``;
4. the fake branch in context: warp -> threshold -> G -> min-max -> uint8 ->
   equalize -> gamma through the kernels and through the plain versions
   gives identical images;
5. the engine on the card against the engine on the CPU: three iterations
   at 32^2 in float32 from the same seed, batches and augment matrices, in
   each of ``decay_only``, ``darts`` (the reference wiring) and ``unroll``
   (``end2end_nas``); losses within rtol 1e-3, arch tables within 1e-6
   (1e-5 for ``unroll``); the darts hypergradient exactly 0 on both
   devices and its arch tables equal to ``decay_only``'s, the unroll one
   finite and > 0;
6. the stage-1 trainer: ``train_pix2pix.train()`` of the pix2pix_jsrt
   preset at full width (256^2, batch 2, unet_256, ngf = ndf = 64, bf16
   autocast, synthetic data) for 20 steps; finite losses, the two
   checkpoint files written, no kernel launched (the path has none);
7. the flagship trainer from that checkpoint: ``--run.pretrained_pix2pix``
   gives G, D and the arch tables the saved values at the start; then
   ``train()`` at full width (U-Net base 64), 20 iterations with
   valid_step 10 (one steady chunk), in three modes, each path's launch
   counts zeroed before it and read after: the end2end_jsrt preset
   (``decay_only``: the warp and the equalize once per iteration), the
   same with ``--engine.hypergrad=darts`` (unroll and replay: each twice
   per iteration; the hypergradient exactly 0 on every chunk) and the
   end2end_nas preset (``unroll``, ``minmax``, live fakes: the warp three
   times per iteration with the surrogate's, the equalize never; the
   hypergradient finite and > 0 on every chunk); finite losses, best_val
   and test Dice produced, the histogram and the down-conv never launched,
   and steady it/s and peak memory printed for each;
8. timing, after the trainers so that the profiler cannot slow them: the
   warp's and the equalize's device time (torch.profiler) and wrapper call
   time (CUDA events) on the inputs of phase 3, beside their plain
   versions' and the library call's (``F.grid_sample`` for the warp), and
   the two benchmark entry points that run the other kernels:
   ``bench.kernels`` (the histogram's path, and ``time_cases``: the
   equalize at (2, 256, 256, 1) on the generator image and random bytes,
   the histogram at (4, 256, 256) on random and constant images, warm, and
   both at (64, 512, 512) with L2 flushed, each as kernel and as call
   device time beside its bytes bound) and ``bench.conv_down`` (the
   down-conv's, all 11 layers, against ``F.conv2d``, warm and with L2
   flushed).

Each path's launch counts are zeroed just before it runs and read just
after. Then one JSON line of kernel records, the card line, and as the last
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN_ITERS, MODE_ITERS, VALID_STEP, PIX2PIX_STEPS = 20, 20, 10, 20
SAVE_DIR = ROOT / "build" / "chip_smoke_run"


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def phase_kernels(torch, dev, G, arch):
    import numpy as np
    import torch.nn.functional as F

    from semantic_segmentation_torch.bench.timing import bound_ms
    from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
    from semantic_segmentation_torch.ops import augment, image

    gen = torch.Generator(device=dev).manual_seed(0)
    records, timers = {}, {}

    # -- warp ------------------------------------------------------------
    ds = SyntheticSegDataset(n=2, size=256, seed=3)
    masks = torch.from_numpy(np.stack([ds[i]["mask"] for i in range(2)]))
    masks = masks.float().to(dev)                            # (2,256,256,1)
    mats = augment.sample_affine_batch(2, 256, 256, gen)
    out_k = augment.warp_affine_batch(masks, mats)
    out_r = augment.warp_affine_batch_ref(masks, mats)
    err_mask = (out_k - out_r).abs().max().item()
    check(err_mask == 0.0, f"warp masks: max |err| {err_mask}")
    check(torch.equal(out_k > 0.1, out_r > 0.1), "warp masks: > 0.1 differs")
    rgb = torch.rand(2, 256, 256, 3, generator=gen, device=dev)
    mats3 = augment.sample_affine_batch(2, 256, 256, gen)
    err_rgb = (augment.warp_affine_batch(rgb, mats3)
               - augment.warp_affine_batch_ref(rgb, mats3)).abs().max().item()
    check(err_rgb == 0.0, f"warp rgb: max |err| {err_rgb}")
    eye = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    check(torch.equal(augment.warp_affine_batch(rgb, eye), rgb),
          "warp: identity not exact")
    flip = torch.tensor([[-1.0, 0.0, 255.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                        device=dev).expand(2, 3, 3).contiguous()
    check(torch.equal(augment.warp_affine_batch(rgb, flip),
                      rgb.flip(2)), "warp: flip not exact")
    print(f"[kernels] warp: max|err| masks {err_mask:.3e} rgb {err_rgb:.3e}, "
          f"> 0.1 masks identical, identity and flip exact")

    # library yardstick: grid_sample on the same warp (align_corners=True
    # maps pixel centres as the kernel does)
    inv = torch.linalg.inv(mats)
    ys, xs = torch.meshgrid(torch.arange(256., device=dev),
                            torch.arange(256., device=dev), indexing="ij")
    sx = inv[:, 0, 0, None, None] * xs + (inv[:, 0, 1, None, None] * ys
                                          + inv[:, 0, 2, None, None])
    sy = inv[:, 1, 0, None, None] * xs + (inv[:, 1, 1, None, None] * ys
                                          + inv[:, 1, 2, None, None])
    grid = torch.stack([sx / 127.5 - 1.0, sy / 127.5 - 1.0], -1)
    masks_nchw = masks.permute(0, 3, 1, 2)

    def lib_warp():
        return F.grid_sample(masks_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    err_lib = (lib_warp().permute(0, 2, 3, 1) - out_r).abs().max().item()
    numel = masks.numel()
    # image read + output written (f32) + the (2, 3, 3) f32 matrices;
    # ~20 f32 operations per output
    b, why = bound_ms(2 * 4 * numel + mats.numel() * 4, 20 * numel)

    records["warp_affine"] = {
        "name": "warp_affine", "route": "cuda",
        "source": "semantic_segmentation_torch/kernels/csrc/warp_affine.cu",
        "replaces": "semantic_segmentation_tpu/ops/pallas_kernels.py:243",
        "max_abs_err": max(err_mask, err_rgb),
        "bound_ms": b, "bound_us": b * 1e3, "bound_by": why,
        "shape": [2, 256, 256, 1], "library_max_abs_err": err_lib}
    timers["warp_affine"] = (
        "warp_affine_kernel", lambda: augment.warp_affine_batch(masks, mats),
        lambda: augment.warp_affine_batch_ref(masks, mats), lib_warp)

    # -- equalize and histogram (one cluster kernel each) -------------------
    fake_mask = image.threshold_mask(out_k, 0.1)
    with torch.no_grad():
        g_out = G(fake_mask.permute(0, 3, 1, 2), arch).permute(0, 2, 3, 1)
    gen_img = image.to_uint8(image.minmax_normalize(g_out))
    checked = phase_cluster_check(torch, dev, gen_img)
    print(f"[kernels] equalize and histogram: bit-exact (histogram also "
          f"against np.bincount), one launch per call, on "
          f"{'; '.join(checked)}")
    x = gen_img
    # one uint8 read + one written per pixel; a histogram add and a LUT
    # lookup per pixel, integer work counted at the f32 rate (the data
    # sheet gives no int32 rate outside the tensor cores)
    b, why = bound_ms(2 * x.numel(), 2 * x.numel())
    records["equalize_uint8"] = {
        "name": "equalize_uint8", "route": "cuda",
        "source": "semantic_segmentation_torch/kernels/csrc/equalize_uint8.cu",
        "replaces": "semantic_segmentation_tpu/ops/pallas_kernels.py:147",
        "max_abs_err": 0.0,
        "bound_ms": b, "bound_us": b * 1e3, "bound_by": why,
        "shape": [2, 256, 256, 1], "image": "generator"}
    timers["equalize_uint8"] = (
        "equalize_kernel", lambda: image.equalize_uint8(x),
        lambda: image.equalize_uint8_ref(x), None)
    phase_conv_check(torch, dev)
    return records, timers, gen_img


def phase_cluster_check(torch, dev, gen_img):
    """The equalize and the histogram against their plain versions, bit for
    bit, and the histogram against np.bincount, on: random, constant,
    two-value and generator images at the trainer's (2, 256, 256, 1) (the
    histogram also at (4, 256, 256)); c = 3 at 256^2; hw off multiples of
    16; a view 1 byte off a 16-byte boundary; and (64, 512, 512). The
    histogram runs on the first channel's planes. Each call is one launch
    of one kernel: the profiler sees no other kernel (no zeroing fill).
    Returns the labels of the cases checked."""
    import numpy as np

    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.bench.kernels import SYMBOLS, family
    from semantic_segmentation_torch.bench.timing import call_kernels
    from semantic_segmentation_torch.ops import image

    def unaligned(x):
        base = torch.empty(x.numel() + 16, dtype=torch.uint8, device=dev)
        view = base[1:1 + x.numel()].view(x.shape)
        view.copy_(x)
        check(view.data_ptr() % 16 == 1, "unaligned view is aligned")
        return view

    cases = {f: family(f, (2, 256, 256, 1), dev) for f in
             ("random", "constant", "two_value")}
    cases["generator"] = gen_img
    cases["random c=3"] = family("random", (2, 256, 256, 3), dev)
    cases["two_value c=3"] = family("two_value", (2, 256, 256, 3), dev)
    cases["random 250^2"] = family("random", (2, 250, 250, 1), dev)
    cases["random unaligned"] = unaligned(family("random", (2, 256, 256, 1),
                                                 dev, seed=1))
    cases["random 250^2 unaligned"] = unaligned(cases["random 250^2"])
    cases["random (64, 512, 512)"] = family("random", (64, 512, 512, 1), dev)
    cases["generator_like (64, 512, 512)"] = family(
        "generator_like", (64, 512, 512, 1), dev)
    for label, x in cases.items():
        planes = x[..., 0] if x.shape[-1] == 1 else x[..., 0].contiguous()
        stacks = [planes]
        if tuple(planes.shape) == (2, 256, 256):
            stacks.append(torch.cat([planes, planes.flip(1)]))  # (4, ...)
        before = dict(kernels.LAUNCHES)
        k, r = image.equalize_uint8(x), image.equalize_uint8_ref(x)
        check(torch.equal(k, r), f"equalize {label}: not bit-exact "
              f"({(k != r).sum().item()} pixels differ)")
        for xs in stacks:
            k, r = image.histogram256(xs), image.histogram256_ref(xs)
            counts = np.stack([np.bincount(p.ravel(), minlength=256)
                               for p in xs.cpu().numpy()])
            check(torch.equal(k, r) and np.array_equal(k.cpu().numpy(),
                                                       counts),
                  f"histogram {label} {tuple(xs.shape)}: not bit-exact")
        launched = {n: kernels.LAUNCHES[n] - before[n] for n in before}
        check(launched["equalize_uint8"] == 1
              and launched["histogram256"] == len(stacks),
              f"{label}: launches {launched}, not one per call")
    x = cases["generator"]
    for name, fn in (("equalize_uint8", lambda: image.equalize_uint8(x)),
                     ("histogram256", lambda: image.histogram256(
                         x[..., 0]))):
        names = call_kernels(fn)
        check(len(names) == 1 and SYMBOLS[name] in names[0],
              f"{name}: one call launched {names}, not one kernel")
    return list(cases)


# (B, H, W, C_in, C_out) at M = 2, 8, 32 (swap-AB) and 130, as in
# tests/test_torch_cuda_kernels.py
CONV_SMALL_M = [(1, 2, 4, 64, 40), (2, 4, 4, 256, 64), (2, 8, 8, 128, 136),
                (2, 10, 26, 64, 64)]


def phase_conv_check(torch, dev):
    """The down-conv kernel against its plain version in bf16 at the 9
    flagship layers it takes, at small M and at C_in / C_out off multiples
    of 8; two calls bit-identical; C_in < 8 refused. Tolerance 1e-2 of the
    plain output's largest magnitude: one bf16 rounding of each output, f32
    sums in another order."""
    import numpy as np

    from semantic_segmentation_torch.bench import conv_down
    from semantic_segmentation_torch.ops.conv import (conv_down4,
                                                      conv_down4_k_ranges,
                                                      conv_down4_plan,
                                                      conv_down4_ref)
    rows, _ = conv_down.run(timing=False)
    worst = 0.0
    for r in rows:
        if r["cin"] >= 8:
            check(r["kernel_vs_plain_err"] <= 1e-2,
                  f"conv {r['layer']}: relative error "
                  f"{r['kernel_vs_plain_err']}")
            worst = max(worst, r["kernel_vs_plain_err"])
        else:
            check("NotImplementedError" in r.get("kernel_error", ""),
                  f"conv {r['layer']}: C_in {r['cin']} not refused: {r}")
    plan = conv_down4_plan(2, 16, 16, 512, 512)               # G_d5
    a, b = conv_down4_k_ranges(plan)[-1]
    check(plan.split > 1 and b - a < plan.k_per_split,
          f"conv: G_d5's last K range is not ragged: {plan}")
    rng = np.random.default_rng(5)
    shapes = CONV_SMALL_M + [(2, 32, 32, cin, cout) for cin, cout in
                             ((12, 64), (16, 20), (12, 20))]
    for bsz, h, w, cin, cout in shapes:
        x = torch.from_numpy(rng.standard_normal((bsz, h, w, cin))).to(
            dev, torch.bfloat16)
        wt = torch.from_numpy(0.05 * rng.standard_normal(
            (4, 4, cin, cout))).to(dev, torch.bfloat16)
        k, ref = conv_down4(x, wt).float(), conv_down4_ref(x, wt).float()
        err = ((k - ref).abs().max() / ref.abs().max()).item()
        check(k.shape == ref.shape and err <= 1e-2,
              f"conv {(bsz, h, w, cin, cout)}: relative error {err}")
        worst = max(worst, err)
    for hw in (16, 2):                                        # G_d5, G_d8
        x, wt = conv_down.layer_inputs(hw, 512, 512, rng, dev)
        first = conv_down4(x, wt)
        check(all(torch.equal(conv_down4(x, wt), first) for _ in range(3)),
              f"conv {hw}^2 x 512: two calls differ")
    print(f"[kernels] conv_down4: {sum(r['cin'] >= 8 for r in rows)} "
          f"flagship layers, M = 2, 8, 32, 130 and 3 off-multiple-of-8 "
          f"shapes within {worst:.3e} of max |plain| (<= 1e-2); repeated "
          f"calls bit-identical; C_in 1 and 2 refused")


def phase_timing(records, timers):
    """Each kernel's device time, its wrapper's call time, its plain
    version's and the library call's device time, at the inputs of the
    kernel phase. Runs after the trainer, so that the profiler cannot slow
    the trainer's measurement."""
    from semantic_segmentation_torch.bench.timing import device_ms, time_ms
    for name, (symbol, kernel_fn, plain_fn, lib_fn) in timers.items():
        records[name].update({
            "ms": device_ms(kernel_fn, 200, symbol),
            "wrapper_call_ms": time_ms(kernel_fn, 200),
            "plain_ms": device_ms(plain_fn, 50),
            "library_ms": device_ms(lib_fn, 200) if lib_fn else None})
        print(f"[timing] {name}: " + json.dumps(records[name]))


def phase_fake_branch(torch, dev, G, arch, masks_warp_in, mats):
    from semantic_segmentation_torch.ops import augment, image
    mk = image.threshold_mask(augment.warp_affine_batch(masks_warp_in, mats))
    mr = image.threshold_mask(augment.warp_affine_batch_ref(masks_warp_in,
                                                            mats))
    check(torch.equal(mk, mr), "fake branch: thresholded masks differ")
    with torch.no_grad():
        fake = G(mk.permute(0, 3, 1, 2), arch).permute(0, 2, 3, 1)
    out_k = image.equalize_gamma_chain(fake, 0.5)
    u8 = image.to_uint8(image.minmax_normalize(fake))
    out_r = image.adjust_gamma_uint8(image.equalize_uint8_ref(u8), 0.5)
    out_r = out_r.float() / 255.0
    check(torch.equal(out_k, out_r), "fake branch: images differ")
    print("[fake branch] kernels and plain versions give identical images "
          f"{tuple(out_k.shape)}")


SMALL_ARGV = ["--data.synthetic=true", "--data.image_size=32",
              "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
              "--model.compute_dtype=float32", "--model.netG=unet_32",
              "--model.ngf=8", "--model.ndf=8", "--model.base_features=8"]


SMALL_MODES = {   # label: (extra argv, preset, arch tolerance card vs CPU)
    "decay_only": ([], "end2end_jsrt", 1e-6),
    "darts": (["--engine.hypergrad=darts"], "end2end_jsrt", 1e-6),
    "unroll": ([], "end2end_nas", 1e-5),
}


def _small_engine_run(torch, dev, argv, preset, iters):
    """``iters`` engine iterations at 32^2 on ``dev``: the index streams of
    the trainer, and augment matrices drawn on the CPU from one seed for
    every phase (unroll, hypergradient, replay), the same for every mode.
    Returns (metrics per iteration, arch tables on the CPU)."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.pipeline import (
        epoch_index_batches, take_batch, to_device_split)
    from semantic_segmentation_torch.ops.augment import sample_affine_batch
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import (PROBLEMS,
                                                                 build_engine)
    cfg = parse_config(SMALL_ARGV + argv, preset=preset)
    splits = load_splits(cfg)
    bs, size = cfg.data.batch_size, cfg.data.image_size
    engine, p2p, _ = build_engine(cfg, dev)
    data = to_device_split(splits["train"], dev)
    val = to_device_split(splits["val"], dev)
    streams = {n: epoch_index_batches(cfg.data.n_train, bs,
                                      seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(cfg.data.n_val, bs,
                                     seed=cfg.run.seed + 99)
    gen = torch.Generator().manual_seed(11)
    out = []
    for _ in range(iters):
        draws = {ph: [{"unet": {"affine": sample_affine_batch(
            bs, size, size, gen).to(dev)}}]
            for ph in ("unroll", "hyper", "replay")}
        m = engine.engine_step(
            [{n: take_batch(data, next(s)) for n, s in streams.items()}],
            take_batch(val, next(val_stream)), draws)
        out.append({k: float(v) for k, v in m.items()})
    return out, {k: v.cpu() for k, v in p2p.arch.items()}


def phase_small_engine(torch, devices=("cpu", "cuda"), iters: int = 3):
    """Three engine iterations at 32^2 in float32 in each of ``decay_only``,
    ``darts`` (the reference wiring) and ``unroll`` (``end2end_nas``), on the
    card and on the CPU (where every op takes its plain path, the path the
    CPU tests hold against the JAX package), from the same seed, batches and
    augment matrices. Losses agree within rtol 1e-3 (the uint8 chain may
    move a quantisation level), the arch tables within 1e-6 (1e-5 for
    ``unroll``, whose hypergradient differs in f32 noise between the
    devices). ``darts``' hypergradient is exactly 0 on both devices and its
    arch tables equal ``decay_only``'s; ``unroll``'s norm is finite and
    > 0."""
    arch_by_mode = {}
    for label, (argv, preset, tol) in SMALL_MODES.items():
        (ref, arch_ref), (got, arch_got) = [
            _small_engine_run(torch, dev, argv, preset, iters)
            for dev in devices]
        losses = [k for k in ref[0] if k.startswith(("loss_", "replay_loss_",
                                                     "outer_loss"))]
        check(all(math.isfinite(v) for g in got for v in g.values()),
              f"small engine {label}: metrics not finite: {got}")
        worst = max(abs(g[k] - r[k]) / abs(r[k])
                    for r, g in zip(ref, got) for k in losses)
        check(worst < 1e-3, f"small engine {label}: losses {got} against "
              f"{ref}")
        arch_err = max((arch_got[k] - arch_ref[k]).abs().max().item()
                       for k in arch_ref)
        check(arch_err < tol, f"small engine {label}: arch tables differ by "
              f"{arch_err}")
        norms = [m["arch_grad_norm"] for m in ref + got]
        if label == "darts":
            check(all(n == 0.0 for n in norms),
                  f"small engine darts: hypergradient not exactly 0: {norms}")
        if label == "unroll":
            check(all(n > 0.0 for n in norms),
                  f"small engine unroll: hypergradient norms {norms}")
        arch_by_mode[label] = arch_got
        print(f"[small engine] {label}: {iters} iterations at 32^2 f32, "
              f"{devices[1]} against {devices[0]}: largest relative loss gap "
              f"{worst:.3e}, arch max |err| {arch_err:.3e}, arch_grad_norm "
              f"{[f'{n:.3e}' for n in norms]}")
    same = all(torch.equal(arch_by_mode["darts"][k], arch_by_mode[
        "decay_only"][k]) for k in arch_by_mode["darts"])
    check(same, "small engine: darts' arch tables differ from decay_only's")
    print("[small engine] darts' arch tables on the card equal decay_only's")


def phase_pix2pix(torch):
    """20 full-width stage-1 steps; returns (stats, checkpoint dir)."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_pix2pix
    cfg = parse_config(["--data.synthetic=true", "--run.log_every=5",
                        f"--run.save_dir={SAVE_DIR}"], preset="pix2pix_jsrt")
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.compute_dtype) == (256, 2, "unet_256", 64, 64, "bfloat16"),
          "pix2pix: not the full-width pix2pix_jsrt configuration")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model, results = train_pix2pix.train(cfg, train_iters=PIX2PIX_STEPS,
                                         device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(not any(launches.values()),
          f"pix2pix: the path runs no kernel, launches {launches}")
    for r in results["log"]:
        for k in ("loss_G", "loss_D", "loss_D_fake", "loss_D_real"):
            check(math.isfinite(r[k]), f"pix2pix: {k} not finite: {r}")
    ckpt = SAVE_DIR / cfg.run.name
    for f in (train_pix2pix.GENERATOR_FILE, train_pix2pix.DISCRIMINATOR_FILE):
        check((ckpt / f).is_file(), f"pix2pix: no checkpoint {ckpt / f}")
    steady = results["log"][1:]
    its = sum(r["steps"] for r in steady) / sum(r["seconds"] for r in steady)
    del model
    return {"steps": results["steps"], "wall_s": wall,
            "first_log_s": results["log"][0]["seconds"],
            "steady_it_per_s": its, "steady_step_ms": 1e3 / its,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "last_losses": {k: results["log"][-1][k] for k in
                            ("loss_G", "loss_D")},
            "launches": launches}, ckpt


# the flagship trainer's paths: label -> (preset, extra argv, iterations,
# warp and equalize launches per unet inner step of the K unroll steps)
TRAINERS = {
    "end2end_trainer": ("end2end_jsrt", [], TRAIN_ITERS, 1, 1),
    "darts_trainer": ("end2end_jsrt", ["--engine.hypergrad=darts"],
                      MODE_ITERS, 2, 2),
    "nas_trainer": ("end2end_nas", [], MODE_ITERS, 3, 0),
}


def check_start(torch, ckpt):
    """The engine ``train()`` builds starts from the saved G, D and arch
    tables of the stage-1 checkpoint ``ckpt``."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train.train_end2end import build_engine
    from semantic_segmentation_torch.train.train_pix2pix import GENERATOR_FILE
    cfg = parse_config(["--data.synthetic=true",
                        f"--run.pretrained_pix2pix={ckpt}"],
                       preset="end2end_jsrt")
    engine, p2p, seg = build_engine(cfg, "cuda")
    saved = torch.load(ckpt / GENERATOR_FILE, map_location="cuda",
                       weights_only=True)
    check(all(torch.equal(v, saved["G"][k])
              for k, v in p2p.G.state_dict().items())
          and all(torch.equal(v, saved["arch"][k])
                  for k, v in p2p.arch.items()),
          "trainer: G or the arch tables differ from the checkpoint")
    del engine, p2p, seg, saved
    torch.cuda.empty_cache()
    print(f"[trainer] G and the arch tables start from {ckpt}")


def phase_trainer(torch, ckpt, label: str):
    """The flagship trainer at full width in the mode of ``TRAINERS[label]``,
    started from the stage-1 checkpoint ``ckpt``: finite losses, best_val
    and test Dice produced, the warp and the equalize launched as the mode
    runs the unet problem, the histogram and the down-conv never; the
    darts hypergradient exactly 0 (the reference wiring's structural zero),
    the unroll one finite and > 0, on every logged chunk."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train.train_end2end import train
    preset, argv, iters, warps, equalizes = TRAINERS[label]
    cfg = parse_config(["--data.synthetic=true",
                        f"--engine.valid_step={VALID_STEP}",
                        f"--run.pretrained_pix2pix={ckpt}",
                        f"--run.save_dir={SAVE_DIR}"] + argv, preset=preset)
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.base_features, m.compute_dtype) ==
          (256, 2, "unet_256", 64, 64, 64, "bfloat16"),
          f"{label}: not the full-width {preset} configuration")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train(cfg, train_iters=iters, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    unet_steps = iters * cfg.engine.unroll_steps
    want = {"warp_affine": warps * unet_steps,
            "equalize_uint8": equalizes * unet_steps,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"{label}: launches {launches}, not {want} "
          f"({unet_steps} unet inner steps, hypergrad "
          f"{cfg.engine.hypergrad})")
    for c in results["chunks"]:
        for k in ("loss_netG", "loss_netD", "loss_unet", "val_score"):
            check(math.isfinite(c[k]), f"{label}: {k} not finite: {c}")
        if cfg.engine.hypergrad == "darts":
            check(c["arch_grad_norm"] == 0.0,
                  f"{label}: darts hypergradient not exactly 0: {c}")
        if cfg.engine.hypergrad == "unroll":
            check(math.isfinite(c["arch_grad_norm"])
                  and c["arch_grad_norm"] > 0.0,
                  f"{label}: unroll hypergradient norm {c}")
    check(math.isfinite(results["best_val"]) and "test_dice" in results
          and math.isfinite(results["test_dice"]),
          f"{label}: no best_val/test_dice: {results}")
    steady = results["chunks"][1:]
    its = sum(c["iters"] for c in steady) / sum(c["seconds"] for c in steady)
    keys = ("loss_netG", "loss_netD", "loss_unet", "outer_loss",
            "arch_grad_norm")
    stats = {"preset": preset, "hypergrad": cfg.engine.hypergrad,
             "iters": iters, "wall_s": wall,
             "first_chunk_s": results["chunks"][0]["seconds"],
             "steady_it_per_s": its, "steady_iter_ms": 1e3 / its,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "best_val": results["best_val"],
             "test_dice": results["test_dice"],
             "last_metrics": {k: results["chunks"][-1][k] for k in keys
                              if k in results["chunks"][-1]},
             "launches": launches}
    del engine
    torch.cuda.empty_cache()
    return stats


def phase_benches(torch, records, gen_img):
    """The two benchmark entry points, each the path of one more kernel:
    ``bench.kernels`` (the histogram, at (4, 256, 256), then the cluster
    kernels' ``time_cases``) and ``bench.conv_down`` (the down-conv, all 11
    layers). Adds the two kernels' records and the cases to the equalize's
    and the histogram's; returns each path's launch counts."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.bench import conv_down
    from semantic_segmentation_torch.bench import kernels as kernels_bench
    from semantic_segmentation_torch.bench.timing import bound_ms
    launches = {}

    kernels.reset_launches()
    bench = kernels_bench.run()
    cases = kernels_bench.time_cases(gen_img)
    launches["bench_kernels"] = dict(kernels.LAUNCHES)
    check(launches["bench_kernels"]["histogram256"] > 0,
          "bench.kernels: the histogram kernel was not launched")
    print("[bench.kernels] " + json.dumps(bench))
    for c in cases:
        print("[bench.kernels case] " + json.dumps(c))
    for name in ("equalize_uint8", "histogram256"):
        check(all(c["kernel_ms"] > 0 for c in cases if c["kernel"] == name),
              f"bench.kernels: {name} not timed at every case")
    h = bench["histogram256"]
    n_px = math.prod(h["shape"])
    # each pixel read once, the int32 counts written once; one add per
    # pixel, integer work counted at the f32 rate
    b, why = bound_ms(n_px + h["shape"][0] * 256 * 4, n_px)
    records["histogram256"] = {
        "name": "histogram256", "route": "cuda",
        "source": "semantic_segmentation_torch/kernels/csrc/histogram256.cu",
        "replaces": "semantic_segmentation_tpu/ops/pallas_kernels.py:66",
        "max_abs_err": h["max_abs_err"], "ms": h["ms"],
        "call_ms": h["call_ms"], "wrapper_call_ms": h["wrapper_call_ms"],
        "plain_ms": h["plain_ms"], "library_ms": None, "bound_ms": b,
        "bound_us": b * 1e3, "bound_by": why, "shape": h["shape"]}
    for name in ("equalize_uint8", "histogram256"):
        records[name]["cases"] = [c for c in cases if c["kernel"] == name]

    kernels.reset_launches()
    rows, summary = conv_down.run(
        emit=lambda r: print("[bench.conv_down] " + json.dumps(r)))
    launches["bench_conv_down"] = dict(kernels.LAUNCHES)
    check(launches["bench_conv_down"]["conv_down4"] > 0,
          "bench.conv_down: the conv kernel was not launched")
    taken = [r for r in rows if "kernel_us" in r]
    check(len(taken) == 9, f"bench.conv_down: kernel timed at {len(taken)} "
          "layers, not 9")
    ops_bound = sum(r["mult"] * r["bound_us"] for r in taken
                    if r["bound_by"] == "operations")
    us = summary["kernel_layers_fwd_us"]
    cold = summary["kernel_layers_fwd_cold_us"]
    records["conv_down4"] = {
        "name": "conv_down4", "route": "cuda",
        "source": "semantic_segmentation_torch/kernels/csrc/conv_down4.cu",
        "replaces": "scripts/bench_conv_down.py:209",
        "max_abs_err": max(r["kernel_vs_plain_abs_err"] for r in taken),
        "max_rel_err": max(r["kernel_vs_plain_err"] for r in taken),
        "ms": us["kernel"] / 1e3, "plain_ms": us["plain"] / 1e3,
        "library_ms": us["cudnn"] / 1e3,
        "bound_ms": summary["kernel_layers_bound_us"] / 1e3,
        "bound_by": ("operations" if 2 * ops_bound >=
                     summary["kernel_layers_bound_us"] else "bytes"),
        "cold_ms": cold["kernel"] / 1e3,
        "library_cold_ms": cold["cudnn"] / 1e3,
        "times_are": "sums over the 9 flagship layers with C_in >= 8 of mult "
                     "x device time per launch (library: F.conv2d); ms and "
                     "library_ms warm in L2, the cold_ms pair with L2 "
                     "flushed before each launch",
        "paths": {r["layer"]: r["plan"]["path"] for r in taken},
        "shape": "bench.conv_down.LAYERS, batch 2, bf16"}
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "semantic_segmentation_torch" / "kernels").is_dir():
        print(f"chip_smoke: no semantic_segmentation_torch package beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from semantic_segmentation_torch.bench.timing import card_line

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {card} | torch: {name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    from semantic_segmentation_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    print(f"[build] {sorted(built) or 'all cached'} in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3-5. parity phases in full float32 (cuDNN's TF32 default off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from semantic_segmentation_torch.models.pix2pix.networks import define_G
    from semantic_segmentation_torch.ops import augment
    from semantic_segmentation_torch.ops.nas import init_arch_params
    init = torch.Generator().manual_seed(0)
    G = define_G(1, 1, "unet_256", 64, True, init).to(dev).eval()
    arch = init_arch_params(init)["upconv"].to(dev)
    records, timers, gen_img = phase_kernels(torch, dev, G, arch)
    gen = torch.Generator(device=dev).manual_seed(1)
    from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
    ds = SyntheticSegDataset(n=2, size=256, seed=4)
    m = torch.stack([torch.from_numpy(ds[i]["mask"]) for i in range(2)])
    m = m.float().to(dev)
    phase_fake_branch(torch, dev, G, arch, m,
                      augment.sample_affine_batch(2, 256, 256, gen))
    del G
    phase_small_engine(torch)
    torch.backends.cudnn.allow_tf32 = True     # the trainer's defaults
    torch.cuda.empty_cache()

    # 6. stage-1 trainer; 7. the flagship trainer from its checkpoint
    p2p_stats, ckpt = phase_pix2pix(torch)
    print(f"[pix2pix] {card}: " + json.dumps(p2p_stats))
    torch.cuda.empty_cache()
    check_start(torch, ckpt)
    paths = {"pix2pix_trainer": p2p_stats["launches"]}
    for label in TRAINERS:
        stats = phase_trainer(torch, ckpt, label)
        print(f"[{label}] {card}: " + json.dumps(stats))
        paths[label] = stats["launches"]

    # 8. timing and the benchmark paths
    phase_timing(records, timers)
    paths.update(phase_benches(torch, records, gen_img))
    main_path = {"warp_affine": "end2end_trainer",
                 "equalize_uint8": "end2end_trainer",
                 "histogram256": "bench_kernels",
                 "conv_down4": "bench_conv_down"}
    for k, rec in records.items():
        rec["main_path"] = main_path[k]
        rec["launches"] = paths[main_path[k]][k]
        rec["launches_by_path"] = {p: c[k] for p, c in paths.items()}
    print(json.dumps({"kernels": list(records.values())}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
