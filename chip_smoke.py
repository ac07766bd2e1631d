#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``semantic_segmentation_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which stops the script with a nonzero exit on failure:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA source of ``semantic_segmentation_torch/kernels/csrc``
   compiled with nvcc (one process each, in parallel) into build/kernels/;
3. kernels against their plain PyTorch versions on the card, TF32 off:
   - warp: (2, 256, 256, 1) and (2, 224, 224, 1) binary masks under
     ``sample_affine_batch`` draws and (2, 256, 256, 3) random floats,
     max |err| 0 and an identical > 0.1 mask; identity and flip matrices
     exact;
   - equalize and histogram (one thread-block cluster per image): each
     bit-exact against its plain version (the histogram also against
     ``np.bincount``) on random uint8 (2, 256, 256, 1), a constant plane, a
     two-value plane and the uint8 image of a full-width unet_256
     generator's output (the histogram also at (4, 256, 256)), at c = 3
     (the ISIC family's interleaved RGB: random bytes and an RGB
     generator's image at (2, 256, 256, 3) and (2, 224, 224, 3)), at hw
     off multiples of 16, on views 1 byte off a 16-byte boundary, and at
     (64, 512, 512); each call one launch of one kernel;
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
   (``end2end_nas``), and ``decay_only`` with DeepLabV3 at layers 1-1-1-1
   (its ASPP dropout masks drawn on the CPU and injected); losses within
   rtol 1e-3, arch tables within 1e-6 (1e-5 for ``unroll``); the darts
   hypergradient exactly 0 on both devices and its arch tables equal to
   ``decay_only``'s, the unroll one finite and > 0;
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
7b. the real-data path at the same full width from the same checkpoint:
   PNG folders written under build/ from ``SyntheticSegDataset`` arrays (a
   JSRT layout of 16 pairs at 300^2, so that the loader resizes, and an
   OOD set of 8 pairs with the ``_mask`` suffix; PIL decodes them on the
   host); the flagship (``decay_only``) trained from the folder for 20
   iterations with ``--data.n_test=7``, ``--data.ood_roots=sz:...`` and
   ``--run.save_every=10`` (warp and equalize 20 launches, finite test and
   OOD Dice, ``metrics.jsonl``, checkpoint steps 10 and 20; steady it/s and
   peak memory beside phase 7's); a second such run for the run-to-run
   spread; resume: a 10-iteration run resumed at 10 runs nothing and holds
   the saved engine and host state bit for bit, resumed to 20 its chunk's
   losses and val score agree with the uninterrupted run within 4 x the
   spread of the uninterrupted runs, and the fast-forwarded batch-index
   streams equal the straight ones exactly; ``test_seg.run`` on the run's
   ``unet_best.pt`` gives the trainer's test and OOD Dice within 1e-6; and
   ``train_unet`` for 20 steps on the folder (finite losses, best_val, a
   checkpoint, no kernel launched, its step rate);
7c. the ISIC family (``semantic_segmentation_torch`` presets
   ``pix2pix_isic``, ``end2end_isic``, ``end2end_isic224``): (a) an
   ISIC-layout folder of RGB PNGs (a dark lesion of about 28% of the image
   on noisy skin tones) and binary masks at 300^2 (the loader resizes, the
   masks NEAREST) with a test split; ``pix2pix_isic`` (RGB, ``output_nc``
   3) for 10 steps from it, its checkpoint saved; (b) ``end2end_isic`` at
   full width (256^2, batch 2, unet_256, ngf = ndf = 64, U-Net base 64,
   bf16, ``decay_only``, ``--model.output_nc=3``, the photometric fake
   chain, the Jaccard loss) from that checkpoint and folder for 20
   iterations: its test Jaccard at least 0.1 above an all-lesion net's
   (the net learnt the lesion), and ``test_seg`` on its ``unet_best.pt``
   gives the trainer's test Jaccard within 1e-6; (c) ``end2end_isic224``
   at full width on synthetic data (224^2, batch 2, resnet_9blocks ngf 64,
   D ndf 64, the lite Swin-UNet: embed 96, depths 2-2-2-2, heads
   3-6-12-24, window 7, drop-path 0.2) for 20 iterations under the
   preset's own ``darts`` (its hypergradient exactly 0 on every chunk),
   then under ``decay_only`` for 20, four more ``decay_only`` runs and a
   ``--model.use_checkpoint=true`` one of 10 iterations from the same seed
   (the same draws): the darts run's and the recomputed run's losses after
   10 iterations each within 4 x the largest relative gap between the
   five ``decay_only`` runs' (the bound of 7b's resume check; the path is
   not bit-for-bit deterministic on the card).
   For (b) and (c): finite losses, steady it/s, peak bytes, and the warp
   and equalize launches (one each per unet inner step: 20 and 20 in 20
   iterations, 40 and 40 under ``darts``; histogram and down-conv 0);
7d. the segmenter zoo, at the same full width from phase 6's checkpoint:
   (a) the flagship (``end2end_jsrt``, ``decay_only``) with
   ``--model.seg_model=deeplab`` (DeepLabV3, ResNet-50 at 3-4-6-3) for 20
   iterations, twice for the run-to-run spread, and for 10 iterations
   from a net one ulp away (one scale of the head's BN) for how far such a
   difference grows (finite losses, best_val and test Dice, warp and
   equalize one launch an iteration, histogram and down-conv 0; steady
   it/s and peak beside phase 7's); (b) remat: one iteration of the
   engine ``train()`` builds, from the same state with and without
   ``--model.remat=true``, gives the same losses and BN statistics bit for
   bit and parameters within 20 lr; the same run as (a) with remat for 20
   iterations has a lower peak (its losses after 10 are printed beside
   (a)'s spread and one-ulp gap, not held: the run is chaotic); and the
   U-Net flagship with remat gives phase 7's losses after 20 iterations
   bit for bit; (c) the engine ``train()``
   builds with
   ``--optim.accumulate=2``, stepped 10 iterations as ``train()`` steps
   it: the segmenter's parameters move on every second inner step only;
   (d) ``test_seg`` on (a)'s ``unet_best.pt`` gives (a)'s test Dice within
   1e-6, and ``export_seg`` writes it as a ``torch.export`` artifact (bf16,
   symbolic batch) whose loaded program agrees with the eager predict head
   within 1e-5 at batches 1 and 3 on the card; (e) ``train_unet`` for 20
   steps with ``--model.seg_model=deeplabv2`` (ResNet-101, multi-grid,
   output stride 16) and with ``--model.bilinear=true`` (finite losses, a
   best_val, no kernel launched; steps/s and peak);
8. timing, after the trainers so that the profiler cannot slow them, in a
   fresh child process (in a process that had run the trainers,
   torch.profiler was seen to drop device events from its traces; a fresh
   process did not), which repeats phase 3's kernel checks to make its
   inputs and then times: the
   warp's and the equalize's device time (torch.profiler) and wrapper call
   time (CUDA events) on the inputs of phase 3, beside their plain
   versions' and the library call's (``F.grid_sample`` for the warp, at
   256^2 and 224^2), and
   the two benchmark entry points that run the other kernels:
   ``bench.kernels`` (the histogram's path, and ``time_cases``: the
   equalize at (2, 256, 256, 1) on the generator image and random bytes,
   at (2, 256, 256, 3) and (2, 224, 224, 3) on an RGB generator's image
   and random bytes, warm and cold,
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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN_ITERS, MODE_ITERS, VALID_STEP, PIX2PIX_STEPS = 20, 20, 10, 20
SAVE_DIR = ROOT / "build" / "chip_smoke_run"
# phase 8 runs in a child process: ``python3 chip_smoke.py --timing-child``
# writes its kernel records and launch counts to TIMING_FILE
TIMING_ARG = "--timing-child"
TIMING_FILE = ROOT / "build" / "chip_smoke_timing.json"


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
    ds224 = SyntheticSegDataset(n=2, size=224, seed=5)
    m224 = torch.from_numpy(np.stack([ds224[i]["mask"] for i in range(2)]))
    m224 = m224.float().to(dev)                              # (2,224,224,1)
    mats224 = augment.sample_affine_batch(2, 224, 224, gen)
    k224 = augment.warp_affine_batch(m224, mats224)
    r224 = augment.warp_affine_batch_ref(m224, mats224)
    err_224 = (k224 - r224).abs().max().item()
    check(err_224 == 0.0, f"warp masks 224^2: max |err| {err_224}")
    check(torch.equal(k224 > 0.1, r224 > 0.1), "warp masks 224^2: > 0.1 "
          "differs")
    print(f"[kernels] warp: max|err| masks {err_mask:.3e} masks 224^2 "
          f"{err_224:.3e} rgb {err_rgb:.3e}, > 0.1 masks identical, "
          f"identity and flip exact")

    # library yardstick: grid_sample on the same warp (align_corners=True
    # maps pixel centres as the kernel does)
    def lib_warp_fn(x, m):
        size = x.shape[1]
        inv = torch.linalg.inv(m)
        ys, xs = torch.meshgrid(torch.arange(float(size), device=dev),
                                torch.arange(float(size), device=dev),
                                indexing="ij")
        sx = inv[:, 0, 0, None, None] * xs + (inv[:, 0, 1, None, None] * ys
                                              + inv[:, 0, 2, None, None])
        sy = inv[:, 1, 0, None, None] * xs + (inv[:, 1, 1, None, None] * ys
                                              + inv[:, 1, 2, None, None])
        half = (size - 1) / 2.0
        grid = torch.stack([sx / half - 1.0, sy / half - 1.0], -1)
        x_nchw = x.permute(0, 3, 1, 2)
        return lambda: F.grid_sample(x_nchw, grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

    lib_warp = lib_warp_fn(masks, mats)
    lib_warp224 = lib_warp_fn(m224, mats224)
    err_lib = (lib_warp().permute(0, 2, 3, 1) - out_r).abs().max().item()
    err_lib224 = (lib_warp224().permute(0, 2, 3, 1)
                  - r224).abs().max().item()
    numel = masks.numel()
    # image read + output written (f32) + the (2, 3, 3) f32 matrices;
    # ~20 f32 operations per output
    b, why = bound_ms(2 * 4 * numel + mats.numel() * 4, 20 * numel)

    records["warp_affine"] = {
        "name": "warp_affine", "route": "cuda",
        "source": "semantic_segmentation_torch/kernels/csrc/warp_affine.cu",
        "replaces": "semantic_segmentation_tpu/ops/pallas_kernels.py:243",
        "max_abs_err": max(err_mask, err_rgb, err_224),
        "bound_ms": b, "bound_us": b * 1e3, "bound_by": why,
        "shape": [2, 256, 256, 1], "library_max_abs_err": err_lib}
    timers["warp_affine"] = (
        "warp_affine_kernel", lambda: augment.warp_affine_batch(masks, mats),
        lambda: augment.warp_affine_batch_ref(masks, mats), lib_warp)
    # the ISIC224 trainer's shape, timed as a case of the warp's record
    b224, why224 = bound_ms(2 * 4 * m224.numel() + mats224.numel() * 4,
                            20 * m224.numel())
    records["warp_affine"]["cases"] = [{
        "shape": [2, 224, 224, 1], "max_abs_err": err_224,
        "bound_ms": b224, "bound_by": why224,
        "library_max_abs_err": err_lib224}]
    timers["warp_affine@224"] = (
        "warp_affine_kernel",
        lambda: augment.warp_affine_batch(m224, mats224),
        lambda: augment.warp_affine_batch_ref(m224, mats224), lib_warp224)

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
    from semantic_segmentation_torch.bench.kernels import (SYMBOLS, family,
                                                           generator_image)
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
    # the ISIC family's RGB fakes: unet_256 at 256^2, resnet_9blocks at 224^2
    cases["generator c=3"] = generator_image(dev, 256, 3)
    cases["generator c=3 224^2"] = generator_image(dev, 224, 3)
    cases["random c=3 224^2"] = family("random", (2, 224, 224, 3), dev)
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
        kernel, _, case = name.partition("@")
        # "kernel@case": a further shape, timed into the kernel's cases
        rec = records[kernel]["cases"][0] if case else records[kernel]
        rec.update({
            "ms": device_ms(kernel_fn, 200, symbol),
            "wrapper_call_ms": time_ms(kernel_fn, 200),
            "plain_ms": device_ms(plain_fn, 50),
            "library_ms": device_ms(lib_fn, 200) if lib_fn else None})
        print(f"[timing] {name}: " + json.dumps(rec))


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


SMALL_MODES = {   # label: (extra argv, preset, arch tolerance card vs CPU,
                  # iterations)
    "decay_only": ([], "end2end_jsrt", 1e-6, 3),
    "darts": (["--engine.hypergrad=darts"], "end2end_jsrt", 1e-6, 3),
    "unroll": ([], "end2end_nas", 1e-5, 3),
    # DeepLabV3 at layers 1-1-1-1 (phase 7d's segmenter, cut in depth):
    # one iteration, since its BN over the pooled ASPP branch's two values
    # a channel lets RMSprop's first steps part the devices' trajectories
    # (8e-4 and 2.2e-3 apart after the second and third on an H100)
    "decay_only_deeplab": (["--model.seg_model=deeplab"], "end2end_jsrt",
                           1e-6, 1),
}
SMALL_DEEPLAB_LAYERS = (1, 1, 1, 1)


def _small_engine_run(torch, dev, argv, preset, iters):
    """``iters`` engine iterations at 32^2 on ``dev``: the index streams of
    the trainer, and augment matrices (and DeepLabV3's ASPP dropout masks)
    drawn on the CPU from one seed for every phase (unroll, hypergradient,
    replay), the same for every mode. Returns (metrics per iteration, arch
    tables on the CPU)."""
    import semantic_segmentation_torch.train.train_end2end as e2e
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
    deeplab = cfg.model.seg_model == "deeplab"
    plain_kwargs = e2e.seg_model_kwargs
    if deeplab:       # the config has no depth option: cut it here
        e2e.seg_model_kwargs = lambda c: {"layers": SMALL_DEEPLAB_LAYERS}
    try:
        engine, p2p, seg = build_engine(cfg, dev)
    finally:
        e2e.seg_model_kwargs = plain_kwargs
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
        draws = {}
        for ph in ("unroll", "hyper", "replay"):
            d = {"affine": sample_affine_batch(bs, size, size, gen).to(dev)}
            if deeplab:
                for k in ("seg_real", "seg_fake"):
                    d[k] = {n: m.to(dev) for n, m in seg.net.draw_dropout(
                        (bs, 1, size, size), gen, "cpu").items()}
            draws[ph] = [{"unet": d}]
        m = engine.engine_step(
            [{n: take_batch(data, next(s)) for n, s in streams.items()}],
            take_batch(val, next(val_stream)), draws)
        out.append({k: float(v) for k, v in m.items()})
    return out, {k: v.cpu() for k, v in p2p.arch.items()}


def phase_small_engine(torch, devices=("cpu", "cuda")):
    """Three engine iterations at 32^2 in float32 in each of ``decay_only``,
    ``darts`` (the reference wiring) and ``unroll`` (``end2end_nas``), and
    one of ``decay_only`` with DeepLabV3, on the card and on the CPU (where every op takes its plain path, the path the
    CPU tests hold against the JAX package), from the same seed, batches and
    augment matrices. Losses agree within rtol 1e-3 (the uint8 chain may
    move a quantisation level), the arch tables within 1e-6 (1e-5 for
    ``unroll``, whose hypergradient differs in f32 noise between the
    devices). ``darts``' hypergradient is exactly 0 on both devices and its
    arch tables equal ``decay_only``'s; ``unroll``'s norm is finite and
    > 0."""
    arch_by_mode = {}
    for label, (argv, preset, tol, iters) in SMALL_MODES.items():
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

DATA_DIR = ROOT / "build" / "chip_smoke_data"
RESUME_KEYS = ("loss_netG", "loss_netD", "loss_unet", "replay_loss_netG",
               "replay_loss_netD", "replay_loss_unet", "val_score")


def write_folders():
    """A JSRT-layout folder (16 pairs at 300^2) and an OOD folder (8 pairs,
    ``_mask`` suffix) of PNGs made from ``SyntheticSegDataset`` arrays."""
    import shutil

    import numpy as np
    try:
        from PIL import Image
    except ImportError:
        fail("PIL is not installed: the folder loader cannot decode")
    from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    roots = {}
    for name, n, seed, suffix in (("jsrt", 16, 21, ""), ("sz", 8, 22,
                                                          "_mask")):
        root = DATA_DIR / name
        (root / "Images").mkdir(parents=True)
        (root / "Masks").mkdir()
        ds = SyntheticSegDataset(n=n, size=300, seed=seed)
        for i in range(n):
            item = ds[i]
            Image.fromarray((item["image"][..., 0] * 255).astype(np.uint8),
                            "L").save(root / "Images" / f"case{i:02d}.png")
            Image.fromarray((item["mask"][..., 0] * 255).astype(np.uint8),
                            "L").save(root / "Masks" /
                                      f"case{i:02d}{suffix}.png")
        roots[name] = root
    return roots


def _folder_cfg(roots, ckpt, name: str, *extra):
    from semantic_segmentation_torch.core.config import parse_config
    return parse_config([f"--data.dataroot={roots['jsrt']}",
                         "--data.n_test=7",
                         f"--data.ood_roots=sz:{roots['sz']}:_mask",
                         f"--engine.valid_step={VALID_STEP}",
                         f"--run.save_every={VALID_STEP}",
                         f"--run.pretrained_pix2pix={ckpt}",
                         f"--run.save_dir={SAVE_DIR}", f"--run.name={name}",
                         *extra], preset="end2end_jsrt")


def _folder_train(torch, cfg, iters: int):
    """train() of ``cfg`` on the card; (engine, results, launches)."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.train.train_end2end import train
    kernels.reset_launches()
    engine, results = train(cfg, train_iters=iters, device="cuda")
    torch.cuda.synchronize()
    return engine, results, dict(kernels.LAUNCHES)


def _rel_gaps(a: dict, b: dict) -> dict:
    return {k: abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for k in RESUME_KEYS}


def _same_tree(torch, a, b, path="state"):
    """Equal structure; tensors bit for bit, other leaves ==."""
    if isinstance(a, dict):
        check(isinstance(b, dict) and a.keys() == b.keys(),
              f"resume: {path} keys differ")
        for k in a:
            _same_tree(torch, a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"resume: {path} lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(torch, x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        check(torch.equal(a.cpu(), b.cpu()), f"resume: {path} differs")
    else:
        check(a == b, f"resume: {path}: {a} != {b}")


def phase_real_data(torch, ckpt, synthetic: dict):
    """Phase 7b (module docstring). Returns the folder run's stats, with
    its launches."""
    import shutil

    import numpy as np

    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.train import test_seg, train_unet
    from semantic_segmentation_torch.train.train_end2end import index_streams
    t_data = time.perf_counter()
    roots = write_folders()
    data_s = time.perf_counter() - t_data

    # the flagship from the folder
    cfg = _folder_cfg(roots, ckpt, "folder-a")
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.base_features, m.compute_dtype, cfg.engine.hypergrad) ==
          (256, 2, "unet_256", 64, 64, 64, "bfloat16", "decay_only"),
          "folder: not the full-width end2end_jsrt configuration")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, run_a, launches = _folder_train(torch, cfg, TRAIN_ITERS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {"warp_affine": TRAIN_ITERS, "equalize_uint8": TRAIN_ITERS,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"folder: launches {launches}, not {want}")
    for k in ("best_val", "test_dice", "ood_sz"):
        check(k in run_a and math.isfinite(run_a[k]),
              f"folder: no finite {k}: {run_a}")
    run_dir = SAVE_DIR / cfg.run.name
    check((run_dir / "metrics.jsonl").stat().st_size > 0,
          "folder: metrics.jsonl not written")
    steps = sorted(int(s.name) for s in (run_dir / "ckpt").iterdir()
                   if s.name.isdigit())
    check(steps == [10, 20], f"folder: checkpoint steps {steps}")
    its = run_a["chunks"][1]["iters"] / run_a["chunks"][1]["seconds"]
    stats = {"iters": TRAIN_ITERS, "wall_s": wall,
             "data_write_s": data_s,
             "steady_it_per_s": its, "steady_iter_ms": 1e3 / its,
             "peak_mem_bytes": peak,
             "synthetic_steady_it_per_s": synthetic["steady_it_per_s"],
             "synthetic_peak_mem_bytes": synthetic["peak_mem_bytes"],
             "best_val": run_a["best_val"], "test_dice": run_a["test_dice"],
             "ood_sz": run_a["ood_sz"], "checkpoint_steps": steps,
             "launches": launches}
    print(f"[folder] steady {its:.2f} it/s, peak {peak} bytes; phase 7 on "
          f"synthetic data: {synthetic['steady_it_per_s']:.2f} it/s, "
          f"{synthetic['peak_mem_bytes']} bytes; test_dice "
          f"{run_a['test_dice']:.4f} ood_sz {run_a['ood_sz']:.4f}")
    del engine
    torch.cuda.empty_cache()

    # the run-to-run spread: a second uninterrupted run, and a 10-iteration
    # run whose first chunk is a third sample
    engine, run_b, _ = _folder_train(
        torch, _folder_cfg(roots, ckpt, "folder-b"), TRAIN_ITERS)
    del engine
    shutil.rmtree(SAVE_DIR / "folder-b")
    engine, run_c, _ = _folder_train(
        torch, _folder_cfg(roots, ckpt, "folder-c"), VALID_STEP)
    del engine
    torch.cuda.empty_cache()
    samples = [_rel_gaps(run_a["chunks"][1], run_b["chunks"][1]),
               _rel_gaps(run_a["chunks"][0], run_b["chunks"][0]),
               _rel_gaps(run_a["chunks"][0], run_c["chunks"][0])]
    spread = max(max(s.values()) for s in samples)
    bound = 4.0 * spread
    print(f"[resume] run-to-run spread of uninterrupted runs (largest "
          f"relative gap of {', '.join(RESUME_KEYS)} over 3 pairs of "
          f"chunks): {spread:.3e}; bound for the resumed run 4 x that = "
          f"{bound:.3e}")

    # (a) resumed at the saved iteration: nothing runs, the state is as saved
    step_file = SAVE_DIR / "folder-c" / "ckpt" / str(VALID_STEP) / "state.pt"
    saved = torch.load(step_file, map_location="cpu", weights_only=True)
    engine, run_r, launches_r = _folder_train(
        torch, _folder_cfg(roots, ckpt, "folder-c", "--run.resume=true"),
        VALID_STEP)
    check(run_r["chunks"] == [] and engine.step == VALID_STEP
          and not any(launches_r.values()),
          f"resume (a): iterations ran: {run_r['chunks']}, {launches_r}")
    _same_tree(torch, saved["engine"], engine.state_dict(), "engine")
    _same_tree(torch, saved, torch.load(step_file, map_location="cpu",
                                        weights_only=True))
    check(run_r["best_val"] == saved["host"]["best_val"],
          "resume (a): best_val differs")
    del engine, saved
    print("[resume] (a) resumed at iteration 10: no iteration ran; "
          "parameters, BN buffers, optimizer states, arch tables, both "
          "generators, best_val, the plateau and the best U-Net equal the "
          "checkpoint bit for bit")

    # the fast-forwarded streams against the straight ones
    n_train, n_val = cfg.data.n_train, cfg.data.n_val
    fwd, fwd_val = index_streams(cfg, n_train, n_val, start=VALID_STEP)
    straight, straight_val = index_streams(cfg, n_train, n_val)
    K = cfg.engine.unroll_steps
    for _ in range(VALID_STEP * K):
        for s in straight.values():
            next(s)
    for _ in range(VALID_STEP):
        next(straight_val)
    for _ in range(2 * VALID_STEP * K):
        for name in fwd:
            check(np.array_equal(next(fwd[name]), next(straight[name])),
                  f"resume: the fast-forwarded {name} stream differs")
    for _ in range(2 * VALID_STEP):
        check(np.array_equal(next(fwd_val), next(straight_val)),
              "resume: the fast-forwarded validation stream differs")

    # (b) resumed to 20 against the uninterrupted run's second chunk
    engine, run_r, launches_r = _folder_train(
        torch, _folder_cfg(roots, ckpt, "folder-c", "--run.resume=true"),
        TRAIN_ITERS)
    del engine
    torch.cuda.empty_cache()
    check([c["it"] for c in run_r["chunks"]] == [TRAIN_ITERS]
          and launches_r["warp_affine"] == TRAIN_ITERS - VALID_STEP,
          f"resume (b): chunks {run_r['chunks']}, launches {launches_r}")
    gaps = _rel_gaps(run_a["chunks"][1], run_r["chunks"][0])
    check(max(gaps.values()) <= bound,
          f"resume (b): relative gaps {gaps} beyond {bound:.3e}")
    shutil.rmtree(SAVE_DIR / "folder-c")
    print(f"[resume] (b) resumed to 20: largest relative gap to the "
          f"uninterrupted run {max(gaps.values()):.3e} (<= {bound:.3e}); "
          f"the fast-forwarded batch-index streams equal the straight ones")
    stats.update(resume_spread=spread, resume_bound=bound,
                 resume_gap=max(gaps.values()))

    # test_seg on the run's best U-Net
    scored = test_seg.run(cfg, model_file=str(run_dir / "unet_best.pt"),
                          device="cuda")
    for k in ("test_dice", "ood_sz"):
        check(abs(scored[k] - run_a[k]) <= 1e-6,
              f"test_seg: {k} {scored[k]} against the trainer's {run_a[k]}")
    shutil.rmtree(run_dir / "ckpt")
    print(f"[test_seg] {scored} equal the trainer's within 1e-6")

    # the supervised baseline on the folder
    from semantic_segmentation_torch.core.config import parse_config
    ucfg = parse_config([f"--data.dataroot={roots['jsrt']}",
                         "--data.n_test=7",
                         f"--data.ood_roots=sz:{roots['sz']}:_mask",
                         f"--engine.valid_step={VALID_STEP}",
                         f"--run.save_dir={SAVE_DIR}", "--run.name=unet"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    seg, run_u = train_unet.train(ucfg, train_iters=TRAIN_ITERS,
                                  device="cuda")
    torch.cuda.synchronize()
    launches_u = dict(kernels.LAUNCHES)
    check(not any(launches_u.values()),
          f"train_unet: the path runs no kernel, launches {launches_u}")
    check(all(math.isfinite(r["loss"]) for r in run_u["log"])
          and len(run_u["log"]) == TRAIN_ITERS // VALID_STEP,
          f"train_unet: losses {run_u['log']}")
    check(math.isfinite(run_u["best_val"]) and run_u["best_val"] > 0.0
          and any((SAVE_DIR / "unet" / "ckpt").iterdir()),
          f"train_unet: best_val {run_u['best_val']} or no checkpoint")
    rec = run_u["log"][1]
    stats["train_unet"] = {
        "steps": TRAIN_ITERS, "steady_steps_per_s": rec["steps"] /
        rec["seconds"], "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "best_val": run_u["best_val"], "test_dice": run_u["test_dice"],
        "ood_sz": run_u["ood_sz"], "launches": launches_u}
    print(f"[train_unet] " + json.dumps(stats["train_unet"]))
    del seg
    torch.cuda.empty_cache()
    return stats


ISIC_DIR = DATA_DIR / "isic"
ISIC_SPLIT = ["--data.n_train=16", "--data.n_val=4"]
ISIC_PIX2PIX_STEPS, ISIC_CKPT_ITERS = 10, 10
ISIC_LOSSES = ("loss_netG", "loss_netD", "loss_unet", "replay_loss_netG",
               "replay_loss_netD", "replay_loss_unet")


def write_isic_folder(n: int = 28, size: int = 300):
    """An ISIC-layout folder at ``size``^2: RGB PNGs of a dark-brown lesion
    (one rotated ellipse, about 28% of the image) on noisy skin tones, and
    its 0/255 mask. The contrast lets a U-Net learn the lesion in the
    trainer's 20 iterations, so that its test Jaccard tells its net from a
    trivial one."""
    import shutil

    import numpy as np
    from PIL import Image
    shutil.rmtree(ISIC_DIR, ignore_errors=True)
    (ISIC_DIR / "Images").mkdir(parents=True)
    (ISIC_DIR / "Masks").mkdir()
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        cx, cy = rng.uniform(0.4, 0.6, 2)
        ax, ay = rng.uniform(0.25, 0.35, 2)
        th = rng.uniform(-0.6, 0.6)
        xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        lesion = (xr / ax) ** 2 + (yr / ay) ** 2 < 1
        skin = rng.uniform(0.9, 1.1) * np.array([225, 180, 150], np.float32)
        brown = rng.uniform(0.8, 1.2) * np.array([110, 65, 45], np.float32)
        rgb = np.where(lesion[..., None], brown, skin) + rng.normal(
            0.0, 12.0, (size, size, 3))
        Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8), "RGB").save(
            ISIC_DIR / "Images" / f"ISIC_{i:07d}.png")
        Image.fromarray((lesion * 255).astype(np.uint8), "L").save(
            ISIC_DIR / "Masks" / f"ISIC_{i:07d}.png")
    return ISIC_DIR


def trivial_jaccard(torch, cfg) -> float:
    """The test Jaccard of a net that marks every pixel lesion (the best of
    the two constant nets: one that marks none scores about 0)."""
    from semantic_segmentation_torch.ops.losses import jaccard_index
    from semantic_segmentation_torch.train.common import load_splits
    masks = torch.from_numpy(load_splits(cfg)["test"]["mask"][..., 0])
    return float(jaccard_index(masks, torch.ones_like(masks)))


def _isic_train(torch, cfg, iters: int, label: str):
    """train() of an ISIC configuration on the card: finite losses and
    scores, the warp and the equalize launched once per unet inner step
    (``decay_only``: one per iteration; ``darts``: two, the unroll's and
    the replay's), the other kernels never; the darts hypergradient
    exactly 0 (outer loss on the unet only, child netG). Returns
    (results, stats)."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.train.train_end2end import train
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train(cfg, train_iters=iters, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    darts = cfg.engine.hypergrad == "darts"
    unet_steps = iters * (2 if darts else 1)
    want = {"warp_affine": unet_steps, "equalize_uint8": unet_steps,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"{label}: launches {launches}, not {want}")
    for c in results["chunks"]:
        for k in ISIC_LOSSES + ("val_score",) + (("outer_loss",) if darts
                                                 else ()):
            check(math.isfinite(c[k]), f"{label}: {k} not finite: {c}")
        check(not darts or c["arch_grad_norm"] == 0.0,
              f"{label}: darts hypergradient not exactly 0: {c}")
    check(math.isfinite(results["best_val"]),
          f"{label}: no best_val: {results}")
    del engine
    torch.cuda.empty_cache()
    steady = results["chunks"][1:] or results["chunks"]
    its = sum(c["iters"] for c in steady) / sum(c["seconds"] for c in steady)
    return results, {"hypergrad": cfg.engine.hypergrad,
                     "iters": iters, "wall_s": wall,
                     "steady_it_per_s": its, "steady_iter_ms": 1e3 / its,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "best_val": results["best_val"], "launches": launches}


def phase_isic(torch):
    """Phase 7c (module docstring). Returns {label: stats}."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import test_seg, train_pix2pix
    root = write_isic_folder()
    out = {}

    # (a) stage 1 on the RGB folder
    cfg = parse_config([f"--data.dataroot={root}", *ISIC_SPLIT,
                        "--run.log_every=5", f"--run.save_dir={SAVE_DIR}"],
                       preset="pix2pix_isic")
    m = cfg.model
    check((cfg.data.dataset, cfg.data.image_size, cfg.data.batch_size,
           m.netG, m.ngf, m.ndf, m.output_nc, m.compute_dtype) ==
          ("isic", 256, 2, "unet_256", 64, 64, 3, "bfloat16"),
          "isic pix2pix: not the full-width pix2pix_isic configuration")
    kernels.reset_launches()
    model, res = train_pix2pix.train(cfg, train_iters=ISIC_PIX2PIX_STEPS,
                                     device="cuda")
    check(not any(kernels.LAUNCHES.values()),
          f"isic pix2pix: launches {dict(kernels.LAUNCHES)}")
    check(all(math.isfinite(r[k]) for r in res["log"]
              for k in ("loss_G", "loss_D")),
          f"isic pix2pix: losses {res['log']}")
    ckpt = SAVE_DIR / cfg.run.name
    del model
    torch.cuda.empty_cache()
    print(f"[isic pix2pix] {res['steps']} steps at output_nc 3 from "
          f"{root}: last losses {res['log'][-1]}")

    # (b) end2end_isic at full width from the folder and the checkpoint
    cfg = parse_config([f"--data.dataroot={root}", *ISIC_SPLIT,
                        "--data.n_test=8", "--model.output_nc=3",
                        f"--engine.valid_step={VALID_STEP}",
                        f"--run.pretrained_pix2pix={ckpt}",
                        "--run.final_checkpoint=false",
                        f"--run.save_dir={SAVE_DIR}"], preset="end2end_isic")
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.base_features, m.output_nc, m.compute_dtype,
           cfg.engine.hypergrad, cfg.engine.fake_postprocess) ==
          (256, 2, "unet_256", 64, 64, 64, 3, "bfloat16", "decay_only",
           "photometric"), "isic: not the full-width end2end_isic "
          "configuration")
    results, stats = _isic_train(torch, cfg, TRAIN_ITERS, "isic")
    check("test_jaccard" in results and math.isfinite(
        results["test_jaccard"]), f"isic: no test_jaccard: {results}")
    # the net learnt the lesion: a constant net could not tell test_seg's
    # loaded net from another
    trivial = trivial_jaccard(torch, cfg)
    check(results["test_jaccard"] >= trivial + 0.1,
          f"isic: test Jaccard {results['test_jaccard']} not above the "
          f"all-lesion net's {trivial} + 0.1")
    scored = test_seg.run(cfg, model_file=str(SAVE_DIR / cfg.run.name /
                                              "unet_best.pt"), device="cuda")
    check(abs(scored["test_jaccard"] - results["test_jaccard"]) <= 1e-6,
          f"isic test_seg: {scored} against the trainer's "
          f"{results['test_jaccard']}")
    stats.update(test_jaccard=results["test_jaccard"],
                 test_seg_jaccard=scored["test_jaccard"],
                 all_lesion_jaccard=trivial)
    out["isic_trainer"] = stats
    print(f"[isic] steady {stats['steady_it_per_s']:.2f} it/s, peak "
          f"{stats['peak_mem_bytes']} bytes, launches {stats['launches']}; "
          f"test_seg Jaccard {scored['test_jaccard']:.6f} equals the "
          f"trainer's {results['test_jaccard']:.6f} (an all-lesion net "
          f"scores {trivial:.6f})")

    # (c) end2end_isic224: ResNet-9 G, the lite Swin-UNet, synthetic data;
    # the preset's own darts, then decay_only runs beside it
    def cfg224(name, *extra):
        return parse_config(["--data.synthetic=true",
                             f"--engine.valid_step={VALID_STEP}",
                             "--run.final_checkpoint=false",
                             f"--run.save_dir={SAVE_DIR}",
                             f"--run.name={name}", *extra],
                            preset="end2end_isic224")
    cfg = cfg224("isic224-darts")
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.seg_model, m.drop_path_rate, m.use_checkpoint, m.compute_dtype,
           cfg.engine.fake_postprocess, cfg.engine.hypergrad) ==
          (224, 2, "resnet_9blocks", 64, 64, "vit", 0.2, False, "bfloat16",
           "photometric", "darts"), "isic224: not the full-width "
          "end2end_isic224 configuration")
    run_d, stats = _isic_train(torch, cfg, TRAIN_ITERS, "isic224")
    decay = ["--engine.hypergrad=decay_only"]
    run_a, decay_stats = _isic_train(torch, cfg224("isic224-a", *decay),
                                     TRAIN_ITERS, "isic224 decay_only")
    plain = [run_a["chunks"][0]] + [
        _isic_train(torch, cfg224(f"isic224-{x}", *decay), ISIC_CKPT_ITERS,
                    f"isic224 decay_only run {x}")[0]["chunks"][0]
        for x in ("b", "c", "d", "e")]
    run_k, ckpt_stats = _isic_train(
        torch, cfg224("isic224-k", *decay, "--model.use_checkpoint=true"),
        ISIC_CKPT_ITERS, "isic224 use_checkpoint")

    def gap(a, b):
        return max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                   for k in ISIC_LOSSES)
    # the spread of the losses over the ten pairs of decay_only runs (with
    # three runs, two of them close by chance gave too small a spread);
    # the darts run (whose hypergradient is 0, so that its replay is
    # decay_only's iteration and its unroll differs by the arch tables,
    # which the ResNet generator does not read) and the recomputed run
    # against each decay_only run within 4 x that, the bound of phase 7b's
    # resume check
    spread = max(gap(a, b) for i, a in enumerate(plain)
                 for b in plain[i + 1:])
    darts_gap = max(gap(p, run_d["chunks"][0]) for p in plain)
    check(darts_gap <= 4.0 * spread, f"isic224: darts moved the losses by "
          f"{darts_gap:.3e} from decay_only's, beyond 4 x the run-to-run "
          f"spread {spread:.3e}: {plain} against {run_d['chunks'][0]}")
    ckpt_gap = max(gap(p, run_k["chunks"][0]) for p in plain)
    check(ckpt_gap <= 4.0 * spread, f"isic224: use_checkpoint moved the "
          f"losses by {ckpt_gap:.3e}, beyond 4 x the run-to-run spread "
          f"{spread:.3e}: {plain} against {run_k['chunks'][0]}")
    stats.update(losses_after_10={
        "darts": {k: run_d["chunks"][0][k] for k in ISIC_LOSSES},
        "use_checkpoint": {k: run_k["chunks"][0][k] for k in ISIC_LOSSES},
        "decay_only": [{k: c[k] for k in ISIC_LOSSES} for c in plain]})
    stats.update(run_to_run_spread=spread, darts_gap=darts_gap,
                 use_checkpoint_gap=ckpt_gap,
                 decay_only_it_per_s=decay_stats["steady_it_per_s"],
                 decay_only_peak_mem_bytes=decay_stats["peak_mem_bytes"],
                 decay_only_launches=decay_stats["launches"],
                 use_checkpoint_peak_mem_bytes=ckpt_stats["peak_mem_bytes"],
                 use_checkpoint_it_per_s=ckpt_stats["steady_it_per_s"])
    out["isic224_trainer"] = stats
    print(f"[isic224] darts (the preset's): steady "
          f"{stats['steady_it_per_s']:.2f} it/s, peak "
          f"{stats['peak_mem_bytes']} bytes, launches {stats['launches']}; "
          f"decay_only: {decay_stats['steady_it_per_s']:.2f} it/s, peak "
          f"{decay_stats['peak_mem_bytes']} bytes, launches "
          f"{decay_stats['launches']}; largest relative loss gap to "
          f"decay_only: darts {darts_gap:.3e}, use_checkpoint "
          f"{ckpt_gap:.3e} (run-to-run spread of {len(plain)} decay_only "
          f"runs {spread:.3e}); use_checkpoint peak "
          f"{ckpt_stats['peak_mem_bytes']} bytes")
    return out


ZOO_LOSSES = ("loss_netG", "loss_netD", "loss_unet", "replay_loss_netG",
              "replay_loss_netD", "replay_loss_unet")
ZOO_ACCUMULATE_ITERS, ZOO_UNET_STEPS = 10, 20


def _zoo_cfg(ckpt, name: str, *extra, seg_model: str = "deeplab"):
    """The flagship (``end2end_jsrt``) at full width with ``seg_model``."""
    from semantic_segmentation_torch.core.config import parse_config
    cfg = parse_config(["--data.synthetic=true",
                        f"--model.seg_model={seg_model}",
                        f"--engine.valid_step={VALID_STEP}",
                        f"--run.pretrained_pix2pix={ckpt}",
                        f"--run.save_dir={SAVE_DIR}", f"--run.name={name}",
                        *extra], preset="end2end_jsrt")
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.compute_dtype, cfg.engine.hypergrad) ==
          (256, 2, "unet_256", 64, 64, "bfloat16", "decay_only"),
          f"zoo {name}: not the full-width end2end_jsrt configuration")
    return cfg


def _zoo_train(torch, cfg, iters: int, label: str, dev="cuda",
               perturb: bool = False):
    """train() of ``cfg`` on the card with its launch, loss and score
    checks; returns (results, stats). ``perturb`` moves one scale of
    DeepLabV3's head BN by one ulp after the net is built."""
    import semantic_segmentation_torch.train.train_end2end as e2e
    from semantic_segmentation_torch import kernels
    plain_build = e2e.build_engine

    def build_engine(*args, **kwargs):
        engine, p2p, seg = plain_build(*args, **kwargs)
        with torch.no_grad():
            w = seg.net.head_bn.weight
            w[0] = torch.nextafter(w[0], w[0] + 1)
        return engine, p2p, seg

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    if perturb:
        e2e.build_engine = build_engine
    try:
        engine, results = e2e.train(cfg, train_iters=iters, device=dev)
    finally:
        e2e.build_engine = plain_build
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"warp_affine": iters, "equalize_uint8": iters,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"{label}: launches {launches}, not {want}")
    for c in results["chunks"]:
        check(all(math.isfinite(c[k]) for k in ZOO_LOSSES + ("val_score",)),
              f"{label}: not finite: {c}")
    check(math.isfinite(results["best_val"])
          and math.isfinite(results.get("test_dice", math.nan)),
          f"{label}: no best_val/test_dice: {results}")
    chunks = results["chunks"][1:] or results["chunks"]
    its = sum(c["iters"] for c in chunks) / sum(c["seconds"] for c in chunks)
    stats = {"seg_model": cfg.model.seg_model, "remat": cfg.model.remat,
             "iters": iters, "steady_it_per_s": its,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "best_val": results["best_val"],
             "test_dice": results["test_dice"],
             "last_losses": {k: results["chunks"][-1][k] for k in ZOO_LOSSES},
             "launches": launches}
    del engine
    torch.cuda.empty_cache()
    return results, stats


def _zoo_accumulate(torch, ckpt, dev="cuda"):
    """(c): the engine ``train()`` builds, at ``optim.accumulate=2``, stepped
    as ``train()`` steps it; the segmenter's parameters move on every
    second inner step only."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.optim import Accumulate
    from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                           to_device_split)
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import (
        build_engine, index_streams)
    cfg = _zoo_cfg(ckpt, "zoo-accumulate", "--optim.accumulate=2")
    engine, _, seg = build_engine(cfg, dev)
    opt = engine.problems[-1].optimizer
    check(isinstance(opt, Accumulate) and opt.every_k == 2,
          f"accumulate: the unet problem's optimizer is {type(opt)}")
    splits = load_splits(cfg)
    train = to_device_split(splits["train"], dev)
    val = to_device_split(splits["val"], dev)
    streams, val_stream = index_streams(cfg, len(splits["train"]["image"]),
                                        len(splits["val"]["image"]))
    kernels.reset_launches()
    moved, losses = [], []
    for _ in range(ZOO_ACCUMULATE_ITERS):
        before = [p.detach().clone() for p in seg.net.parameters()]
        m = engine.engine_step(
            [{n: take_batch(train, next(s)) for n, s in streams.items()}],
            take_batch(val, next(val_stream)))
        losses.append({k: float(v) for k, v in m.items()
                       if k in ZOO_LOSSES})
        moved.append(any(not torch.equal(a, p)
                         for a, p in zip(before, seg.net.parameters())))
        del before
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(all(math.isfinite(v) for d in losses for v in d.values()),
          f"accumulate: losses {losses}")
    want = [i % 2 == 1 for i in range(ZOO_ACCUMULATE_ITERS)]
    check(moved == want, f"accumulate: the segmenter moved at inner steps "
          f"{moved}, not {want}")
    del engine, seg
    torch.cuda.empty_cache()
    return {"iters": ZOO_ACCUMULATE_ITERS, "moved": moved,
            "last_losses": losses[-1], "launches": launches}


def _zoo_remat_step(torch, ckpt, dev="cuda"):
    """One iteration of the engine ``train()`` builds, from the same state
    and batches with and without ``model.remat``: the losses and every BN
    statistic of G, D and DeepLabV3 bit for bit (the statistics fold once,
    not again in the recompute), every parameter within 20 lr (one RMSprop
    step whose sign a rounding flips)."""
    from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                           to_device_split)
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import (
        build_engine, index_streams)
    out = []
    for remat in ("false", "true"):
        cfg = _zoo_cfg(ckpt, "zoo-remat-step", f"--model.remat={remat}")
        engine, _, _ = build_engine(cfg, dev)
        splits = load_splits(cfg)
        train = to_device_split(splits["train"], dev)
        val = to_device_split(splits["val"], dev)
        streams, val_stream = index_streams(
            cfg, len(splits["train"]["image"]), len(splits["val"]["image"]))
        m = engine.engine_step(
            [{n: take_batch(train, next(s)) for n, s in streams.items()}],
            take_batch(val, next(val_stream)))
        out.append(({k: float(v) for k, v in m.items()},
                    {p.name: {k: v.detach().clone() for k, v in
                              p.module.state_dict().items()}
                     for p in engine.problems}))
        del engine
        torch.cuda.empty_cache()
    (m0, s0), (m1, s1) = out
    check(m0 == m1, f"remat step: losses {m1} against {m0}")
    worst, stats_differ = {}, []
    for name in s0:
        for k, v in s0[name].items():
            d = (v.float() - s1[name][k].float()).abs().max().item()
            if "running" in k:
                if d != 0.0:
                    stats_differ.append(f"{name}.{k}")
            else:
                worst[name] = max(worst.get(name, 0.0), d)
    check(not stats_differ, f"remat step: BN statistics differ: "
          f"{stats_differ[:5]}")
    steps = {"netG": cfg.optim.lr, "netD": cfg.optim.lr,
             "unet": cfg.optim.unet_lr}
    check(all(worst[n] <= 20 * steps[n] for n in worst),
          f"remat step: parameters apart by {worst}")
    return {"losses_equal": True, "bn_statistics_equal": True,
            "max_param_diff": worst}


def _zoo_export(torch, cfg, best: Path, dev="cuda"):
    """(d): ``export_seg`` of (a)'s best net on the card, symbolic batch;
    the loaded artifact against the eager predict head at batches 1 and
    3 within 1e-5."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.core.export import (load_exported,
                                                         make_predict_fn)
    from semantic_segmentation_torch.train import export_seg
    from semantic_segmentation_torch.train.common import (build_seg_problem,
                                                          load_seg_state)
    ecfg = parse_config([f"--model.seg_model={cfg.model.seg_model}",
                         f"--run.model_file={best}",
                         f"--run.save_dir={SAVE_DIR}",
                         f"--run.name={cfg.run.name}",
                         f"--run.export_platforms={dev}"])
    t0 = time.perf_counter()
    path = export_seg.run(ecfg)[dev]
    export_s = time.perf_counter() - t0
    call = load_exported(path)
    seg = build_seg_problem(ecfg, dev)
    load_seg_state(ecfg, seg.net, str(best))
    eager = make_predict_fn(seg.net, 1, ecfg.model.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = {}
    for b in (1, 3):
        size = ecfg.data.image_size
        x = torch.rand(b, size, size, 1, device=dev, generator=gen)
        with torch.no_grad():
            got, want = call(x), eager(x)
        check(got.shape == (b, size, size), f"export: shape {got.shape}")
        errs[b] = float((got - want).abs().max())
        check(errs[b] <= 1e-5, f"export: batch {b}: max |err| {errs[b]}")
    del seg, call
    torch.cuda.empty_cache()
    return {"path": path,
            "bytes": Path(path).stat().st_size, "export_s": export_s,
            "max_abs_err": errs}


def _zoo_train_unet(torch, label: str, extra, dev="cuda"):
    """(e): ``train_unet`` for 20 steps on synthetic data."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_unet
    ucfg = parse_config(["--data.synthetic=true",
                         f"--engine.valid_step={VALID_STEP}",
                         f"--run.save_dir={SAVE_DIR}", f"--run.name={label}",
                         *extra])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    seg, run_u = train_unet.train(ucfg, train_iters=ZOO_UNET_STEPS,
                                  device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(not any(launches.values()),
          f"{label}: the path runs no kernel, launches {launches}")
    check(all(math.isfinite(r["loss"]) for r in run_u["log"])
          and math.isfinite(run_u["best_val"]),
          f"{label}: losses {run_u['log']}, best_val {run_u['best_val']}")
    rec = run_u["log"][-1]
    del seg
    torch.cuda.empty_cache()
    return {"steps": ZOO_UNET_STEPS,
            "steady_steps_per_s": rec["steps"] / rec["seconds"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "best_val": run_u["best_val"],
            "last_loss": rec["loss"], "launches": launches}


def phase_zoo(torch, ckpt, flagship: dict, dev="cuda"):
    """Phase 7d (module docstring) on ``dev``. Returns {label: stats}."""
    import shutil

    from semantic_segmentation_torch.train import test_seg
    out = {}

    def gap(a, b):
        """The largest relative gap of two runs' losses after VALID_STEP
        iterations."""
        return max(abs(a["chunks"][0][k] - b["chunks"][0][k])
                   / max(abs(b["chunks"][0][k]), 1e-12) for k in ZOO_LOSSES)

    # (a) the flagship with DeepLabV3, twice for the run-to-run spread, and
    # once from a net one ulp away, for how far such a difference grows
    cfg = _zoo_cfg(ckpt, "zoo-deeplab")
    run_a, out["deeplab_trainer"] = _zoo_train(torch, cfg, TRAIN_ITERS,
                                               "deeplab_trainer", dev)
    run_b, second = _zoo_train(torch, _zoo_cfg(ckpt, "zoo-deeplab-b"),
                               TRAIN_ITERS, "deeplab_trainer (b)", dev)
    run_p, _ = _zoo_train(torch, _zoo_cfg(ckpt, "zoo-deeplab-ulp"),
                          VALID_STEP, "deeplab_trainer (ulp)", dev,
                          perturb=True)
    for name in ("zoo-deeplab-b", "zoo-deeplab-ulp"):
        shutil.rmtree(SAVE_DIR / name)
    spread, ulp = gap(run_b, run_a), gap(run_p, run_a)
    out["deeplab_trainer"].update(
        second_run_it_per_s=second["steady_it_per_s"], spread=spread,
        one_ulp_gap=ulp, flagship_it_per_s=flagship["steady_it_per_s"],
        flagship_peak_mem_bytes=flagship["peak_mem_bytes"])
    print(f"[zoo] DeepLabV3 flagship {out['deeplab_trainer']['steady_it_per_s']:.2f} "
          f"and {second['steady_it_per_s']:.2f} it/s, peak "
          f"{out['deeplab_trainer']['peak_mem_bytes']} bytes; the U-Net "
          f"flagship (phase 7) {flagship['steady_it_per_s']:.2f} it/s, "
          f"{flagship['peak_mem_bytes']} bytes; after {VALID_STEP} "
          f"iterations the two runs {spread:.3e} apart, the run from a net "
          f"one ulp away {ulp:.3e}")

    # (b) remat. One iteration from the same state, recomputed and not:
    # the same losses and BN statistics bit for bit, the parameters within
    # one RMSprop step's sign flip. Then 20 iterations recomputed: a lower
    # peak; their losses after 10 are printed beside (a)'s spread and
    # one-ulp gap, not held (the run is chaotic: the pooled ASPP branch's
    # BN normalizes two values a channel at batch 2). The U-Net flagship
    # recomputed equals phase 7's run bit for bit.
    out["deeplab_remat_step"] = _zoo_remat_step(torch, ckpt, dev)
    remat, out["deeplab_remat"] = _zoo_train(
        torch, _zoo_cfg(ckpt, "zoo-deeplab-remat", "--model.remat=true"),
        TRAIN_ITERS, "deeplab_remat", dev)
    run_r = out["deeplab_remat"]
    check(run_r["peak_mem_bytes"] < out["deeplab_trainer"]["peak_mem_bytes"],
          f"remat: peak {run_r['peak_mem_bytes']} not below "
          f"{out['deeplab_trainer']['peak_mem_bytes']}")
    run_r["gap_to_plain"] = gap(remat, run_a)
    _, out["unet_remat"] = _zoo_train(
        torch, _zoo_cfg(ckpt, "zoo-unet-remat", "--model.remat=true",
                        seg_model="unet"), TRAIN_ITERS, "unet_remat", dev)
    last = out["unet_remat"]["last_losses"]
    check(all(last[k] == flagship["last_metrics"][k]
              for k in ("loss_netG", "loss_netD", "loss_unet")),
          f"remat: the U-Net flagship's losses {last} differ from phase "
          f"7's {flagship['last_metrics']}")
    out["unet_remat"]["flagship_peak_mem_bytes"] = flagship["peak_mem_bytes"]
    for name in ("zoo-deeplab-remat", "zoo-unet-remat"):
        shutil.rmtree(SAVE_DIR / name)
    print(f"[zoo] remat: DeepLabV3 {run_r['steady_it_per_s']:.2f} it/s, "
          f"peak {run_r['peak_mem_bytes']} bytes, losses after "
          f"{VALID_STEP} iterations {run_r['gap_to_plain']:.3e} from (a)'s; "
          f"one iteration: " + json.dumps(out["deeplab_remat_step"]) +
          "; the U-Net flagship "
          f"{out['unet_remat']['steady_it_per_s']:.2f} it/s, peak "
          f"{out['unet_remat']['peak_mem_bytes']} bytes, its losses after "
          f"{TRAIN_ITERS} iterations equal phase 7's")

    # (c) accumulate=2
    out["deeplab_accumulate"] = _zoo_accumulate(torch, ckpt, dev)
    print(f"[zoo] accumulate=2: the segmenter moved at inner steps "
          f"{out['deeplab_accumulate']['moved']}")

    # (d) test_seg and export_seg on (a)'s best net
    best = SAVE_DIR / cfg.run.name / "unet_best.pt"
    scored = test_seg.run(cfg, model_file=str(best), device=dev)
    check(abs(scored["test_dice"] - run_a["test_dice"]) <= 1e-6,
          f"test_seg: {scored['test_dice']} against the trainer's "
          f"{run_a['test_dice']}")
    out["deeplab_trainer"]["test_seg_dice"] = scored["test_dice"]
    out["deeplab_export"] = _zoo_export(torch, cfg, best, dev)
    print(f"[zoo] test_seg {scored['test_dice']:.6f} (trainer "
          f"{run_a['test_dice']:.6f}); export: " +
          json.dumps(out["deeplab_export"]))

    # (e) train_unet with DeepLabV2 and the bilinear U-Net
    out["deeplabv2_unet_trainer"] = _zoo_train_unet(
        torch, "zoo-deeplabv2", ["--model.seg_model=deeplabv2"], dev)
    out["bilinear_unet_trainer"] = _zoo_train_unet(
        torch, "zoo-bilinear", ["--model.bilinear=true"], dev)
    return out


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


def _generator(torch, dev):
    """The full-width unet_256 generator and its up-conv arch table from
    seed 0, in eval mode: phase 3's and phase 4's inputs."""
    from semantic_segmentation_torch.models.pix2pix.networks import define_G
    from semantic_segmentation_torch.ops.nas import init_arch_params
    init = torch.Generator().manual_seed(0)
    G = define_G(1, 1, "unet_256", 64, True, init).to(dev).eval()
    return G, init_arch_params(init)["upconv"].to(dev)


def timing_child(torch) -> int:
    """Phase 8 in this (fresh) process: phase 3's checks make the inputs,
    then the kernel timing and the benchmark paths; the records and each
    path's launch counts go to TIMING_FILE."""
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    G, arch = _generator(torch, dev)
    records, timers, gen_img = phase_kernels(torch, dev, G, arch)
    del G
    torch.backends.cudnn.allow_tf32 = True     # the trainer's defaults
    torch.cuda.empty_cache()
    phase_timing(records, timers)
    launches = phase_benches(torch, records, gen_img)
    TIMING_FILE.write_text(json.dumps({"records": records,
                                       "launches": launches}))
    return 0


def run_timing_child() -> tuple[dict, dict]:
    """Phase 8 in a child process; (kernel records, launches by path)."""
    sys.stdout.flush()
    TIMING_FILE.unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         TIMING_ARG]).returncode
    check(rc == 0 and TIMING_FILE.is_file(),
          f"timing phase: the child process exited {rc}")
    child = json.loads(TIMING_FILE.read_text())
    return child["records"], child["launches"]


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
    if sys.argv[1:] == [TIMING_ARG]:
        return timing_child(torch)
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
    from semantic_segmentation_torch.ops import augment
    G, arch = _generator(torch, dev)
    phase_kernels(torch, dev, G, arch)
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
    trainer_stats = {}
    for label in TRAINERS:
        trainer_stats[label] = phase_trainer(torch, ckpt, label)
        print(f"[{label}] {card}: " + json.dumps(trainer_stats[label]))
        paths[label] = trainer_stats[label]["launches"]

    # 7b. the real-data path: folder, resume, test_seg, train_unet
    folder = phase_real_data(torch, ckpt, trainer_stats["end2end_trainer"])
    print(f"[folder_trainer] {card}: " + json.dumps(folder))
    paths["folder_trainer"] = folder["launches"]

    # 7c. the ISIC family
    for label, stats in phase_isic(torch).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        paths[label] = stats["launches"]

    # 7d. the segmenter zoo: DeepLabV3 in the flagship (remat, accumulate,
    # test_seg, export_seg), DeepLabV2 and the bilinear U-Net in train_unet
    for label, stats in phase_zoo(torch, ckpt,
                                  trainer_stats["end2end_trainer"]).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        if "launches" in stats:
            paths[label] = stats["launches"]

    # 8. timing and the benchmark paths, in a fresh process
    records, bench_paths = run_timing_child()
    paths.update(bench_paths)
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
