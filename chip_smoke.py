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
     (64, 512, 512), and the equalize at a data-parallel rank's shard of
     the flagship's batch, (1, 256, 256, 1); each call one launch of one
     kernel;
   - down-conv: bf16, within 1e-2 of the plain version's largest magnitude
     at the 9 flagship layers with C_in >= 8 (``bench.conv_down.LAYERS``;
     G_d5's last split-K range is shorter than the others), at M = 2, 8,
     32 and 130, and at C_in / C_out off multiples of 8 (12 -> 64,
     16 -> 20, 12 -> 20); two calls bit-identical at G_d5 and G_d8 (split-K,
     swap-AB); C_in = 1 and 2 raise ``NotImplementedError``;
4. the fake branch in context: warp -> threshold -> G -> min-max -> uint8 ->
   equalize -> gamma through the kernels and through the plain versions
   gives identical images;
5. the engine on the card against the engine on the CPU: two iterations
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
   ``train()`` at full width (U-Net base 64), 10 iterations with
   valid_step 5 (one steady chunk), in three modes, each path's launch
   counts zeroed before it and read after: the end2end_jsrt preset
   (``decay_only``: the warp and the equalize once per iteration), the
   same with ``--engine.hypergrad=darts`` (unroll and replay: each twice
   per iteration; the hypergradient exactly 0 on every chunk) and the
   end2end_nas preset (``unroll``, ``minmax``, live fakes: the warp three
   times per iteration with the surrogate's, the equalize never; the
   hypergradient finite and > 0 on every chunk); in each, one more warp
   launch for each validation panel (G on the augmented first validation
   mask, written where the trainer steps the plateau: at every chunk
   boundary that crosses a multiple of the train split's size, counted as
   the trainer decides it, ``flagship_panels``; one in 10 iterations at 7
   train items, and in every flagship-family run below likewise); finite
   losses, best_val and test Dice produced, the histogram and the
   down-conv never launched, and steady it/s and peak memory printed for
   each;
7b. the real-data path at the same full width from the same checkpoint:
   PNG folders written under build/ from ``SyntheticSegDataset`` arrays (a
   JSRT layout of 16 pairs at 300^2, so that the loader resizes, and an
   OOD set of 8 pairs with the ``_mask`` suffix; PIL decodes them on the
   host); the flagship (``decay_only``) trained from the folder for 10
   iterations with ``--data.n_test=7``, ``--data.ood_roots=sz:...`` and
   ``--run.save_every=5`` (warp and equalize 10 launches, finite test and
   OOD Dice, ``metrics.jsonl``, checkpoint steps 5 and 10; steady it/s and
   peak memory beside phase 7's); a second such run for the run-to-run
   spread; resume: a 5-iteration run resumed at 5 runs nothing and holds
   the saved engine and host state bit for bit, resumed to 10 its chunk's
   losses and val score agree with the uninterrupted run within 4 x the
   spread of the uninterrupted runs, and the fast-forwarded batch-index
   streams equal the straight ones exactly; ``test_seg.run`` on the run's
   ``unet_best.pt`` gives the trainer's test and OOD Dice within 1e-6; and
   ``train_unet`` for 10 steps on the folder (finite losses, best_val, a
   checkpoint, no kernel launched, its step rate);
7c. the ISIC family (``semantic_segmentation_torch`` presets
   ``pix2pix_isic``, ``end2end_isic``, ``end2end_isic224``): (a) an
   ISIC-layout folder of RGB PNGs (a dark lesion of about 28% of the image
   on noisy skin tones) and binary masks at 300^2 (the loader resizes, the
   masks NEAREST) with a test split; ``pix2pix_isic`` (RGB, ``output_nc``
   3) for 10 steps from it, its checkpoint saved; (b) ``end2end_isic`` at
   full width (256^2, batch 2, unet_256, ngf = ndf = 64, U-Net base 64,
   bf16, ``decay_only``, ``--model.output_nc=3``, the photometric fake
   chain, the Jaccard loss) from that checkpoint and folder for 10
   iterations: its test Jaccard at least 0.1 above an all-lesion net's
   (the net learnt the lesion), and ``test_seg`` on its ``unet_best.pt``
   gives the trainer's test Jaccard within 1e-6; (c) ``end2end_isic224``
   at full width on synthetic data (224^2, batch 2, resnet_9blocks ngf 64,
   D ndf 64, the lite Swin-UNet: embed 96, depths 2-2-2-2, heads
   3-6-12-24, window 7, drop-path 0.2) for 10 iterations under the
   preset's own ``darts`` (its hypergradient exactly 0 on every chunk),
   then under ``decay_only`` for 10, four more ``decay_only`` runs and a
   ``--model.use_checkpoint=true`` one of 5 iterations from the same seed
   (the same draws): the darts run's and the recomputed run's losses after
   5 iterations each within 4 x the largest relative gap between the
   five ``decay_only`` runs' (the bound of 7b's resume check; the path is
   not bit-for-bit deterministic on the card).
   For (b) and (c): finite losses, steady it/s, peak bytes, and the warp
   and equalize launches (one each per unet inner step: 10 and 10 in 10
   iterations, 20 and 20 under ``darts``; histogram and down-conv 0);
7d. the segmenter zoo, at the same full width from phase 6's checkpoint:
   (a) the flagship (``end2end_jsrt``, ``decay_only``) with
   ``--model.seg_model=deeplab`` (DeepLabV3, ResNet-50 at 3-4-6-3) for 10
   iterations, twice for the run-to-run spread, and for 5 iterations
   from a net one ulp away (one scale of the head's BN) for how far such a
   difference grows (finite losses, best_val and test Dice, warp and
   equalize one launch an iteration, histogram and down-conv 0; steady
   it/s and peak beside phase 7's); (b) remat: one iteration of the
   engine ``train()`` builds, from the same state with and without
   ``--model.remat=true``, gives the same losses and BN statistics bit for
   bit and parameters within 20 lr; the same run as (a) with remat for 10
   iterations has a lower peak (its losses after 5 are printed beside
   (a)'s spread and one-ulp gap, not held: the run is chaotic); and the
   U-Net flagship with remat gives phase 7's losses after 10 iterations
   bit for bit; (c) the engine ``train()``
   builds with
   ``--optim.accumulate=2``, stepped 10 iterations as ``train()`` steps
   it: the segmenter's parameters move on every second inner step only;
   (d) ``test_seg`` on (a)'s ``unet_best.pt`` gives (a)'s test Dice within
   1e-6, and ``export_seg`` writes it as a ``torch.export`` artifact (bf16,
   symbolic batch) whose loaded program agrees with the eager predict head
   within 1e-5 at batches 1 and 3 on the card; (e) ``train_unet`` for 10
   steps with ``--model.seg_model=deeplabv2`` (ResNet-101, multi-grid,
   output stride 16) and with ``--model.bilinear=true`` (finite losses, a
   best_val, no kernel launched; steps/s and peak);
7e. GenSeg-3D at full width (64^3 crops, batch 1, the 3D NAS generator at
   ngf 64 with 6 downs, instance norm and dropout at d = 4, the 3D
   PatchGAN at ndf 64, UNet3D at 64/128/256/512, bf16 autocast): (a)
   ``train_end2end_3d.train`` of the ``end2end_3d`` preset (``decay_only``)
   for 20 iterations, valid_step 10, on synthetic volumes (finite losses
   and val Dice; steady it/s and peak beside phase 7's); (b) 3 engine
   iterations of ``decay_only`` and of the reference's ``darts``, each
   twice from the same seed (the run-to-run spread): the darts hypergradient
   exactly 0, and darts' G, D, U-Net and arch equal to decay_only's bit
   for bit if each mode's runs are, else within 4x the larger of the
   two modes' run-to-run spreads (where each pair agrees but darts
   differs, decay_only runs again, at most 6 times, and darts must equal
   one of its states bit for bit);
   (c) 10 iterations from a NIfTI folder written under build/ (12 int16
   volumes of 72x80x60 with scl_slope 2 and truths: CropOrPad crops two
   axes and pads one), the test Dice printed; (d) ``train_pix2pix_3d`` for
   10 steps, then ``evaluate_generation``'s CSV, one row of finite metrics
   per test volume; (e) ``train_unet3d`` for 20 steps at base 64 (steps/s
   and peak); (f) the CPU test's 3-iteration engine case (32^3, nd 3,
   ngf = ndf = 4, base 4, f32) on the card against the CPU, losses within
   1e-4 relative. No port kernel launches on any 3D path (each counted);
7f. pixel-space BBDM at full width (the ADM denoiser at model_channels
   128, mult (1, 4, 8), 2 res blocks, its 21 NAS cells: 1,211,895,425
   parameters; 256^2, bf16 autocast, T = 1000 with the 200-step
   sampler): (a) ``train_bbdm`` of the ``bbdm`` preset at batch 8 for 6
   steps, validation every 3 (finite losses, steady steps/s, the peak;
   the final latest checkpoint, the whole trainer state, is written to
   disk, and of the top-k checkpoints and the two weight files only
   their tensors' bytes are counted (``CountedSaves``): the H100 host
   this script was measured on caps a run's disk writes at 45 GiB, and
   one such run writes 87 GB); (b)
   ``run.sample_only``'s ``sample_eval``, which builds a fresh model and
   restores (a)'s latest checkpoint from disk (its metric record carries
   (a)'s last step), over two test conditions, two samples each (the
   restore's seconds, seconds per 200-step sampling batch, the grid,
   samples in [0, 1], the diversity);
   (c) ``train_end2end_bbdm`` of the ``end2end_bbdm`` preset
   (``loss_lambda`` 0, ``decay_only``, U-Net base 64) for 10 iterations,
   validation every 5 (it/s, the peak, a panel per validation, no kernel
   launched); (d) one engine iteration with ``--optim.loss_lambda=1.0``
   (the fake branch: the warp, then a 200-step sampling at batch 2 inside
   the U-Net's step; one warp launch an iteration) and one with the
   photometric chain (one warp and one equalize); (e) one ``darts``
   iteration, its hypergradient exactly 0; (f) a small denoiser (model
   channels 16, 32^2, f32) on the card against the CPU from the same
   weights: the forward within 1e-5 and a 10-step sampling run within 1e-4
   of the largest magnitude. The phase runs in a fresh child process
   (``--bbdm-child``) that first asks for cuDNN's heuristic mode B as the
   BBDM entry points do (``prefer_cudnn_heuristic_mode_b``: PyTorch reads
   it when a process plans its first conv, and the earlier phases ran
   convs); it prints its wall time;
7g. the soft-intro VAE family at full width (256^2, batch 2, bf16, seed 0,
   synthetic data with the presets' splits cut to 16/4/4; the ResNet-18
   encoder with its 10 k3/k5/k7 cells, the z-conditioned U-Net decoder
   unet_256 at ngf 64, latent 8): (a) ``train_vae --preset=sivae`` for 10
   steps, the plain VAE for 5, then soft-intro (steady steps/s of each
   phase, its first step timed apart; the peak; the checkpoint's bytes
   and write seconds), and 3 steps under ``recon_loss_type='vgg'``
   (random VGG16 weights from the seed); (b) ``end2end_sivae`` at its
   preset (``decay_only``) for 20 iterations, validation every 10 (steady
   it/s, the peak, a panel per validation, test Dice; the warp and the
   equalize once each per U-Net inner step: 20 and 20), and ``darts`` for
   3 (its ``arch_grad_norm`` exactly 0; 6 and 6); (c) ``inference_vae``
   from (a)'s checkpoint, 3 styles a condition, the diversity under
   LPIPS-alex with random weights (seconds per image); (d) FID and LPIPS
   through ``train_bbdm.evaluate_samples`` on random arrays of BBDM's
   sample shape, 32 conditions at 256^2, random feature nets (seconds per
   batch of 16 of the pool3 features and of LPIPS-alex, the Frechet
   distance's host seconds); (e) one ``soft_intro_step`` at 32^2
   (decoder ngf 4, f32, TF32 off) on the card against the CPU from the
   same weights and draws: the encoder step's losses within 1e-5
   relative, the decoder step's (after the encoder's first Adam step,
   whose signs rounding decides where a gradient is noise) within 1e-3,
   and the updated state's gap to the largest value printed. No kernel launches
   in (a), (c), (d). The phase prints its wall time;
7h. the rest of the pix2pix family at full width (256^2, batch 2,
   unet_256, ngf = ndf = 64, bf16): (a) ``test_pix2pix.run`` from phase
   6's checkpoint over phase 7b's JSRT-layout folder: ``index.html`` with
   one row of three images per item, the seconds an image; (b) stage 1
   under ``--optim.gan_mode=wgangp`` for 5 steps on synthetic data, a
   sample grid every step: finite losses, the five grids written; (c)
   ``--preset=pix2pix_colorization`` (L -> ab, 1 -> 2 channels) for 10
   steps from a folder of 16 RGB PNGs written under build/ (steps/s and
   the peak), then ``test_pix2pix`` on its checkpoint through the L/ab
   branch (RGB fakes in the report); (d) phase 6's G and D written as the
   JAX package's ``.msgpack`` pair (``utils/serialization.save_pytree``
   over ``utils/bridge.state_dict_to_flax``) and loaded into a fresh
   ``Pix2Pix`` on the card by ``load_model``: G's output identical to the
   saved model's on the same input. No kernel launches in 7h;
7i. latent BBDM at full width, in the BBDM child process after 7f: (a)
   ``VQGANTrainer`` on the JAX ``VQModel`` defaults (ch 128, ch_mult
   (1, 2, 4), 2 res blocks, z 3, embed 3, 16,384 codes; 256^2 -> 64^2;
   bf16 autocast) for 10 alternating steps at batch 8 of 256^2 RGB images
   with ``disc_start`` 5 (the adversarial terms off, then on) and
   VGG-LPIPS on random VGG16 weights and lins from the seed: each
   optimizer step timed (steps/s of each, the first apart), the peak,
   ``d_weight``; (b) ``BBDMModel`` in that frozen VQ model's latent space
   with normalized latents (statistics from 8 training images), the
   denoiser at the ``bbdm`` preset's widths (model_channels 128, mult
   (1, 4, 8), 2 res blocks, 21 cells) on the 3 x 64^2 latent:
   ``train_bbdm.train(cfg, model=...)`` of the ``bbdm_colorization_rgb``
   family for 20 steps at batch 8, validation every 10 (steps/s, the
   peak; its checkpoints counted, not written, as in 7f),
   and one 200-step sampling batch of 2 decoded to 256^2 (its seconds);
   (c) a small VQ model (ch 32, ch_mult (1, 2), 64 codes, f32, TF32 off)
   on the card against the CPU from the same weights: ``encode_pre_quant``
   and ``decode`` within 1e-5 of the largest magnitude, the code indices
   equal, one ``train_step_ae``'s losses within 1e-4 relative. No kernel
   launches in 7i;
7j. data parallelism (``parallel/``): (a) ``dp_engine_step`` on two ranks
   that share the card (two child processes joined over gloo with CUDA
   tensors: NCCL refuses two ranks on one device; ``launch.RankPool``,
   ``parallel/harness.py``) at the full-width flagship (256^2, global
   batch 2 so one row a rank, bf16) from phase 6's G, D and arch tables:
   2 ``decay_only`` iterations and 1 ``unroll`` one
   (``end2end_nas``: the inner gradients all-reduced inside the
   differentiated graph, the min-max gradient across the ranks), each
   from one state with one set of draws (the engine's generator at the
   global batch's shape); rank 0 runs the same iterations alone first
   (the collectives off, so that no state crosses a process), and from
   the nets with every parameter one ulp up and one ulp down (the spread:
   the largest gap of those two to the first run; a repeat is bit for bit
   the same); the two ranks' losses, ``arch_grad_norm`` and state gaps,
   each within 4x its own spread: the parameters and the BN statistics
   (relative per leaf, ``harness.state_gap``), the last step's averaged
   gradients (relative to their norm) and the arch tables; the warp and
   the equalize launched on each rank's (1, 256, 256, 1) as the mode runs
   them; it/s of both, each rank's peak, and the gradient all-reduces'
   bytes, calls and seconds an iteration (through host memory under gloo:
   a correctness harness, not a speed figure). The same runs alone serve
   7k (a), on the same pool;
   (b) the flagship entry ``train_end2end.main`` (``python -m
   semantic_segmentation_torch.train.train_end2end``) in a fresh process
   at full width from phase 6's checkpoint for 10 iterations under
   ``--run.multihost=true`` with a coordinator on this host, one process
   and ``--run.data_axis=0``: a one-rank NCCL group, through which every
   batch reduction and gradient all-reduce runs; against the plain run
   from the same seed and configuration, phase 7's ``decay_only`` run:
   every number logged at iteration 10 (the losses, the validation Dice)
   equal (a group of one gives the plain values exactly), else within 4x
   the spread of a plain run of the entry; steady it/s of both, the
   launches; (c) the five in-memory families (fixtures written
   with PIL, pickle and ``write_nifti`` under build/: 16 16-bit B.
   subtilis TIFs of 300^2, 16 omnipose pairs, 8 diabetic 600^2 JPEGs, a
   DeePiCt pickle, 8 NIfTI slices) decoded through ``make_dataset`` (the
   seconds), then ``train_unet`` at full width (base 64, 256^2, batch 2)
   for 10 steps from the B. subtilis folder and from the DeePiCt pickle
   (steps/s, the peak, no kernel launched);
7k. tensor and spatial parallelism (``parallel/tensor_parallel.py``,
   ``parallel/spatial.py``), on 7j (a)'s pool of two gloo ranks that
   share the card, each case against runs alone on rank 0 with the
   collectives off, from the nets as built and one ulp up and down: (a)
   ``tp_engine_step`` on the mesh (data 1, model 2) at the full-width
   flagship from phase 6's checkpoint, 7j (a)'s 2 ``decay_only``
   iterations and 1 ``unroll`` one against 7j (a)'s runs alone: the
   losses, parameters and BN statistics per leaf, the gradients by norm
   and the arch tables each within 4x its one-ulp spread; each rank's peak, the bytes of rank 0's sharded and whole
   leaves, the channel gathers' bytes, calls and seconds an iteration,
   the warp and equalize launches per rank (each rank computes the whole
   fake batch); (b) ``tp_seg_step`` for the U-Net segmenter (base 64,
   256^2, batch 2, bf16), 3 steps, held the same way; (d)
   ``train_unet3d`` at full width (base 64, crop 64^3, batch 1) at
   ``run.spatial_axis=2`` (one depth slab a rank, halos around every k3
   conv), 4 steps with one validation, against ``spatial_axis=1``: the
   logged losses and the parameters within 4x their one-ulp spread; the
   halos' bytes and seconds a step, each rank's peak, steps/s of both
   (the two ranks' a correctness harness's, not a speed figure); and (c)
   in 7j (b)'s child process, after the entry, ``tp_engine_step`` over its
   one-rank NCCL group (mesh 1 x 1), 2 ``decay_only`` iterations, equal
   bit for bit to the same iterations alone;
7l. the long-horizon experiments' scripts, each through its own function
   at the full-width flagship's widths (256^2, batch 2, unet_256, ngf =
   ndf = 64, U-Net base 64, bf16): (a) ``scripts/validate_torch_learning.py``
   (``end2end_jsrt`` from its fresh init, synthetic 7/2/8 images) for 40
   iterations, validation every 20: finite losses, the record's every
   field, the warp launched once an iteration and once a panel, the
   equalize once an iteration; (b) the card mode of
   ``scripts/drift_torch_chaos_control.py`` for 10 iterations: the base
   run, the base again and the 1-ulp run (G's and D's parameters and the
   U-Net's state times 1 + 1e-7), their run-to-run and 1-ulp spreads of
   the losses and the held-out Dice printed (the measurement: nothing
   held but finiteness), the warp and the equalize once an iteration a
   run; (c) two ``scripts/nas_torch_win.py`` arms at 64^2 (``unet_64``),
   10 iterations each, in this process, started through ``train``'s
   ``init_state`` from tables biased +2 toward k8: frozen
   (``hypergrad=none``), its tables after the run equal to the biased ones
   bit for bit and the biased column's lead within 0.005 of 2; searched
   (``unroll``), its tables moved and its ``arch_grad_norm`` > 0; the warp
   launched once (frozen) or three times (searched) an iteration and once
   a panel, the equalize never;
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
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the flagship family's runs: 10 iterations, validation every 5 (cut from
# 20 and 10 to keep the script inside its time)
TRAIN_ITERS, MODE_ITERS, VALID_STEP, PIX2PIX_STEPS = 10, 10, 5, 20
SAVE_DIR = ROOT / "build" / "chip_smoke_run"
# phase 8 runs in a child process: ``python3 chip_smoke.py --timing-child``
# writes its kernel records and launch counts to TIMING_FILE
TIMING_ARG = "--timing-child"
TIMING_FILE = ROOT / "build" / "chip_smoke_timing.json"
# phase 7f runs in a child process too: ``python3 chip_smoke.py
# --bbdm-child`` writes its stats to BBDM_FILE. Like the BBDM entry points
# it asks for cuDNN's heuristic mode B before its first conv, which only a
# fresh process can (this one's earlier phases ran convs)
BBDM_ARG = "--bbdm-child"
BBDM_FILE = ROOT / "build" / "chip_smoke_bbdm.json"


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def phase_kernels(torch, dev, G, arch, all_checks: bool = True):
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
    # the flagship's validation panel: one mask, (1, 256, 256, 1)
    m1 = masks[:1].contiguous()                              # (1,256,256,1)
    mats1 = augment.sample_affine_batch(1, 256, 256, gen)
    k1 = augment.warp_affine_batch(m1, mats1)
    r1 = augment.warp_affine_batch_ref(m1, mats1)
    err_1 = (k1 - r1).abs().max().item()
    check(err_1 == 0.0, f"warp panel mask (1, 256^2): max |err| {err_1}")
    check(torch.equal(k1 > 0.1, r1 > 0.1), "warp panel mask (1, 256^2): "
          "> 0.1 differs")
    print(f"[kernels] warp: max|err| masks {err_mask:.3e} masks 224^2 "
          f"{err_224:.3e} panel mask (1, 256^2) {err_1:.3e} rgb "
          f"{err_rgb:.3e}, > 0.1 masks identical, identity and flip exact")

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
    lib_warp1 = lib_warp_fn(m1, mats1)
    err_lib = (lib_warp().permute(0, 2, 3, 1) - out_r).abs().max().item()
    err_lib224 = (lib_warp224().permute(0, 2, 3, 1)
                  - r224).abs().max().item()
    err_lib1 = (lib_warp1().permute(0, 2, 3, 1) - r1).abs().max().item()
    numel = masks.numel()
    # image read + output written (f32) + the (2, 3, 3) f32 matrices;
    # ~20 f32 operations per output
    b, why = bound_ms(2 * 4 * numel + mats.numel() * 4, 20 * numel)

    records["warp_affine"] = {
        "name": "warp_affine", "route": "cuda",
        "source": "semantic_segmentation_torch/kernels/csrc/warp_affine.cu",
        "replaces": "semantic_segmentation_tpu/ops/pallas_kernels.py:243",
        "max_abs_err": max(err_mask, err_rgb, err_224, err_1),
        "bound_ms": b, "bound_us": b * 1e3, "bound_by": why,
        "shape": [2, 256, 256, 1], "library_max_abs_err": err_lib}
    timers["warp_affine"] = (
        "warp_affine_kernel", lambda: augment.warp_affine_batch(masks, mats),
        lambda: augment.warp_affine_batch_ref(masks, mats), lib_warp)
    # the ISIC224 trainer's shape and the flagship panel's, each timed as
    # a case of the warp's record
    b224, why224 = bound_ms(2 * 4 * m224.numel() + mats224.numel() * 4,
                            20 * m224.numel())
    b1, why1 = bound_ms(2 * 4 * m1.numel() + mats1.numel() * 4,
                        20 * m1.numel())
    records["warp_affine"]["cases"] = [
        {"case": "224", "shape": [2, 224, 224, 1], "max_abs_err": err_224,
         "bound_ms": b224, "bound_by": why224,
         "library_max_abs_err": err_lib224},
        {"case": "panel", "shape": [1, 256, 256, 1], "max_abs_err": err_1,
         "bound_ms": b1, "bound_by": why1,
         "library_max_abs_err": err_lib1}]
    timers["warp_affine@224"] = (
        "warp_affine_kernel",
        lambda: augment.warp_affine_batch(m224, mats224),
        lambda: augment.warp_affine_batch_ref(m224, mats224), lib_warp224)
    timers["warp_affine@panel"] = (
        "warp_affine_kernel",
        lambda: augment.warp_affine_batch(m1, mats1),
        lambda: augment.warp_affine_batch_ref(m1, mats1), lib_warp1)

    # -- equalize and histogram (one cluster kernel each) -------------------
    fake_mask = image.threshold_mask(out_k, 0.1)
    with torch.no_grad():
        g_out = G(fake_mask.permute(0, 3, 1, 2), arch).permute(0, 2, 3, 1)
    gen_img = image.to_uint8(image.minmax_normalize(g_out))
    if all_checks:
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
    # a data-parallel rank's shard of the flagship's global batch 2 (and
    # the panel's shape): one image, (1, 256, 256, 1)
    x1 = gen_img[:1].contiguous()
    k1 = image.equalize_uint8(x1)
    check(torch.equal(k1, image.equalize_uint8_ref(x1)),
          "equalize (1, 256^2): differs from the plain version")
    b1, why1 = bound_ms(2 * x1.numel(), 2 * x1.numel())
    records["equalize_uint8"]["cases"] = [
        {"case": "rank", "shape": [1, 256, 256, 1], "max_abs_err": 0.0,
         "bound_ms": b1, "bound_by": why1}]
    timers["equalize_uint8@rank"] = (
        "equalize_kernel", lambda: image.equalize_uint8(x1),
        lambda: image.equalize_uint8_ref(x1), None)
    print("[kernels] equalize at a data-parallel rank's (1, 256, 256, 1): "
          "bit-exact")
    if all_checks:
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
        rec = (next(c for c in records[kernel]["cases"] if c["case"] == case)
               if case else records[kernel])
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
    "decay_only": ([], "end2end_jsrt", 1e-6, 2),
    "darts": (["--engine.hypergrad=darts"], "end2end_jsrt", 1e-6, 2),
    "unroll": ([], "end2end_nas", 1e-5, 2),
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
    """Two engine iterations at 32^2 in float32 in each of ``decay_only``,
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


def flagship_panels(cfg, iters: int, start: int = 0) -> int:
    """The validation panels ``train_end2end.train`` writes running ``cfg``
    from iteration ``start`` to ``iters``, each one warp launch: one at
    every chunk boundary (``valid_step`` iterations a chunk) that crosses
    a multiple of the train split's size, as the trainer decides it
    (``crosses_epoch``)."""
    from semantic_segmentation_torch.data.folder import make_dataset
    from semantic_segmentation_torch.data.pipeline import subset_split
    from semantic_segmentation_torch.train.train_end2end import crosses_epoch
    d = cfg.data
    n_items = d.n_train if d.synthetic else len(make_dataset(
        d.dataset, d.dataroot, d.mask_suffix, image_size=d.image_size))
    n_train = len(subset_split(n_items, d.n_train, d.n_val, d.n_test)[0])
    count, it = 0, start
    while it < iters:
        chunk = min(cfg.engine.valid_step, iters - it)
        it += chunk
        count += crosses_epoch(it, chunk, n_train)
    return count


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
    # no final checkpoint (3.7 GB, not read: phase 7b holds the saves):
    # the card's host caps a call's disk writes
    cfg = parse_config(["--data.synthetic=true",
                        f"--engine.valid_step={VALID_STEP}",
                        f"--run.pretrained_pix2pix={ckpt}",
                        "--run.final_checkpoint=false",
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
    panels = flagship_panels(cfg, iters)
    want = {"warp_affine": warps * unet_steps + panels,
            "equalize_uint8": equalizes * unet_steps,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"{label}: launches {launches}, not {want} "
          f"({unet_steps} unet inner steps, hypergrad "
          f"{cfg.engine.hypergrad}, {panels} validation panels)")
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
             "chunks": results["chunks"],
             "panels": panels, "launches": launches}
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
                         # the last save_every one is the final state
                         "--run.final_checkpoint=false",
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
    want = {"warp_affine": TRAIN_ITERS + flagship_panels(cfg, TRAIN_ITERS),
            "equalize_uint8": TRAIN_ITERS, "histogram256": 0,
            "conv_down4": 0}
    check(launches == want, f"folder: launches {launches}, not {want}")
    for k in ("best_val", "test_dice", "ood_sz"):
        check(k in run_a and math.isfinite(run_a[k]),
              f"folder: no finite {k}: {run_a}")
    run_dir = SAVE_DIR / cfg.run.name
    check((run_dir / "metrics.jsonl").stat().st_size > 0,
          "folder: metrics.jsonl not written")
    steps = sorted(int(s.name) for s in (run_dir / "ckpt").iterdir()
                   if s.name.isdigit())
    check(steps == [VALID_STEP, TRAIN_ITERS],
          f"folder: checkpoint steps {steps}")
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
    print(f"[resume] (a) resumed at iteration {VALID_STEP}: no iteration "
          "ran; "
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
          and launches_r["warp_affine"] == TRAIN_ITERS - VALID_STEP
          + flagship_panels(cfg, TRAIN_ITERS, start=VALID_STEP),
          f"resume (b): chunks {run_r['chunks']}, launches {launches_r}")
    gaps = _rel_gaps(run_a["chunks"][1], run_r["chunks"][0])
    check(max(gaps.values()) <= bound,
          f"resume (b): relative gaps {gaps} beyond {bound:.3e}")
    shutil.rmtree(SAVE_DIR / "folder-c")
    print(f"[resume] (b) resumed to {TRAIN_ITERS}: largest relative gap "
          f"to the "
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
ISIC_PIX2PIX_STEPS, ISIC_CKPT_ITERS = 10, 5
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
    want = {"warp_affine": unet_steps + flagship_panels(cfg, iters),
            "equalize_uint8": unet_steps, "histogram256": 0,
            "conv_down4": 0}
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
ZOO_ACCUMULATE_ITERS, ZOO_UNET_STEPS = 10, 10


def _zoo_cfg(ckpt, name: str, *extra, seg_model: str = "deeplab"):
    """The flagship (``end2end_jsrt``) at full width with ``seg_model``."""
    from semantic_segmentation_torch.core.config import parse_config
    cfg = parse_config(["--data.synthetic=true",
                        f"--model.seg_model={seg_model}",
                        f"--engine.valid_step={VALID_STEP}",
                        f"--run.pretrained_pix2pix={ckpt}",
                        "--run.final_checkpoint=false",     # not read
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
    want = {"warp_affine": iters + flagship_panels(cfg, iters),
            "equalize_uint8": iters, "histogram256": 0, "conv_down4": 0}
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
    """(e): ``train_unet`` for ``ZOO_UNET_STEPS`` steps on synthetic
    data."""
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


# 7e. GenSeg-3D: the end2end_3d program at full width (64^3 crops, batch 1,
# the 3D NAS generator at ngf 64 with 6 downs and instance norm, the 3D
# PatchGAN at ndf 64, UNet3D at 64/128/256/512, bf16 autocast), its
# reference mode, a NIfTI folder, and the two other 3D trainers
RUN3D = ROOT / "build" / "chip_smoke_run3d"
NIFTI_DIR = DATA_DIR / "nifti"
E3D_ITERS, E3D_MODE_ITERS, E3D_NIFTI_ITERS = 20, 3, 10
E3D_EXTRA_RUNS = 6   # decay_only reruns, at most, when 7e (b)'s pairs agree
P2P3D_STEPS, UNET3D_STEPS = 10, 20
E3D_ARGV = ["--preset=end2end_3d", "--data.synthetic=true",
            "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
            f"--engine.valid_step={VALID_STEP}",
            "--run.final_checkpoint=false", f"--run.save_dir={RUN3D}"]
SMALL3D_ARGV = ["--preset=end2end_3d", "--data.synthetic=true",
                "--data.n_train=2", "--data.n_val=2", "--data.n_test=1",
                "--model.ngf=4", "--model.ndf=4", "--model.base_features=4",
                "--model.compute_dtype=float32"]


def _check_full_3d(cfg, label: str):
    m = cfg.model
    check((m.ngf, m.ndf, m.base_features, m.norm, m.compute_dtype,
           cfg.data.batch_size, m.no_dropout) ==
          (64, 64, 64, "instance", "bfloat16", 1, False),
          f"{label}: not the full-width end2end_3d configuration")


def _launches_zero(kernels, label: str) -> dict:
    launches = dict(kernels.LAUNCHES)
    check(all(v == 0 for v in launches.values()),
          f"{label}: a kernel launched on a path that has none: {launches}")
    return launches


def _e3d_train(torch, argv, iters: int, label: str):
    """``train_end2end_3d.train`` at full width (crop 64, nd 6, linear) on
    the card; finite losses and val Dice, no kernel launched. Returns the
    stats with steady it/s and the peak."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_end2end_3d
    cfg = parse_config(E3D_ARGV + argv)
    _check_full_3d(cfg, label)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train_end2end_3d.train(cfg, train_iters=iters,
                                             crop=64, num_downs=6,
                                             upsampling="linear",
                                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches_zero(kernels, label)
    for c in results["chunks"]:
        for k in ("loss_netG", "loss_netD", "loss_unet", "val_score"):
            check(math.isfinite(c[k]), f"{label}: {k} not finite: {c}")
    check(math.isfinite(results["best_val"]) and
          math.isfinite(results.get("test_dice", float("nan"))),
          f"{label}: no best_val/test_dice: {results}")
    chunks = results["chunks"]
    steady = chunks[1:] or chunks
    its = sum(c["iters"] for c in steady) / sum(c["seconds"] for c in steady)
    stats = {"iters": iters, "wall_s": wall,
             "first_chunk_s": chunks[0]["seconds"],
             "steady_it_per_s": its, "steady_iter_ms": 1e3 / its,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "val_scores": [c["val_score"] for c in chunks],
             "best_val": results["best_val"],
             "test_dice": results["test_dice"],
             "last_metrics": {k: chunks[-1][k] for k in (
                 "loss_netG", "loss_netD", "loss_unet", "arch_grad_norm")},
             "launches": launches}
    del engine
    torch.cuda.empty_cache()
    return stats


def _e3d_mode_run(torch, mode: str, dev="cuda", small=False):
    """``E3D_MODE_ITERS`` engine iterations of ``mode`` from the seed's
    state (full width on the card, or the CPU test's small case), the
    trainer's index streams. Returns (metrics per iteration, G/D/U-Net
    state and arch on the CPU)."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.pipeline import take_batch, \
        to_device_split
    from semantic_segmentation_torch.train.train_end2end import index_streams
    from semantic_segmentation_torch.train.train_end2end_3d import (
        build_engine, load_volume_splits)
    argv = (SMALL3D_ARGV if small else E3D_ARGV) + [
        f"--engine.hypergrad={mode}"]
    cfg = parse_config(argv)
    crop, nd = (32, 3) if small else (64, 6)
    engine, model = build_engine(cfg, dev, nd, "linear")
    splits = load_volume_splits(cfg, crop)
    tr, va = (to_device_split(splits[k], dev) for k in ("train", "val"))
    streams, val_stream = index_streams(cfg, cfg.data.n_train,
                                        cfg.data.n_val)
    out = []
    for _ in range(E3D_MODE_ITERS):
        m = engine.engine_step([{n: take_batch(tr, next(s))
                                 for n, s in streams.items()}],
                               take_batch(va, next(val_stream)))
        out.append({k: float(v) for k, v in m.items()})
    state = {f"{n}.{k}": v.detach().cpu()
             for n, net in (("G", model.G), ("D", model.D),
                            ("U", model.seg))
             for k, v in net.state_dict().items()}
    state["arch"] = model.arch["conv"].detach().cpu()
    del engine, model
    torch.cuda.empty_cache()
    return out, state


def _e3d_small_card_vs_cpu(torch):
    """The CPU test's 3-iteration case (32^3, nd 3, ngf = ndf = 4, base 4,
    f32, ``decay_only``) on the card and on the CPU, each iteration started
    on the card from the CPU engine's state before it (G, D, the U-Net, the
    optimizers' states, the arch table and its Adam), the same batches:
    each iteration's losses then hold one step of each device's rounding.
    Run free, the U-Net's RMSprop turns rounding in its near-zero
    gradients into steps of 10 lr whose sign rounding decides, and two
    CPU runs alone (oneDNN against torch's native conv kernels) part by
    2.5e-4 in ``loss_unet`` by the third iteration. Returns the card's
    and the CPU's metrics per iteration."""
    import copy

    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.pipeline import take_batch, \
        to_device_split
    from semantic_segmentation_torch.train.train_end2end import index_streams
    from semantic_segmentation_torch.train.train_end2end_3d import (
        build_engine, load_volume_splits)
    cfg = parse_config(SMALL3D_ARGV + ["--engine.hypergrad=decay_only"])
    devices = ("cpu", "cuda")
    engines = {d: build_engine(cfg, d, 3, "linear")[0] for d in devices}
    splits = load_volume_splits(cfg, 32)
    data = {d: {k: to_device_split(splits[k], d) for k in ("train", "val")}
            for d in devices}
    streams, val_stream = index_streams(cfg, cfg.data.n_train,
                                        cfg.data.n_val)
    out = {d: [] for d in devices}
    card = engines["cuda"]
    for _ in range(E3D_MODE_ITERS):
        # a deep copy: the optimizers share a loaded "step" tensor
        state = copy.deepcopy(engines["cpu"].state_dict())
        state["generator"] = card.generator.get_state()
        state["hyper_generator"] = card.hyper_generator.get_state()
        card.load_state_dict(state)
        idx = {n: next(s) for n, s in streams.items()}
        vidx = next(val_stream)
        for d in devices:
            m = engines[d].engine_step(
                [{n: take_batch(data[d]["train"], ix)
                  for n, ix in idx.items()}],
                take_batch(data[d]["val"], vidx))
            out[d].append({k: float(v) for k, v in m.items()})
    del engines, card
    torch.cuda.empty_cache()
    return out["cuda"], out["cpu"]


def write_nifti_folder(n: int = 12, shape=(72, 80, 60)):
    """``n`` paired int16 volumes with ``scl_slope`` 2 and binary truths
    under NIFTI_DIR (imgsA/, imgsB/, truths/): a blob in A and B, B's
    texture its own. 72 x 80 x 60 around the 64^3 crop, so that CropOrPad
    crops two axes and pads the third."""
    import struct

    import numpy as np
    from semantic_segmentation_torch.data.nifti import write_nifti
    for d in ("imgsA", "imgsB", "truths"):
        (NIFTI_DIR / d).mkdir(parents=True, exist_ok=True)
    zz, yy, xx = np.meshgrid(*(np.arange(s) / s for s in shape),
                             indexing="ij")
    for i in range(n):
        rng = np.random.default_rng(i)
        c, r = rng.uniform(0.35, 0.65, 3), rng.uniform(0.12, 0.25, 3)
        truth = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
                 + ((xx - c[2]) / r[2]) ** 2) < 1.0
        a = 100 + 300 * truth + rng.normal(0, 20, shape)
        b = 200 + 150 * truth + 80 * np.sin(9 * xx) * np.cos(7 * yy) \
            + rng.normal(0, 20, shape)
        for d, vol in (("imgsA", a), ("imgsB", b), ("truths", truth)):
            path = NIFTI_DIR / d / f"vol{i:02d}.nii"
            write_nifti(str(path), vol.astype(np.uint8 if d == "truths"
                                              else np.int16))
            if d != "truths":
                with open(path, "r+b") as f:       # scl_slope = 2
                    f.seek(112)
                    f.write(struct.pack("<f", 2.0))
    return n


def phase_3d(torch, flagship: dict) -> dict:
    """Phase 7e: GenSeg-3D on the card. Returns {label: stats}."""
    import numpy as np
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import (train_pix2pix_3d,
                                                   train_unet3d)
    from semantic_segmentation_torch.train.train_end2end_3d import \
        load_volume_splits
    out = {}
    # (a) end2end_3d at full width on synthetic 64^3 volumes
    out["end2end_3d"] = a = _e3d_train(torch, [], E3D_ITERS, "end2end_3d")
    print(f"[end2end_3d] steady {a['steady_it_per_s']:.3f} it/s, peak "
          f"{a['peak_mem_bytes']} bytes, val Dice {a['val_scores']}; the "
          f"U-Net flagship (phase 7) in this call "
          f"{flagship['steady_it_per_s']:.2f} it/s at "
          f"{flagship['peak_mem_bytes']} bytes")

    # (b) the preset's decay_only against the reference's darts, 3
    # iterations each from the same state; each mode twice for the
    # run-to-run spread (the path is not deterministic on the card: the
    # trilinear upsample's backward adds atomically, and two runs of one
    # mode can agree bit for bit while the other mode's differ)
    kernels.reset_launches()
    d1, s1 = _e3d_mode_run(torch, "decay_only")
    d2, s2 = _e3d_mode_run(torch, "decay_only")
    dk, sk = _e3d_mode_run(torch, "darts")
    dk2, sk2 = _e3d_mode_run(torch, "darts")
    check(all(m["arch_grad_norm"] == 0.0 for m in dk + dk2),
          f"end2end_3d darts: hypergradient not exactly 0: {dk} {dk2}")

    def gap(x, y):
        return max((x[k].float() - y[k].float()).abs().max().item()
                   for k in x)

    spread = max(gap(s1, s2), gap(sk, sk2))
    darts_gap = gap(sk, s1)
    # Both pairs can agree by chance while darts' state sits one step of
    # that noise from decay_only's (the noise has two outcomes here). Then
    # darts must equal, bit for bit, a state that decay_only reaches: rerun
    # decay_only until one of its runs lands on darts' state, or fail.
    extra = 0
    if spread == 0.0:
        matched = darts_gap == 0.0
        while not matched and extra < E3D_EXTRA_RUNS:
            extra += 1
            _, s = _e3d_mode_run(torch, "decay_only")
            matched = gap(sk, s) == 0.0
            del s
        check(matched, f"end2end_3d: darts' state {darts_gap} off "
              f"decay_only's, each mode's pair bit-identical, and none of "
              f"{extra} more decay_only runs reached darts' state")
    else:
        check(darts_gap <= 4 * spread, f"end2end_3d: darts' state "
              f"{darts_gap} off decay_only's, beyond 4x the spread {spread}")
    launches = _launches_zero(kernels, "end2end_3d modes")
    out["end2end_3d_modes"] = {
        "iters": E3D_MODE_ITERS, "run_to_run_spread": spread,
        "decay_only_spread": gap(s1, s2), "darts_spread": gap(sk, sk2),
        "extra_decay_only_runs": extra, "darts_gap": darts_gap,
        "darts_arch_grad_norms": [m["arch_grad_norm"] for m in dk],
        "launches": launches,
        "losses": {"decay_only": d1[-1], "darts": dk[-1]}}
    print(f"[end2end_3d modes] {E3D_MODE_ITERS} iterations: two decay_only "
          f"runs {gap(s1, s2):.3e} apart, two darts runs {gap(sk, sk2):.3e}, "
          f"{extra} more decay_only run(s), spread {spread:.3e}, darts "
          f"{darts_gap:.3e} off decay_only, darts hypergradient exactly 0")

    # (c) from a NIfTI folder: int16, scl_slope 2, cropped and padded
    n = write_nifti_folder()
    c = _e3d_train(torch, ["--data.synthetic=false",
                           f"--data.dataroot={NIFTI_DIR}",
                           "--data.n_train=8", "--data.n_val=2",
                           "--data.n_test=2", "--engine.valid_step=5",
                           "--run.name=end2end-3d-nifti"],
                   E3D_NIFTI_ITERS, "end2end_3d nifti")
    out["end2end_3d_nifti"] = c
    print(f"[end2end_3d nifti] {n} volumes of 72x80x60 int16: "
          f"{E3D_NIFTI_ITERS} iterations, test Dice {c['test_dice']:.4f}, "
          f"{c['steady_it_per_s']:.3f} it/s")

    # (d) train_pix2pix_3d: 10 steps at full width, then the generation CSV
    cfg = parse_config(["--data.synthetic=true", "--data.n_train=4",
                        "--data.n_val=1", "--data.n_test=2",
                        "--data.batch_size=1", "--model.norm=instance",
                        "--run.log_every=5", f"--run.save_dir={RUN3D}",
                        "--run.name=pix2pix-3d"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model, res = train_pix2pix_3d.train(cfg, train_iters=P2P3D_STEPS,
                                        crop=64, num_downs=6,
                                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(math.isfinite(v) for r in res["log"] for k, v in r.items()),
          f"pix2pix_3d: losses not finite: {res['log']}")
    csv = RUN3D / "pix2pix-3d" / "gen_metrics.csv"
    test = load_volume_splits(cfg, 64)["test"]
    rows = train_pix2pix_3d.evaluate_generation(model, test, 1, str(csv))
    check(len(rows) == len(test["A"]) and csv.exists()
          and all(np.isfinite(v) for r in rows for v in r.values()),
          f"pix2pix_3d: generation CSV {rows}")
    out["pix2pix_3d"] = {"steps": P2P3D_STEPS, "wall_s": wall,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "log": res["log"], "csv_rows": rows,
                         "launches": _launches_zero(kernels, "pix2pix_3d")}
    print(f"[pix2pix_3d] {P2P3D_STEPS} steps in {wall:.2f} s, CSV rows "
          f"{rows}")
    del model
    torch.cuda.empty_cache()

    # (e) train_unet3d: 20 steps at base 64
    cfg = parse_config(["--data.synthetic=true", "--data.n_train=4",
                        "--data.n_val=2", "--data.n_test=2",
                        "--data.batch_size=1",
                        f"--engine.valid_step={VALID_STEP}",
                        f"--run.save_dir={RUN3D}", "--run.name=unet3d"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    net, res = train_unet3d.train(cfg, train_iters=UNET3D_STEPS, crop=64,
                                  device="cuda")
    torch.cuda.synchronize()
    steady = res["log"][1:] or res["log"]
    sps = sum(r["steps"] for r in steady) / sum(r["seconds"] for r in steady)
    check(math.isfinite(res["test_dice"]) and all(
        math.isfinite(r["loss"]) for r in res["log"]),
        f"unet3d: {res}")
    out["unet3d"] = {"steps": UNET3D_STEPS, "steady_steps_per_s": sps,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "test_dice": res["test_dice"],
                     "launches": _launches_zero(kernels, "unet3d")}
    print(f"[unet3d] {sps:.2f} steps/s, peak "
          f"{out['unet3d']['peak_mem_bytes']} bytes")
    del net
    torch.cuda.empty_cache()

    # (f) the card against the CPU: the CPU test's 3-iteration case in f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, ref = _e3d_small_card_vs_cpu(torch)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    keys = ("loss_netG", "loss_netD", "loss_unet")
    worst = max(abs(g[k] - r[k]) / abs(r[k])
                for r, g in zip(ref, got) for k in keys)
    check(worst <= 1e-4, f"end2end_3d small: card {got} against CPU {ref}")
    out["end2end_3d_small"] = {"worst_rel_loss_gap": worst}
    print(f"[end2end_3d small] {E3D_MODE_ITERS} iterations at 32^3 f32, "
          "each from the CPU engine's state, cuda against cpu: largest "
          f"relative loss gap {worst:.3e}")
    return out


# 7g. the soft-intro VAE family at full width: 256^2, decoder ngf 64
# (unet_256, 8 downs), latent 8, the full-width ResNet-18 encoder with its
# 10 cells, bf16 autocast, batch 2, synthetic data, seed 0
RUNVAE = ROOT / "build" / "chip_smoke_vae"
VAE_DEV = "cuda"
VAE_STEPS, VAE_NUM_VAE, VAE_VGG_STEPS = 10, 5, 3
SIVAE_ITERS, SIVAE_DARTS_ITERS, SIVAE_STYLES = 20, 3, 3
# the splits cut to size (the presets' 32/8/594): one epoch is 8 steps
VAE_ARGV = ["--data.synthetic=true", "--data.n_train=16", "--data.n_val=4",
            "--data.n_test=4", f"--run.save_dir={RUNVAE}"]
EVAL_SAMPLES, EVAL_BATCH = 32, 16     # BBDM's sample shape: (N, 1, 256^2, 1)


def _check_full_vae(cfg, label: str):
    check((cfg.data.image_size, cfg.model.ngf, cfg.model.compute_dtype,
           cfg.data.batch_size, cfg.run.seed) ==
          (256, 64, "bfloat16", 2, 0),
          f"{label}: not the full-width soft-intro configuration")


def _vae_train(torch) -> dict:
    """(a) ``train_vae --preset=sivae``: 10 steps, the plain VAE for 5,
    then soft-intro; then 3 steps under ``recon_loss_type='vgg'`` (random
    VGG16 weights from the seed, one plain-VAE step then two soft-intro
    ones). Steady steps/s of each phase (its first step timed apart), the
    peak, the final checkpoint's bytes and write seconds; no kernel
    launched."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_vae
    out = {}
    for label, steps, hp in (
            ("mse", VAE_STEPS, train_vae.SIVAEParams(num_vae=VAE_NUM_VAE)),
            ("vgg", VAE_VGG_STEPS, train_vae.SIVAEParams(
                num_vae=1, recon_loss_type="vgg"))):
        cfg = parse_config(["--preset=sivae"] + VAE_ARGV +
                           [f"--run.name=sivae-{label}"])
        _check_full_vae(cfg, f"train_vae {label}")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer, res = train_vae.train(cfg, steps, hp, device=VAE_DEV)
        wall = time.perf_counter() - t0
        launches = _launches_zero(kernels, f"train_vae {label}")
        check(all(math.isfinite(v) for v in res["metrics"].values()) and
              res["steps"] == steps, f"train_vae {label}: {res}")
        phases = {}
        for name, p in res["phases"].items():
            check(p["steps"] > 0, f"train_vae {label}: no {name} step")
            rest = p["seconds"] - p["first_step_seconds"]
            phases[name] = {**p, "steady_steps_per_s":
                            (p["steps"] - 1) / rest if p["steps"] > 1
                            else None}
        out[label] = {"steps": steps, "num_vae": hp.num_vae, "wall_s": wall,
                      "phases": phases, "metrics": res["metrics"],
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "checkpoint_bytes": res["checkpoint"]["bytes"],
                      "checkpoint_write_s": res["checkpoint"]["seconds"],
                      "checkpoint": res["checkpoint"]["path"],
                      "launches": launches}
        del trainer
        torch.cuda.empty_cache()
    return out


def _sivae_e2e(torch, argv, iters: int, label: str) -> dict:
    """``train_end2end_vae.train`` of the ``end2end_sivae`` preset on the
    card: finite losses, val and test Dice, a panel per chunk; the warp
    and the equalize launched once per U-Net inner step (``decay_only``:
    one per iteration; ``darts``: two, the unroll's and the replay's), the
    other kernels never; the darts hypergradient exactly 0."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_end2end_vae
    cfg = parse_config(["--preset=end2end_sivae"] + VAE_ARGV + argv)
    _check_full_vae(cfg, label)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train_end2end_vae.train(cfg, iters, device=VAE_DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    darts = cfg.engine.hypergrad == "darts"
    unet_steps = iters * (2 if darts else 1)
    want = {"warp_affine": unet_steps, "equalize_uint8": unet_steps,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"{label}: launches {launches}, not {want}")
    for c in results["chunks"]:
        for k in ("loss_netG", "loss_netD", "loss_unet", "val_score"):
            check(math.isfinite(c[k]), f"{label}: {k} not finite: {c}")
        check(not darts or c["arch_grad_norm"] == 0.0,
              f"{label}: darts hypergradient not exactly 0: {c}")
    panels = sorted(p.name for p in (RUNVAE / cfg.run.name /
                                     "panels").iterdir())
    check(len(panels) == len(results["chunks"]) and
          math.isfinite(results.get("test_dice", float("nan"))),
          f"{label}: panels {panels}, results {results}")
    steady = results["chunks"][1:] or results["chunks"]
    its = sum(c["iters"] for c in steady) / sum(c["seconds"] for c in steady)
    del engine
    torch.cuda.empty_cache()
    return {"hypergrad": cfg.engine.hypergrad, "iters": iters, "wall_s": wall,
            "steady_it_per_s": its, "steady_iter_ms": 1e3 / its,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "arch_grad_norm": [c["arch_grad_norm"]
                               for c in results["chunks"]],
            "best_val": results["best_val"],
            "test_dice": results["test_dice"], "panels": panels,
            "launches": launches}


def _random_alex(torch, seed: int):
    """AlexNet-LPIPS with random weights (flax's laws) and lins from
    ``seed``, on the card: the real ones are not in the repository."""
    from semantic_segmentation_torch.models.extractors import (
        ALEX_WIDTHS, AlexNetFeatures)
    from semantic_segmentation_torch.models.vae.sivae import init_weights_
    gen = torch.Generator().manual_seed(seed)
    net = init_weights_(AlexNetFeatures(), gen).to(VAE_DEV).eval()
    lins = [torch.rand(w, generator=gen) / w for w in ALEX_WIDTHS]
    return net, lins


def _vae_inference(torch, ckpt_dir: str) -> dict:
    """(c) ``inference_vae`` from (a)'s checkpoint, 3 styles a condition,
    the diversity under LPIPS-alex with random weights: seconds per
    image, the files."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import inference_vae
    cfg = parse_config(["--preset=sivae"] + VAE_ARGV +
                       ["--run.name=sivae-mse"])
    check(str(RUNVAE / cfg.run.name) == ckpt_dir,
          f"inference_vae: run directory {ckpt_dir}")
    alex = _random_alex(torch, 1)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = inference_vae.run(cfg, num_styles=SIVAE_STYLES, alex=alex,
                            device=VAE_DEV)
    wall = time.perf_counter() - t0
    launches = _launches_zero(kernels, "inference_vae")
    styles = sorted((RUNVAE / cfg.run.name / "inference" /
                     "styles").iterdir())
    check(res["images"] == cfg.data.n_val and
          len(styles) == SIVAE_STYLES * res["images"] and
          math.isfinite(res["diversity"]) and res["diversity"] > 0,
          f"inference_vae: {res}, {len(styles)} style files")
    return {"images": res["images"], "styles": SIVAE_STYLES,
            "wall_s": wall, "seconds_per_image": wall / res["images"],
            "diversity_lpips_alex_random_weights": res["diversity"],
            "launches": launches}


def _vae_eval_metrics(torch) -> dict:
    """(d) FID and LPIPS through ``train_bbdm.evaluate_samples`` on random
    arrays of BBDM's sample shape (32 conditions, one sample each,
    256^2, one channel) with random feature nets: seconds per batch of
    16 of the pool3 features and of LPIPS-alex on the card, and the
    Frechet distance's host seconds (a 2048^2 ``sqrtm``)."""
    import numpy as np
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.models.extractors import \
        InceptionV3Pool3
    from semantic_segmentation_torch.models.vae.sivae import init_weights_
    from semantic_segmentation_torch.ops import gen_metrics
    from semantic_segmentation_torch.train.train_bbdm import evaluate_samples
    rng = np.random.default_rng(0)
    samples = rng.random((EVAL_SAMPLES, 1, 256, 256, 1), np.float32)
    reals = rng.random((EVAL_SAMPLES, 256, 256, 1), np.float32)
    inc = init_weights_(InceptionV3Pool3(), torch.Generator().manual_seed(
        2)).to(VAE_DEV).eval()
    alex = _random_alex(torch, 3)
    kernels.reset_launches()
    gen_metrics.inception_features(inc, samples[:EVAL_BATCH, 0],
                                   EVAL_BATCH)            # warm-up
    gen_metrics.lpips(alex[0], alex[1], reals[:EVAL_BATCH],
                      reals[:EVAL_BATCH], EVAL_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [gen_metrics.inception_features(inc, x, EVAL_BATCH)
             for x in (samples[:, 0], reals)]
    t_inc = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = gen_metrics.lpips(alex[0], alex[1], samples[:, 0], reals,
                           EVAL_BATCH)
    t_lpips = time.perf_counter() - t0
    frechet = gen_metrics.fid_from_features
    t_fid = []

    def timed_frechet(*args):
        t = time.perf_counter()
        got = frechet(*args)
        t_fid.append(time.perf_counter() - t)
        return got
    gen_metrics.fid_from_features = timed_frechet
    t0 = time.perf_counter()
    try:
        scores = evaluate_samples(samples, reals, inception=inc, alex=alex)
    finally:
        gen_metrics.fid_from_features = frechet
    t_eval = time.perf_counter() - t0
    launches = _launches_zero(kernels, "evaluate_samples")
    check(math.isfinite(scores["fid"]) and math.isfinite(scores["lpips"])
          and abs(scores["lpips"] - float(np.mean(lp))) <= 1e-6 *
          abs(scores["lpips"]) and np.isfinite(feats[0]).all(),
          f"evaluate_samples: {scores}")
    batches = 2 * EVAL_SAMPLES // EVAL_BATCH
    return {"samples": EVAL_SAMPLES, "batch": EVAL_BATCH,
            "inception_s_per_batch": t_inc / batches,
            "lpips_s_per_batch": t_lpips / (EVAL_SAMPLES // EVAL_BATCH),
            "frechet_host_s": t_fid[0], "evaluate_samples_s": t_eval,
            "fid_random_weights": scores["fid"],
            "lpips_random_weights": scores["lpips"], "launches": launches}


def _vae_small_card_vs_cpu(torch) -> dict:
    """(e) one ``soft_intro_step`` at smoke width (32^2, decoder ngf 4,
    the full-width encoder, f32, TF32 off) on the card and on the CPU from
    the same weights and draws: each loss's relative gap, and the largest
    gap of the updated parameters over the largest parameter."""
    from semantic_segmentation_torch.models.vae.sivae import SoftIntroVAE
    from semantic_segmentation_torch.train import train_vae
    gen = torch.Generator().manual_seed(4)
    a = (torch.rand(2, 1, 32, 32, generator=gen) > 0.5).float().repeat(
        1, 3, 1, 1)
    b = torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
    draws = train_vae.draw_soft_intro(2, 8, gen)
    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", VAE_DEV):
            vae = SoftIntroVAE(8, 3, 4, "unet_32", device=dev,
                               generator=torch.Generator().manual_seed(5))
            trainer = train_vae.SIVAETrainer(vae, train_vae.SIVAEParams(),
                                             32)
            m = trainer.soft_intro_step(
                a.to(dev), b.to(dev), {k: v.to(dev) for k, v in
                                       draws.items()})
            out[dev] = ({k: float(v) for k, v in m.items()},
                        {k: v.detach().cpu() for k, v in
                         vae.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    (m_gpu, w_gpu), (m_cpu, w_cpu) = out[VAE_DEV], out["cpu"]
    loss_gaps = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    top = max(float(v.abs().max()) for v in w_cpu.values())
    w_gap = max(float((w_gpu[k] - w_cpu[k]).abs().max())
                for k in w_cpu) / top
    # lossE and the metrics of the encoder step read the start state:
    # one step of each device's rounding. lossD reads the encoder after
    # its Adam step, whose first step moves every weight by lr in the
    # sign of its gradient, which rounding decides where the gradient is
    # noise (1.7e-4 apart on the card's first run)
    check(all(math.isfinite(v) for v in m_gpu.values()) and
          max(v for k, v in loss_gaps.items() if k != "lossD") <= 1e-5
          and loss_gaps["lossD"] <= 1e-3,
          f"sivae small: card against CPU losses {m_gpu} {m_cpu}")
    return {"loss_gaps": loss_gaps, "state_gap_of_largest": w_gap,
            "losses_card": m_gpu, "losses_cpu": m_cpu}


def phase_vae(torch, flagship: dict) -> dict:
    """Phase 7g: the soft-intro VAE family on the card. Returns {label:
    stats}."""
    t_phase = time.perf_counter()
    shutil.rmtree(RUNVAE, ignore_errors=True)
    out = {}
    a = _vae_train(torch)
    out["train_vae"] = a["mse"]
    out["train_vae_vgg"] = a["vgg"]
    for label, s in a.items():
        ph = s["phases"]
        print(f"[train_vae {label}] " + "; ".join(
            f"{name} {p['steps']} steps, steady "
            + (f"{p['steady_steps_per_s']:.2f} steps/s"
               if p["steady_steps_per_s"] else "n/a")
            + f" (first step {p['first_step_seconds']:.2f} s)"
            for name, p in ph.items())
            + f"; peak {s['peak_mem_bytes']} bytes; checkpoint "
            f"{s['checkpoint_bytes']} bytes written in "
            f"{s['checkpoint_write_s']:.3f} s")
    out["end2end_sivae"] = b = _sivae_e2e(
        torch, [f"--engine.valid_step={SIVAE_ITERS // 2}"], SIVAE_ITERS,
        "end2end_sivae")
    print(f"[end2end_sivae] decay_only: steady {b['steady_it_per_s']:.2f} "
          f"it/s ({b['steady_iter_ms']:.1f} ms an iteration), peak "
          f"{b['peak_mem_bytes']} bytes, launches {b['launches']}, test "
          f"Dice {b['test_dice']:.4f}; the U-Net flagship (phase 7) "
          f"{flagship['steady_it_per_s']:.2f} it/s")
    out["end2end_sivae_darts"] = d = _sivae_e2e(
        torch, ["--engine.hypergrad=darts", "--run.name=end2end-sivae-darts",
                f"--engine.valid_step={SIVAE_DARTS_ITERS}"],
        SIVAE_DARTS_ITERS, "end2end_sivae darts")
    print(f"[end2end_sivae darts] {SIVAE_DARTS_ITERS} iterations, "
          f"arch_grad_norm {d['arch_grad_norm']}, launches "
          f"{d['launches']}")
    out["inference_vae"] = c = _vae_inference(
        torch, str(Path(a["mse"]["checkpoint"]).parent))
    print(f"[inference_vae] {c['images']} images x {c['styles']} styles, "
          f"{c['seconds_per_image']:.3f} s an image (LPIPS-alex, random "
          "weights)")
    out["vae_eval_metrics"] = e = _vae_eval_metrics(torch)
    print(f"[evaluate_samples] pool3 features "
          f"{e['inception_s_per_batch']:.3f} s, LPIPS-alex "
          f"{e['lpips_s_per_batch']:.3f} s per batch of {EVAL_BATCH}; the "
          f"Frechet distance {e['frechet_host_s']:.2f} s on the host; "
          f"evaluate_samples whole {e['evaluate_samples_s']:.2f} s")
    out["sivae_small"] = g = _vae_small_card_vs_cpu(torch)
    print(f"[sivae small] one soft_intro_step, card against CPU: losses "
          f"{ {k: f'{v:.1e}' for k, v in g['loss_gaps'].items()} }, "
          f"updated state {g['state_gap_of_largest']:.1e} of the largest")
    out["vae_phase"] = {"wall_s": time.perf_counter() - t_phase}
    print(f"[vae] phase 7g took {out['vae_phase']['wall_s']:.1f} s")
    return out


def _tensor_bytes(torch, obj) -> int:
    """The bytes of the tensors in a (nested) dict, list or tuple."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(torch, v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(torch, v) for v in obj)
    return 0


class CountedSaves:
    """Within it ``torch.save`` writes the files under ``keep`` (none when
    ``keep`` is None) to disk; every other call serializes nothing and
    leaves an empty file in its place, and records the bytes of the
    tensors it was handed. Each file's bytes, seconds and whether it was
    written are recorded in ``files``. The H100 host this script was
    measured on caps a run's disk writes at 45 GiB, and one full-width
    ``train_bbdm`` run with two validations writes 87 GB (a trainer
    checkpoint is 19.4 GB); streaming the unwritten files into a byte
    counter took 88 s of a 1,120 s run."""

    def __init__(self, torch, keep: Path | None):
        self.torch, self.keep, self.files = torch, keep, []

    def __enter__(self):
        real = self.real = self.torch.save

        def save(obj, f, *args, **kwargs):
            t0 = time.perf_counter()
            if self.keep is not None and Path(f).is_relative_to(self.keep):
                real(obj, f, *args, **kwargs)
                n, written = Path(f).stat().st_size, True
            else:
                Path(f).parent.mkdir(parents=True, exist_ok=True)
                Path(f).touch()
                n, written = _tensor_bytes(self.torch, obj), False
            self.files.append({"file": str(f), "bytes": n,
                               "seconds": time.perf_counter() - t0,
                               "written": written})
        self.torch.save = save
        return self

    def __exit__(self, *exc):
        self.torch.save = self.real


# 7f. pixel-space BBDM at full width: the ADM denoiser (model_channels 128,
# mult (1, 4, 8), 2 res blocks, 21 NAS cells, 1,211,895,425 parameters),
# 256^2, bf16 autocast, T = 1000 with the 200-step sampler
RUNBBDM = ROOT / "build" / "chip_smoke_bbdm"
BBDM_DEV = "cuda"
BBDM_STEPS, BBDM_VALID, E2EB_ITERS, E2EB_FAKE_ITERS = 6, 3, 10, 1
BBDM_CKPT = RUNBBDM / "bbdm" / "ckpt"  # (a)'s latest: the one file written
BBDM_ARGV = ["--preset=bbdm", "--data.synthetic=true", "--data.n_train=16",
             "--data.n_val=8", "--data.n_test=2",
             f"--engine.valid_step={BBDM_VALID}", f"--run.save_dir={RUNBBDM}"]
E2EB_ARGV = ["--preset=end2end_bbdm", "--data.synthetic=true",
             "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
             f"--run.save_dir={RUNBBDM}"]


def _check_full_bbdm(net, compute_dtype: str, label: str):
    """The full-width denoiser in bf16."""
    check((sum(p.numel() for p in net.parameters()), net.n_cells,
           compute_dtype) == (1_211_895_425, 21, "bfloat16"),
          f"{label}: not the full-width BBDM configuration")


def _bbdm_train(torch, saves: CountedSaves) -> dict:
    """(a) ``train_bbdm --preset=bbdm`` at batch 8, 6 steps, validation
    every 3: steady steps/s, peak, finite losses, the latest checkpoint
    (written to disk), the top-k checkpoints and the weight files
    (their tensors' bytes counted by ``saves``)."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_bbdm
    cfg = parse_config(BBDM_ARGV)
    check(cfg.data.batch_size == 8, "bbdm: the preset's batch is 8")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = train_bbdm.build_model(cfg, BBDM_DEV)
    _check_full_bbdm(model.unet, cfg.model.compute_dtype, "bbdm")
    check((model.sched.num_timesteps, len(model.sched.steps)) == (1000, 200),
          "bbdm: not the template's schedule")
    build_s = time.perf_counter() - t0
    model, res = train_bbdm.train(cfg, BBDM_STEPS, model, device=BBDM_DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches_zero(kernels, "bbdm")
    log = res["log"]
    check(len(log) == BBDM_STEPS // BBDM_VALID and all(
        math.isfinite(r["loss"]) and math.isfinite(r["val_loss"])
        for r in log), f"bbdm: losses {log}")
    run = RUNBBDM / "bbdm"
    top = sorted(p.name for p in (run / "ckpt_top").iterdir())
    files = {Path(f["file"]).relative_to(run).as_posix(): f
             for f in saves.files if Path(f["file"]).is_relative_to(run)}
    check(sorted(p.name for p in (run / "ckpt").iterdir()) ==
          [str(BBDM_STEPS)] and top == sorted(str(r["it"]) for r in log)
          and {"bbdm_best.pt", "bbdm_latest.pt", f"ckpt/{BBDM_STEPS}/"
               "state.pt"} <= {k.replace(".tmp-", "") for k in files},
          f"bbdm: checkpoints latest {list((run / 'ckpt').iterdir())}, "
          f"top-k {top}, files {sorted(files)}")
    steady = log[1:] or log
    sps = sum(r["steps"] for r in steady) / sum(r["seconds"] for r in steady)
    written = [f for f in files.values() if f["written"]]
    check(len(written) == 1 and Path(written[0]["file"]).parent.parent ==
          BBDM_CKPT and written[0]["bytes"] > 10 ** 10,
          f"bbdm: the latest checkpoint alone is written to disk: {files}")
    out = {"steps": BBDM_STEPS, "batch": cfg.data.batch_size,
           "build_s": build_s, "wall_s": wall,
           "steady_steps_per_s": sps, "steady_step_ms": 1e3 / sps,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "log": log, "ckpt_top": top,
           "checkpoint_bytes": written[0]["bytes"],
           "checkpoint_write_s": written[0]["seconds"],
           "files": files, "launches": launches}
    del model
    torch.cuda.empty_cache()
    return out


def _bbdm_sample(torch) -> dict:
    """(b) ``run.sample_only`` (``sample_eval``) in (a)'s run directory: a
    fresh model restores (a)'s latest checkpoint from disk and samples the
    two test conditions, two samples each (one batch sampled twice):
    seconds to build and restore, seconds per 200-step sampling batch, the
    grids, samples in [0, 1], the diversity."""
    import numpy as np
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_bbdm
    cfg = parse_config(BBDM_ARGV + ["--run.sample_only=true"])
    run = RUNBBDM / cfg.run.name
    check(run == BBDM_CKPT.parent, f"bbdm sample: run directory {run}")
    sampling = []
    sample_to_eval = train_bbdm.sample_to_eval

    def timed_sample_to_eval(*args, **kwargs):
        t = time.perf_counter()
        got = sample_to_eval(*args, **kwargs)
        sampling.append(time.perf_counter() - t)    # ends in .cpu()
        return got
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    train_bbdm.sample_to_eval = timed_sample_to_eval
    t0 = time.perf_counter()
    try:
        samples, scores = train_bbdm.sample_eval(cfg, n_per_cond=2,
                                                 device=BBDM_DEV)
    finally:
        train_bbdm.sample_to_eval = sample_to_eval
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    size = cfg.data.image_size
    launches = _launches_zero(kernels, "bbdm sample")
    grids = sorted(p.name for p in (run / "sample_to_eval").iterdir())
    check(samples.shape == (2, 2, size, size, 1) and
          np.isfinite(samples).all() and samples.min() >= 0.0 and
          samples.max() <= 1.0 and math.isfinite(scores["diversity"]) and
          grids == ["cond0.png"],
          f"bbdm sample: {samples.shape} {scores} {grids}")
    # sample_eval logs its scores at the step it restored
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    steps = [r.get("step") for r in records if "sample_eval/diversity" in r]
    check(steps == [BBDM_STEPS], f"bbdm sample: sample_eval logged at "
          f"steps {steps}, not at the restored step {BBDM_STEPS}")
    # one test batch of the two conditions, sampled twice
    out = {"conditions": 2, "samples_per_condition": 2,
           "wall_s": wall, "build_and_restore_s": wall - sampling[0],
           "restored_step": steps[0], "sampling_batch_s": sampling[0] / 2,
           "sampling_batch": 2, "diversity": scores["diversity"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "grids": grids, "launches": launches}
    torch.cuda.empty_cache()
    return out


def _e2eb_train(torch, argv, iters: int, label: str) -> dict:
    """``train_end2end_bbdm.train`` at full width on the card: finite
    losses, val and test Dice, a panel per validation. Returns the stats
    with it/s (steady where there are two chunks), the peak and the
    launches."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_end2end_bbdm
    cfg = parse_config(E2EB_ARGV + argv)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engine, results = train_end2end_bbdm.train(cfg, iters, device=BBDM_DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _check_full_bbdm(engine.problems[0].module, cfg.model.compute_dtype,
                     label)
    chunks = results["chunks"]
    for c in chunks:
        for k in ("loss_netG", "loss_unet", "val_score"):
            check(math.isfinite(c[k]), f"{label}: {k} not finite: {c}")
    check(math.isfinite(results.get("test_dice", float("nan"))),
          f"{label}: no test Dice: {results}")
    panels = sorted(p.name for p in
                    (RUNBBDM / cfg.run.name / "panels").iterdir())
    check(panels == sorted(f"it{c['it']}.png" for c in chunks),
          f"{label}: panels {panels}")
    steady = chunks[1:] or chunks
    its = sum(c["iters"] for c in steady) / sum(c["seconds"] for c in steady)
    out = {"iters": iters, "wall_s": wall, "it_per_s": its,
           "iter_ms": 1e3 / its, "steady": len(chunks) > 1,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "val_scores": [c["val_score"] for c in chunks],
           "test_dice": results["test_dice"], "panels": panels,
           "last_metrics": {k: chunks[-1][k] for k in (
               "loss_netG", "loss_unet", "arch_grad_norm")},
           "launches": launches}
    del engine
    torch.cuda.empty_cache()
    return out


def _e2eb_iters(torch, argv, iters: int, label: str) -> dict:
    """``iters`` engine iterations of ``end2end_bbdm`` built as ``train``
    builds it (no validation, panels or checkpoints), the trainer's index
    streams: seconds an iteration (host clock, ending in a sync), the
    metrics, the peak and the launches."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                           to_device_split)
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import index_streams
    from semantic_segmentation_torch.train.train_end2end_bbdm import (
        PROBLEMS, build_engine)
    cfg = parse_config(E2EB_ARGV + argv)
    torch.cuda.reset_peak_memory_stats()
    engine, _, _ = build_engine(cfg, BBDM_DEV)
    _check_full_bbdm(engine.problems[0].module, cfg.model.compute_dtype,
                     label)
    splits = load_splits(cfg)
    tr, va = (to_device_split(splits[k], BBDM_DEV) for k in ("train", "val"))
    streams, val_stream = index_streams(cfg, cfg.data.n_train,
                                        cfg.data.n_val, names=PROBLEMS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(iters):
        m = engine.engine_step([{n: take_batch(tr, next(s))
                                 for n, s in streams.items()}],
                               take_batch(va, next(val_stream)))
        metrics.append({k: float(v) for k, v in m.items()})
    seconds = (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    check(all(math.isfinite(v) for m in metrics for v in m.values()),
          f"{label}: {metrics}")
    out = {"iters": iters, "seconds_per_iter": seconds, "metrics": metrics,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    del engine
    torch.cuda.empty_cache()
    return out


def _bbdm_small_card_vs_cpu(torch) -> dict:
    """(f) the denoiser at a small width (model_channels 16, one res block,
    mult (1, 2), attention at ds 2, 32^2, f32, TF32 off) on the card
    against the CPU from the same non-zero weights: one forward, and a
    10-step sampling run (T = 20) with the same per-step noises."""
    from semantic_segmentation_torch.models.diffusion.bbdm import \
        BridgeSchedule
    from semantic_segmentation_torch.train.train_bbdm import BBDMModel
    models = {}
    for dev in ("cpu", BBDM_DEV):
        models[dev] = BBDMModel(
            1, model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            schedule=BridgeSchedule(num_timesteps=20, sample_step=10),
            compute_dtype="float32", device=dev, ema=False,
            generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():           # every layer non-zero: the zero-init
        cpu = models["cpu"]         # out_convs would make the output 0
        for p in cpu.unet.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        cpu.arch.copy_(0.5 * torch.randn(cpu.arch.shape, generator=gen))
        models[BBDM_DEV].unet.load_state_dict(cpu.unet.state_dict())
        models[BBDM_DEV].arch.copy_(cpu.arch)
    x = torch.rand(2, 1, 32, 32, generator=gen) * 2 - 1
    y = torch.rand(2, 1, 32, 32, generator=gen) * 2 - 1
    t = torch.tensor([3, 17])
    noises = [torch.randn(2, 1, 32, 32, generator=gen) for _ in range(10)]
    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, m in models.items():
            with torch.no_grad():
                fwd = m.denoiser()(x.to(dev), t.to(dev), y.to(dev), False)
            sample = m.sample_loop(y.to(dev),
                                   noises=[n.to(dev) for n in noises])
            out[dev] = (fwd.cpu(), sample.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())
    fwd_gap = gap(out[BBDM_DEV][0], out["cpu"][0])
    sample_gap = gap(out[BBDM_DEV][1], out["cpu"][1])
    check(float(out["cpu"][0].abs().max()) > 0.1,
          "bbdm small: the forward is 0")
    check(fwd_gap <= 1e-5 and sample_gap <= 1e-4,
          f"bbdm small: card against CPU forward {fwd_gap}, 10-step "
          f"sampling {sample_gap}")
    del models
    torch.cuda.empty_cache()
    return {"forward_gap": fwd_gap, "sampling_gap": sample_gap}


def phase_bbdm(torch, flagship: dict) -> dict:
    """Phase 7f: pixel-space BBDM on the card. Returns {label: stats}."""
    t_phase = time.perf_counter()
    out = {}
    shutil.rmtree(RUNBBDM, ignore_errors=True)   # (b) reads (a)'s run alone
    saves = CountedSaves(torch, BBDM_CKPT)
    with saves:
        out["bbdm_trainer"] = a = _bbdm_train(torch, saves)
        print(f"[bbdm] batch 8: steady {a['steady_steps_per_s']:.3f} "
              f"steps/s ({a['steady_step_ms']:.1f} ms a step), peak "
              f"{a['peak_mem_bytes']} bytes, losses "
              f"{[(r['loss'], r['val_loss']) for r in a['log']]}, top-k "
              f"{a['ckpt_top']}, the latest checkpoint "
              f"{a['checkpoint_bytes']} bytes written in "
              f"{a['checkpoint_write_s']:.1f} s")
        out["bbdm_sample"] = b = _bbdm_sample(torch)
        print(f"[bbdm sample] restored step {b['restored_step']} (build "
              f"and restore {b['build_and_restore_s']:.1f} s); "
              f"{b['sampling_batch_s']:.2f} s per 200-step sampling batch "
              f"of 2, diversity {b['diversity']:.4f}, grids {b['grids']}, "
              f"peak {b['peak_mem_bytes']} bytes")
        out.update(_phase_e2eb(torch, flagship))
    counted = [f for f in saves.files if not f["written"]]
    out["bbdm_saves"] = {"files": len(counted),
                         "bytes": sum(f["bytes"] for f in counted),
                         "seconds": sum(f["seconds"] for f in counted)}
    g = _bbdm_small_card_vs_cpu(torch)
    out["bbdm_small"] = g
    print(f"[bbdm small] card against CPU: forward {g['forward_gap']:.2e}, "
          f"10-step sampling {g['sampling_gap']:.2e} of the largest")
    out["bbdm_phase"] = {"wall_s": time.perf_counter() - t_phase}
    print(f"[bbdm] phase 7f took {out['bbdm_phase']['wall_s']:.1f} s; "
          f"{out['bbdm_saves']['files']} checkpoint and weight files of "
          f"{out['bbdm_saves']['bytes']} tensor bytes counted, not "
          f"serialized or written")
    return out


def _phase_e2eb(torch, flagship: dict) -> dict:
    """(c) ``end2end_bbdm`` at its preset through ``train`` (validation,
    panels, checkpoints); (d) the fake branch and the photometric chain and
    (e) its ``darts`` mode as engine iterations."""
    out = {}
    out["end2end_bbdm"] = c = _e2eb_train(
        torch, ["--engine.valid_step=5"], E2EB_ITERS, "end2end_bbdm")
    check(all(v == 0 for v in c["launches"].values()),
          f"end2end_bbdm (loss_lambda 0): a kernel launched: "
          f"{c['launches']}")
    print(f"[end2end_bbdm] loss_lambda 0: {c['it_per_s']:.3f} it/s, peak "
          f"{c['peak_mem_bytes']} bytes, panels {c['panels']}, launches "
          f"{c['launches']}; the U-Net flagship (phase 7) "
          f"{flagship['steady_it_per_s']:.2f} it/s")
    out["end2end_bbdm_fake"] = d = _e2eb_iters(
        torch, ["--optim.loss_lambda=1.0"], E2EB_FAKE_ITERS,
        "end2end_bbdm fake")
    check(d["launches"]["warp_affine"] == E2EB_FAKE_ITERS and
          d["launches"]["equalize_uint8"] == 0 and
          d["launches"]["histogram256"] == d["launches"]["conv_down4"] == 0,
          f"end2end_bbdm fake: launches {d['launches']}, expected one "
          "warp per unet inner step")
    print(f"[end2end_bbdm fake] loss_lambda 1: {d['seconds_per_iter']:.2f} "
          f"s an iteration (a 200-step sampling at batch 2 inside), peak "
          f"{d['peak_mem_bytes']} bytes, launches {d['launches']}")
    out["end2end_bbdm_photometric"] = e = _e2eb_iters(
        torch, ["--optim.loss_lambda=1.0",
                "--engine.fake_postprocess=photometric"], 1,
        "end2end_bbdm photometric")
    check(e["launches"]["warp_affine"] == 1 and
          e["launches"]["equalize_uint8"] == 1,
          f"end2end_bbdm photometric: launches {e['launches']}")
    print(f"[end2end_bbdm photometric] {e['seconds_per_iter']:.2f} s, "
          f"launches {e['launches']}")
    # (e) the reference's darts: its hypergradient exactly 0
    out["end2end_bbdm_darts"] = f = _e2eb_iters(
        torch, ["--engine.hypergrad=darts"], 1, "end2end_bbdm darts")
    check(f["metrics"][0]["arch_grad_norm"] == 0.0 and
          all(v == 0 for v in f["launches"].values()),
          f"end2end_bbdm darts: hypergradient not exactly 0, or a kernel "
          f"launched: {f}")
    print(f"[end2end_bbdm darts] one iteration in "
          f"{f['seconds_per_iter']:.2f} s, hypergradient exactly 0, peak "
          f"{f['peak_mem_bytes']} bytes")
    return out


# 7h. the rest of the pix2pix family at full width, in the main process
COLOR_DIR = DATA_DIR / "color"
P2PF_DEV = "cuda"
WGANGP_STEPS, COLOR_STEPS = 5, 10


def write_rgb_folder(root: Path, n: int = 16, size: int = 300,
                     seed: int = 31) -> Path:
    """``n`` RGB PNGs at ``size``^2 under ``root/Images``: smooth random
    colour fields (8x8 random colours, bicubic-upsampled; the loaders
    resize them to 256^2)."""
    import numpy as np
    from PIL import Image
    shutil.rmtree(root, ignore_errors=True)
    (root / "Images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8), "RGB"
                        ).resize((size, size), Image.BICUBIC).save(
            root / "Images" / f"img{i:02d}.png")
    return root


def _report(out_dir, n_items: int, per_row: int, label: str) -> dict:
    """``test_pix2pix``'s report: one titled row per item, ``per_row``
    images each."""
    out_dir = Path(out_dir)
    rows = (out_dir / "index.html").read_text().count("<h3>")
    images = sorted(p.name for p in (out_dir / "images").iterdir())
    check(rows == n_items and len(images) == per_row * n_items,
          f"{label}: {rows} rows and {len(images)} images for {n_items} "
          f"items")
    return {"rows": rows, "images": len(images)}


def _full_pix2pix(cfg, label: str, output_nc: int = 1):
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.output_nc, m.compute_dtype) ==
          (256, 2, "unet_256", 64, 64, output_nc, "bfloat16"),
          f"{label}: not the full-width pix2pix configuration")


def phase_pix2pix_family(torch, ckpt) -> dict:
    """Phase 7h (module docstring). Returns {label: stats}."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
    from semantic_segmentation_torch.train import test_pix2pix, train_pix2pix
    from semantic_segmentation_torch.utils.bridge import (arch_to_flax,
                                                          state_dict_to_flax)
    from semantic_segmentation_torch.utils.serialization import save_pytree
    t_phase = time.perf_counter()
    out = {}

    # (a) test_pix2pix from phase 6's checkpoint over phase 7b's folder
    jsrt = DATA_DIR / "jsrt"
    n_items = len(list((jsrt / "Images").iterdir()))
    cfg = parse_config([f"--data.dataroot={jsrt}",
                        f"--run.pretrained_pix2pix={ckpt}",
                        f"--run.save_dir={SAVE_DIR}",
                        "--run.name=test_pix2pix"], preset="pix2pix_jsrt")
    _full_pix2pix(cfg, "test_pix2pix")
    kernels.reset_launches()
    t0 = time.perf_counter()
    report = test_pix2pix.run(cfg, device=P2PF_DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["test_pix2pix"] = a = {
        "items": n_items, "wall_s": wall, "seconds_per_image": wall / n_items,
        **_report(report, n_items, 3, "test_pix2pix"),
        "launches": _launches_zero(kernels, "test_pix2pix")}
    print(f"[test_pix2pix] {n_items} items of {jsrt} from {ckpt}: "
          f"{a['seconds_per_image'] * 1e3:.1f} ms an image (model build, "
          f"checkpoint load, PNG decode and the report's writes included)")

    # (b) stage 1 under wgangp, a sample grid every step
    cfg = parse_config(["--data.synthetic=true", "--optim.gan_mode=wgangp",
                        "--run.log_every=1", f"--run.save_dir={SAVE_DIR}",
                        "--run.name=pix2pix-wgangp"], preset="pix2pix_jsrt")
    _full_pix2pix(cfg, "wgangp")
    check(cfg.optim.gan_mode == "wgangp", "wgangp: not the wgangp mode")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    model, res = train_pix2pix.train(cfg, train_iters=WGANGP_STEPS,
                                     device=P2PF_DEV)
    del model
    log = res["log"]
    check(len(log) == WGANGP_STEPS and all(
        math.isfinite(r[k]) for r in log
        for k in ("loss_G", "loss_D", "loss_D_fake", "loss_D_real")),
          f"wgangp: losses {log}")
    grids = sorted(p.name for p in
                   (SAVE_DIR / cfg.run.name / "samples").iterdir())
    check(grids == sorted(f"step{i}.png"
                          for i in range(1, WGANGP_STEPS + 1)),
          f"wgangp: grids {grids}")
    steady = log[1:]
    out["wgangp_trainer"] = b = {
        "steps": WGANGP_STEPS,
        "steady_steps_per_s": sum(r["steps"] for r in steady)
        / sum(r["seconds"] for r in steady),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "losses": [{k: r[k] for k in ("loss_G", "loss_D")} for r in log],
        "grids": len(grids), "launches": _launches_zero(kernels, "wgangp")}
    print(f"[wgangp] {b['steady_steps_per_s']:.2f} steps/s (a grid written "
          f"every step, outside the timed steps), peak "
          f"{b['peak_mem_bytes']} bytes, losses {b['losses']}")
    torch.cuda.empty_cache()

    # (c) colorization (L -> ab) from a folder of RGB PNGs, then its report
    root = write_rgb_folder(COLOR_DIR)
    argv = [f"--data.dataroot={root}", "--data.n_train=12", "--data.n_val=2",
            "--data.n_test=2", "--run.log_every=5",
            f"--run.save_dir={SAVE_DIR}"]
    cfg = parse_config(argv, preset="pix2pix_colorization")
    _full_pix2pix(cfg, "colorization", output_nc=2)
    check(cfg.model.input_nc == 1, "colorization: input_nc is not 1")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    model, res = train_pix2pix.train(cfg, train_iters=COLOR_STEPS,
                                     device=P2PF_DEV)
    del model
    log = res["log"]
    check(all(math.isfinite(r["loss_G"]) and math.isfinite(r["loss_D"])
              for r in log), f"colorization: losses {log}")
    launches = _launches_zero(kernels, "colorization")
    peak = torch.cuda.max_memory_allocated()
    run_dir = SAVE_DIR / cfg.run.name
    kernels.reset_launches()
    t0 = time.perf_counter()
    report = test_pix2pix.run(parse_config(
        argv + [f"--run.pretrained_pix2pix={run_dir}"],
        preset="pix2pix_colorization"), device=P2PF_DEV)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    n_color = len(list((root / "Images").iterdir()))
    import numpy as np
    from PIL import Image
    fake = np.asarray(Image.open(Path(report) / "images" /
                                 "item0000_fake.png"))
    check(fake.shape == (256, 256, 3),
          f"colorization report: the fake is {fake.shape}, not RGB")
    out["colorization_trainer"] = c = {
        "steps": COLOR_STEPS,
        "steady_steps_per_s": log[1]["steps"] / log[1]["seconds"],
        "peak_mem_bytes": peak, "losses": log[-1],
        "samples": len(list((run_dir / "samples").iterdir())),
        "report_items": n_color, "report_s": report_s,
        **_report(report, n_color, 3, "colorization report"),
        "launches": launches,
        "report_launches": _launches_zero(kernels, "colorization report")}
    print(f"[colorization] 1 -> 2 channels: {c['steady_steps_per_s']:.2f} "
          f"steps/s, peak {peak} bytes; test_pix2pix's L/ab report of "
          f"{n_color} items in {report_s:.2f} s")
    torch.cuda.empty_cache()

    # (d) phase 6's G and D as the JAX package's .msgpack pair, loaded back
    cfg = parse_config(["--data.synthetic=true"], preset="pix2pix_jsrt")
    saved = train_pix2pix.build_pix2pix(cfg, P2PF_DEV,
                                        torch.Generator().manual_seed(5))
    train_pix2pix.load_model(saved, str(ckpt))
    jdir = SAVE_DIR / "pix2pix-msgpack"
    shutil.rmtree(jdir, ignore_errors=True)
    t0 = time.perf_counter()
    # the JAX package's save_model files, in flax's layouts
    jdir.mkdir(parents=True)
    g_params, g_stats = state_dict_to_flax(saved.G, saved.G.state_dict())
    d_params, d_stats = state_dict_to_flax(saved.D, saved.D.state_dict())
    save_pytree({"g_params": g_params, "g_stats": g_stats,
                 "arch": arch_to_flax(saved.arch)},
                str(jdir / train_pix2pix.JAX_FILES[0]))
    save_pytree({"d_params": d_params, "d_stats": d_stats},
                str(jdir / train_pix2pix.JAX_FILES[1]))
    write_s = time.perf_counter() - t0
    check(sorted(p.name for p in jdir.iterdir()) ==
          sorted(train_pix2pix.JAX_FILES), f"msgpack: files in {jdir}")
    fresh = train_pix2pix.build_pix2pix(cfg, P2PF_DEV,
                                        torch.Generator().manual_seed(6))
    t0 = time.perf_counter()
    train_pix2pix.load_model(fresh, str(jdir))
    load_s = time.perf_counter() - t0
    ds = SyntheticSegDataset(n=2, size=256, seed=9)
    x = torch.stack([torch.from_numpy(ds[i]["mask_pix2pix"])
                     for i in range(2)]).float().to(P2PF_DEV)
    same = torch.equal(saved.generate(x), fresh.generate(x))
    check(same and all(torch.equal(v, saved.G.state_dict()[k])
                       for k, v in fresh.G.state_dict().items()),
          "msgpack: G loaded from the .msgpack pair differs from the "
          "saved one")
    out["pix2pix_msgpack"] = d = {
        "bytes": {p.name: p.stat().st_size for p in jdir.iterdir()},
        "write_s": write_s, "load_s": load_s, "generate_identical": same}
    print(f"[pix2pix msgpack] phase 6's G and D written as the JAX "
          f"package's pair ({d['bytes']}) in {write_s:.2f} s, loaded into "
          f"a fresh Pix2Pix on the card in {load_s:.2f} s: G's output "
          f"identical")
    del saved, fresh
    torch.cuda.empty_cache()
    out["pix2pix_family_phase"] = {"wall_s": time.perf_counter() - t_phase}
    print(f"[pix2pix family] phase 7h took "
          f"{out['pix2pix_family_phase']['wall_s']:.1f} s")
    return out


# 7i. latent BBDM and its VQGAN at full width, in the BBDM child process
LBBDM_DIR = ROOT / "build" / "chip_smoke_lbbdm"
VQ_STEPS, VQ_DISC_START, VQ_BATCH, LBBDM_STEPS = 10, 5, 8, 20
LBBDM_ARGV = ["--preset=bbdm", "--data.dataset=bbdm_colorization_rgb",
              f"--data.dataroot={LBBDM_DIR / 'data'}", "--data.n_train=12",
              "--data.n_val=2", "--data.n_test=2", "--model.output_nc=3",
              "--engine.valid_step=10", f"--run.save_dir={LBBDM_DIR}",
              "--run.name=lbbdm"]


def _vqgan_train(torch, images) -> tuple:
    """(a) ``VQGANTrainer`` on the JAX ``VQModel``'s defaults (the f4 first
    stage) at batch 8, bf16, with VGG-LPIPS on random VGG16 weights and
    lins from the seed, ``disc_start`` 5: each optimizer step timed.
    Returns (the trained VQ model, stats)."""
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.models.diffusion.vqgan import VQModel
    from semantic_segmentation_torch.models.diffusion.vqgan_train import \
        VQGANTrainer
    from semantic_segmentation_torch.models.vgg import VGG16Features
    dev = BBDM_DEV
    vq = VQModel(amp=lambda: torch.autocast(torch.device(dev).type,
                                            dtype=torch.bfloat16),
                 generator=torch.Generator().manual_seed(0)).to(dev)
    n_params = sum(p.numel() for p in vq.parameters())
    enc = vq.encoder
    check((enc.conv_in.out_channels, len(enc.down), len(enc.down[0].block),
           vq.embed_dim, vq.quantize.n_embed, vq.downsample) ==
          (128, 3, 2, 3, 16384, 4), "vqgan: not the JAX VQModel defaults")
    torch.manual_seed(1)                  # VGG16's torch-default init
    vgg = VGG16Features().to(dev)
    g = torch.Generator().manual_seed(2)
    lins = [(torch.rand(w, generator=g) / w).to(dev)
            for w in (64, 128, 256, 512, 512)]
    trainer = VQGANTrainer(vq, disc_start=VQ_DISC_START,
                           perceptual=(vgg, lins),
                           generator=torch.Generator().manual_seed(3))
    x = images[:VQ_BATCH]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ae_s, d_s, recs = [], [], []
    for step in range(VQ_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_ae = trainer.train_step_ae(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m_d = trainer.train_step_disc(x)
        torch.cuda.synchronize()
        d_s.append(time.perf_counter() - t1)
        ae_s.append(t1 - t0)
        rec = {k: float(v) for k, v in {**m_ae, **m_d}.items()}
        active = step >= VQ_DISC_START
        check(all(math.isfinite(v) for v in rec.values())
              and rec["disc_factor"] == float(active)
              and (rec["discloss"] > 0) == active,
              f"vqgan step {step}: {rec}")
        recs.append(rec)
    stats = {"params": n_params, "steps": VQ_STEPS, "batch": VQ_BATCH,
             "ae_first_step_s": ae_s[0], "disc_first_step_s": d_s[0],
             "ae_steps_per_s": (VQ_STEPS - 1) / sum(ae_s[1:]),
             "disc_steps_per_s": (VQ_STEPS - 1) / sum(d_s[1:]),
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "d_weight": [r["d_weight"] for r in recs],
             "last": recs[-1], "launches": _launches_zero(kernels, "vqgan")}
    del trainer, vgg
    vq.requires_grad_(False)
    torch.cuda.empty_cache()
    return vq, stats


def _lbbdm(torch, vq, splits) -> dict:
    """(b) ``BBDMModel`` in the latent space of the frozen ``vq`` at the
    ``bbdm`` preset's widths, with normalized latents: ``train_bbdm.train``
    for 20 steps at batch 8 (its checkpoints counted, not written),
    then one 200-step sampling batch of 2 decoded to 256^2."""
    import numpy as np
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_bbdm
    dev = BBDM_DEV
    cfg = parse_config(LBBDM_ARGV)
    check((cfg.data.batch_size, cfg.data.image_size,
           cfg.model.compute_dtype) == (8, 256, "bfloat16"),
          "lbbdm: not the bbdm preset's batch, size and dtype")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    model = train_bbdm.BBDMModel(
        3, compute_dtype=cfg.model.compute_dtype, device=dev,
        generator=torch.Generator(device=dev).manual_seed(cfg.run.seed),
        vqgan=vq, normalize_latent=True)
    n_params = sum(p.numel() for p in model.unet.parameters())
    check((model.n_cells, model.unet.model_channels,
           model.unet.in0.in_channels) == (21, 128, 6),
          "lbbdm: not the bbdm preset's denoiser on the 3-channel latent")
    imgs = torch.from_numpy(splits["train"]["image_pix2pix"][:VQ_BATCH])
    model.latent_stats = model.latent.estimate_latent_stats(
        imgs.permute(0, 3, 1, 2).to(dev) * 2 - 1)
    saves = CountedSaves(torch, None)
    t0 = time.perf_counter()
    with saves:
        model, res = train_bbdm.train(cfg, LBBDM_STEPS, model, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = res["log"]
    check(len(log) == 2 and all(math.isfinite(r["loss"]) and
                                math.isfinite(r["val_loss"]) for r in log),
          f"lbbdm: losses {log}")
    peak = torch.cuda.max_memory_allocated()
    cond = torch.from_numpy(splits["val"]["mask_pix2pix"][:2]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample = model.sample(cond, generator=torch.Generator(
        device=dev).manual_seed(7))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    s = sample.cpu().numpy()
    check(s.shape == (2, 256, 256, 3) and np.isfinite(s).all(),
          f"lbbdm sample: {s.shape}, finite {np.isfinite(s).all()}")
    out = {"params": n_params, "steps": LBBDM_STEPS,
           "batch": cfg.data.batch_size, "wall_s": wall,
           "steady_steps_per_s": log[1]["steps"] / log[1]["seconds"],
           "first_chunk_s": log[0]["seconds"], "peak_mem_bytes": peak,
           "latent_stats": {k: float(v) for k, v in
                            model.latent_stats.items()},
           "log": log, "sampling_batch_s": sample_s, "sampling_batch": 2,
           "sample_range": [float(s.min()), float(s.max())],
           "unwritten_saves": len(saves.files),
           "unwritten_bytes": sum(f["bytes"] for f in saves.files),
           "launches": _launches_zero(kernels, "lbbdm")}
    del model
    torch.cuda.empty_cache()
    return out


def _vqgan_small_card_vs_cpu(torch) -> dict:
    """(c) a small VQ model (ch 32, ch_mult (1, 2), 64 codes, f32, TF32 off)
    on the card against the CPU from the same weights: the encoder, the
    code indices, the decoder and one autoencoder step's losses."""
    import copy
    from semantic_segmentation_torch.models.diffusion.vqgan import VQModel
    from semantic_segmentation_torch.models.diffusion.vqgan_train import \
        VQGANTrainer
    dev = BBDM_DEV
    cpu = VQModel(ch=32, ch_mult=(1, 2), n_embed=64,
                  generator=torch.Generator().manual_seed(4))
    card = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():             # codes spread over the latent's range
        for m in (cpu, card):
            m.quantize.embedding.weight.copy_(
                torch.randn(64, 3, generator=torch.Generator().manual_seed(
                    6)).to(m.quantize.embedding.weight.device))
    x = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for name, m in (("cpu", cpu), ("card", card)):
            xd = x.to(next(m.parameters()).device).permute(0, 3, 1, 2)
            with torch.no_grad():
                z = m.encode_pre_quant(xd)
                zq, _, idx = m.quantize(z)
                rec = m.decode(zq)
            tr = VQGANTrainer(m, disc_start=0, disc_ndf=16,
                              generator=torch.Generator().manual_seed(7))
            losses = {k: float(v) for k, v in
                      tr.train_step_ae(x.to(xd.device)).items()}
            res[name] = (z.cpu(), idx.cpu(), rec.cpu(), losses)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())
    (zc, ic, rc, lc), (zg, ig, rg, lg) = res["cpu"], res["card"]
    loss_gap = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12)
                   for k in ("aeloss", "nll_loss", "g_loss", "qloss",
                             "d_weight"))
    out = {"encode_gap": gap(zg, zc), "decode_gap": gap(rg, rc),
           "indices_equal": bool(torch.equal(ig, ic)),
           "codes_used": int(ic.unique().numel()),
           "ae_loss_gap": loss_gap, "losses_card": lg, "losses_cpu": lc}
    check(out["encode_gap"] <= 1e-5 and out["indices_equal"]
          and out["decode_gap"] <= 1e-5 and loss_gap <= 1e-4,
          f"vqgan small: card against CPU {out}")
    del card
    torch.cuda.empty_cache()
    return out


def phase_lbbdm(torch) -> dict:
    """Phase 7i (module docstring). Returns {label: stats}."""
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.core.config import parse_config
    t_phase = time.perf_counter()
    shutil.rmtree(LBBDM_DIR, ignore_errors=True)
    write_rgb_folder(LBBDM_DIR / "data", seed=32)
    splits = load_splits(parse_config(LBBDM_ARGV))
    images = torch.from_numpy(splits["train"]["image_pix2pix"]).to(
        BBDM_DEV) * 2 - 1
    out = {}
    vq, a = _vqgan_train(torch, images)
    out["vqgan_trainer"] = a
    print(f"[vqgan] {a['params']} parameters, batch {VQ_BATCH} at 256^2: "
          f"autoencoder step {a['ae_steps_per_s']:.2f} steps/s, D step "
          f"{a['disc_steps_per_s']:.2f} steps/s (first steps "
          f"{a['ae_first_step_s']:.2f} s and {a['disc_first_step_s']:.2f} "
          f"s), peak {a['peak_mem_bytes']} bytes, d_weight {a['d_weight']}")
    out["lbbdm_trainer"] = b = _lbbdm(torch, vq, splits)
    print(f"[lbbdm] denoiser {b['params']} parameters on the 3 x 64^2 "
          f"latent, batch 8: {b['steady_steps_per_s']:.2f} steps/s, peak "
          f"{b['peak_mem_bytes']} bytes, losses "
          f"{[(r['loss'], r['val_loss']) for r in b['log']]}; one 200-step "
          f"sampling batch of 2 decoded to 256^2 in "
          f"{b['sampling_batch_s']:.2f} s")
    del vq
    torch.cuda.empty_cache()
    out["vqgan_small"] = c = _vqgan_small_card_vs_cpu(torch)
    print(f"[vqgan small] card against CPU: encoder {c['encode_gap']:.2e}, "
          f"decoder {c['decode_gap']:.2e}, indices equal "
          f"({c['codes_used']} codes used), autoencoder-step losses "
          f"{c['ae_loss_gap']:.2e}")
    out["lbbdm_phase"] = {"wall_s": time.perf_counter() - t_phase}
    print(f"[lbbdm] phase 7i took {out['lbbdm_phase']['wall_s']:.1f} s")
    return out


# -- 7j. data parallelism ------------------------------------------------------

DP_DIR = ROOT / "build" / "chip_smoke_dp"
NCCL_ARG = "--nccl-child"
# mode -> (preset, iterations) of the two-rank harness, 7j (a) and 7k (a)
DP_MODES = {"decay_only": ("end2end_jsrt", 2), "unroll": ("end2end_nas", 1)}
DP_ENTRY_ITERS, DP_ENTRY_VALID = 10, 5
DP_DEV = "cuda"
DP_ARGV = ("--data.synthetic=true", f"--run.device={DP_DEV}")


def _dp_steps(cfg, iters: int) -> list:
    """``iters`` global engine steps (batch_stack, val_batch, no injected
    draws) from the trainer's own index streams, on the CPU."""
    from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                           to_device_split)
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import index_streams
    splits = load_splits(cfg)
    tr = to_device_split(splits["train"], "cpu")
    va = to_device_split(splits["val"], "cpu")
    streams, val_stream = index_streams(cfg, len(splits["train"]["image"]),
                                        len(splits["val"]["image"]))
    return [([{n: take_batch(tr, next(s)) for n, s in streams.items()}],
             take_batch(va, next(val_stream)), None) for _ in range(iters)]


def _within_spread(gap: dict, spread: dict, label: str, skip=()):
    """Each gap of ``gap`` but ``skip`` within 4x its one-ulp spread."""
    for k, g in gap.items():
        if k in skip:
            continue
        check(g <= 4.0 * spread[k],
              f"{label}: {k} gap {g:.3e} above 4x the single-process "
              f"spread {spread[k]:.3e}")


def _parallel_run(stage: str, mode: str, preset: str, iters: int,
                  rec: dict, k: int) -> dict:
    """The checks and the record of ``rec['runs'][k]``, one parallel run
    of ``harness.alone_and_on_ranks`` (``stage`` '7j' or '7k'), against
    rank 0's run alone: the losses, ``arch_grad_norm`` (``unroll``) and the
    state gaps each within 4x its one-ulp spread (the gradients per leaf
    printed, not held: a leaf of one element, PatchGAN's head bias,
    carries the bf16 rounding of the convolutions, whose algorithms the
    one-ulp runs do not sample), the metrics finite, the warp and the
    equalize launched on each rank as the mode runs them."""
    one, two = rec["one"], rec["runs"][k]
    gap, spread = two["gap"], rec["spread"]
    by_run = [r["gap"] for r in rec["nudged"]]
    check(one["world"] == 1 and two["world"] == 2,
          f"{stage} {mode}: {one['world']} and {two['world']} ranks")
    if mode == "unroll":
        check(all(math.isfinite(r["arch_grad_norm"]) and
                  r["arch_grad_norm"] > 0 for r in two["metrics"]),
              f"{stage} unroll: arch_grad_norm {two['metrics']}")
    for r in (one, two):
        for mt in r["metrics"]:
            check(all(math.isfinite(v) for v in mt.values()),
                  f"{stage} {mode}: a metric is not finite: {mt}")
    _within_spread(gap, spread, f"{stage} {mode}", skip=("grads_leaf",))
    warps, equalizes = (1, 1) if mode == "decay_only" else (3, 0)
    want = {"warp_affine": warps * iters, "equalize_uint8": equalizes * iters,
            "histogram256": 0, "conv_down4": 0}
    check(two["launches"] == one["launches"] == want,
          f"{stage} {mode}: launches rank 0 {two['launches']}, one "
          f"process {one['launches']}, not {want}")
    ga = two["grad_allreduce"]
    out = {"preset": preset, "iters": iters,
           "it_per_s_two_ranks": iters / sum(two["seconds"]),
           "it_per_s_one_process": iters / sum(one["seconds"]),
           "step_s_two_ranks": two["seconds"],
           "peak_bytes_per_rank": two["peak_bytes"],
           "peak_bytes_one_process": one["peak_bytes"][0],
           "grad_allreduce_bytes_per_iter": ga["bytes"] / iters,
           "grad_allreduce_s_per_iter": ga["seconds"] / iters,
           "grad_allreduce_calls_per_iter": ga["calls"] / iters,
           "gap": gap, "spread": spread,
           "spread_by_run": dict(zip(("one_ulp_up", "one_ulp_down"),
                                     by_run)),
           "alone_runs_s": rec["alone_s"], "two_ranks_s": rec["ranks_s"][k],
           "last_metrics": two["metrics"][-1], "launches": two["launches"]}
    if two["leaf_bytes"] is not None:            # tensor-parallel
        sharded, whole = two["leaf_bytes"]
        check(two["tp"]["calls"] > 0 and sharded > 0,
              f"{stage} {mode}: model group {two['tp']}, sharded "
              f"{sharded} B")
        out.update(mesh=TP_MESH, sharded_leaf_bytes_rank0=sharded,
                   whole_leaf_bytes_rank0=whole,
                   gather_bytes_per_iter=two["tp"]["bytes"] / iters,
                   gather_calls_per_iter=two["tp"]["calls"] / iters,
                   gather_s_per_iter=two["tp"]["seconds"] / iters,
                   launches_per_rank=two["launches"])
    return out


def phase_parallel_ranks(torch, ckpt) -> dict:
    """7j (a) and 7k (a), (b), (d) on one pool of two ranks that share the
    one card (gloo with CUDA tensors: NCCL refuses two ranks on one
    device), at the full-width flagship (256^2, global batch 2, bf16) from
    phase 6's G, D and arch tables: 2 ``decay_only`` iterations and 1
    ``unroll`` one (``end2end_nas``: the in-graph all-reduce of the inner
    gradients and the min-max gradient across the ranks), each from one
    state with one set of draws (the engine's generator, at the global
    batch's shape). Rank 0 first runs the iterations alone, the
    collectives off (``harness.alone_and_on_ranks``: a state of 2.4 GB
    would take some 50 s to cross a pipe), then from the nets with every
    parameter one ulp up and one ulp down (a repeat is bit for bit the
    same): the spread, the largest gap of those runs to the first. Then
    the two ranks run them data-parallel, one row a rank (7j (a)), and
    tensor-parallel on the mesh (data 1, model 2), the whole batch on each
    and every covered layer's output channels split (7k (a)), each held
    against that one set of runs alone (``_parallel_run``). Then 7k (b)
    (``tp_seg_step``) and (d) (``train_unet3d`` at ``run.spatial_axis=2``)
    on the same ranks. Prints it/s of both, each rank's peak, the gradient
    all-reduces' and the channel gathers' bytes and seconds an iteration
    (through host memory under gloo: a correctness harness, not a speed
    figure). One set of runs alone serves both parallel forms."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.parallel import harness
    from semantic_segmentation_torch.parallel.launch import RankPool
    DP_DIR.mkdir(parents=True, exist_ok=True)
    TP_DIR.mkdir(parents=True, exist_ok=True)
    argv = tuple(DP_ARGV) + (f"--run.pretrained_pix2pix={ckpt}",)
    out = {}
    t_pool = time.perf_counter()
    with RankPool(2, DP_DEV, backend="gloo", timeout=900.0, threads=4,
                  workdir=str(DP_DIR)) as pool:
        pool_s = time.perf_counter() - t_pool
        for mode, (preset, iters) in DP_MODES.items():
            cfg = parse_config(list(argv), preset=preset)
            m = cfg.model
            check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf,
                   m.ndf, m.base_features, m.compute_dtype,
                   cfg.engine.hypergrad) ==
                  (256, 2, "unet_256", 64, 64, 64, "bfloat16", mode),
                  f"7j {mode}: not the full-width {preset} configuration")
            # every run starts from the nets as built (phase 6's G, D and
            # arch tables, the seed's U-Net), which each rank builds
            rec = pool.run(harness.alone_and_on_ranks, argv, preset, DP_DEV,
                           _dp_steps(cfg, iters), meshes=(None, TP_MESH))
            out[f"dp_gloo_{mode}"] = _parallel_run("7j", mode, preset,
                                                   iters, rec, 0)
            out[f"tp_gloo_{mode}"] = _parallel_run("7k", mode, preset,
                                                   iters, rec, 1)
        t_tp = time.perf_counter()
        out.update(_tp_seg(torch, pool))
        out.update(_spatial_unet3d(torch, pool))
        tp_rest_s = time.perf_counter() - t_tp
    out["dp_gloo_decay_only"]["pool_start_s"] = pool_s
    out["tp_gloo_decay_only"]["seg_and_spatial_s"] = tp_rest_s
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_child(torch, out_file: str, argv: list) -> int:
    """The real flagship entry, ``train_end2end.main(argv)``, in this fresh
    process; its kernel launches, the process group and the gradient
    all-reduces to ``out_file``. Over NCCL, then 7k (c) in the same group
    (``tp_in_group``), its record beside."""
    import torch.distributed as dist

    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.parallel import collectives
    from semantic_segmentation_torch.train import train_end2end
    kernels.reset_launches()
    collectives.reset_grad_stats(False)
    t0 = time.perf_counter()
    train_end2end.main(argv)
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "launches": dict(kernels.LAUNCHES),
           "grad_allreduce": {k: collectives.GRAD_STATS[k]
                              for k in ("calls", "bytes", "seconds")},
           "backend": dist.get_backend() if dist.is_initialized() else None,
           "world": dist.get_world_size() if dist.is_initialized() else 0,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if dist.is_initialized() and dist.get_backend() == "nccl":
        ckpt = next(a.split("=", 1)[1] for a in argv
                    if a.startswith("--run.pretrained_pix2pix="))
        rec["tp_in_group"] = tp_in_group(ckpt)
    if dist.is_initialized():
        dist.destroy_process_group()
    Path(out_file).write_text(json.dumps(rec))
    return 0


def _entry_run(name: str, ckpt, *extra) -> tuple[dict, list]:
    """``train_end2end.main`` in a child process (``nccl_child``): its
    record and its metric stream."""
    run_dir = DP_DIR / "entry"
    shutil.rmtree(run_dir / name, ignore_errors=True)
    rec_file = DP_DIR / f"{name}.json"
    rec_file.unlink(missing_ok=True)
    argv = ["--preset=end2end_jsrt", "--data.synthetic=true",
            f"--run.pretrained_pix2pix={ckpt}",
            "--run.final_checkpoint=false",     # 3.7 GB each, not read
            f"--engine.train_iters={DP_ENTRY_ITERS}",
            f"--engine.valid_step={DP_ENTRY_VALID}",
            f"--run.save_dir={run_dir}", f"--run.name={name}", *extra]
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         NCCL_ARG, str(rec_file), *argv]).returncode
    check(rc == 0 and rec_file.is_file(), f"7j {name}: the child exited {rc}")
    stream = [json.loads(line) for line in
              (run_dir / name / "metrics.jsonl").read_text().splitlines()]
    return json.loads(rec_file.read_text()), stream


def phase_dp_nccl(torch, ckpt, flagship: dict) -> dict:
    """7j (b): the flagship entry ``python -m
    semantic_segmentation_torch.train.train_end2end`` (its ``main``, in a
    fresh process) at full width from phase 6's checkpoint for 10
    iterations under ``--run.multihost=true`` with a coordinator on this
    host, one process and ``--run.data_axis=0``: the group is up, so every
    batch reduction and gradient all-reduce goes through NCCL over one
    rank. Held against the plain run from the same seed, phase 7's
    ``end2end_trainer`` (``flagship``, the same configuration): every
    number it logged at iteration 10 (the losses, ``arch_grad_norm``, the
    validation Dice) equal, else (a plain run of the entry for the spread)
    within 4x the run-to-run spread; it/s of both. Then 7k (c) in the
    same child (``tp_in_group``, ``tp_nccl_stats``)."""
    from semantic_segmentation_torch.core.config import parse_config
    dp = ["--run.multihost=true",
          f"--run.coordinator=127.0.0.1:{_free_port()}",
          "--run.num_processes=1", "--run.process_id=0", "--run.data_axis=0"]
    nccl, s_nccl = _entry_run("nccl", ckpt, *dp)
    check(nccl["backend"] == "nccl" and nccl["world"] == 1,
          f"7j nccl: the group is {nccl['backend']} of {nccl['world']}")
    iters = DP_ENTRY_ITERS
    check(nccl["grad_allreduce"]["calls"] >= 3 * iters,
          f"7j nccl: {nccl['grad_allreduce']['calls']} gradient all-reduces "
          f"in {iters} iterations")
    cfg = parse_config(["--data.synthetic=true",
                        f"--engine.valid_step={DP_ENTRY_VALID}"],
                       preset="end2end_jsrt")
    want = {"warp_affine": iters + flagship_panels(cfg, iters),
            "equalize_uint8": iters, "histogram256": 0, "conv_down4": 0}
    check(nccl["launches"] == want,
          f"7j nccl: launches {nccl['launches']}, not {want}")
    plain = next((c for c in flagship["chunks"] if c["it"] == iters), None)
    check(plain is not None, f"7j nccl: phase 7 logged no chunk at {iters}")
    at = next(r for r in s_nccl if r.get("step") == iters
              and "val_score" in r)
    keys = [k for k in plain if k in at and k not in
            ("it", "iters", "seconds")]
    check("loss_unet" in keys and "val_score" in keys,
          f"7j nccl: compared {keys}")

    def gap(run):
        return max(abs(run[k] - plain[k]) / max(abs(plain[k]), 1e-30)
                   for k in keys)
    rel, spread = gap(at), None
    if rel > 0.0:
        _, s_plain = _entry_run("plain", ckpt)
        spread = gap(next(r for r in s_plain if r.get("step") == iters
                          and "val_score" in r))
        check(rel <= 4.0 * spread, f"7j nccl: {rel:.3e} from the plain "
              f"run, above 4x the spread {spread:.3e}")
    its = [r["iters_per_sec"] for r in s_nccl if "iters_per_sec" in r]
    return {"tp_nccl": tp_nccl_stats(nccl["tp_in_group"]),
            "dp_nccl_entry": {
        "iters": iters, "compared": keys, "equal": rel == 0.0,
        "largest_rel_gap": rel, "spread": spread,
        "steady_it_per_s_nccl": its[-1],
        "steady_it_per_s_plain": flagship["steady_it_per_s"],
        "wall_s_nccl": nccl["wall_s"],
        "grad_allreduce": nccl["grad_allreduce"],
        "peak_bytes_nccl": nccl["peak_bytes"],
        "peak_bytes_plain": flagship["peak_mem_bytes"],
        "launches": nccl["launches"]}}


FAMILY_DIR = DATA_DIR / "families"


def write_family_fixtures() -> dict:
    """Folders of the five in-memory families under build/: B. subtilis
    (16 16-bit TIFs of 300^2 and their boundary masks), omnipose (16
    ``*_img.tif``/``*_masks.tif`` pairs), diabetic (8 RGB JPEGs of 600^2
    and PNG masks), a DeePiCt pickle (16 train and 4 test 256^2 items)
    and NIfTI slices (8 of 256^2); {key: the path make_dataset takes}."""
    import pickle

    import numpy as np
    from PIL import Image

    from semantic_segmentation_torch.data.nifti import write_nifti
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:300, :300]

    def blobs(n=6, size=300):
        m = np.zeros((size, size), bool)
        for _ in range(n):
            cy, cx, r = rng.integers(30, size - 30, 2).tolist() + [
                int(rng.integers(10, 30))]
            m |= (yy[:size, :size] - cy) ** 2 + (xx[:size, :size] - cx) ** 2 \
                < r * r
        return m

    bs = FAMILY_DIR / "b_subtilis"
    (bs / "source").mkdir(parents=True)
    (bs / "target_boundaries").mkdir()
    om = FAMILY_DIR / "omnipose"
    om.mkdir()
    for i in range(16):
        m = blobs()
        img = (1000 + 20000 * m + rng.normal(0, 800, m.shape)).clip(0, 65535)
        Image.fromarray(img.astype(np.uint16)).save(
            bs / "source" / f"cell{i:02d}.tif")
        Image.fromarray((m * 255).astype(np.uint8)).save(
            bs / "target_boundaries" / f"cell{i:02d}.tif")
        Image.fromarray((img / 257).astype(np.uint8)).save(
            om / f"s{i:02d}_img.tif")
        Image.fromarray((m * 200).astype(np.uint8)).save(
            om / f"s{i:02d}_masks.tif")
    di = FAMILY_DIR / "diabetic"
    di.mkdir()
    for i in range(8):
        m = blobs(4, 300)
        rgb = np.stack([120 + 90 * m, 60 + 40 * m, 30 + 20 * m], -1)
        rgb = (rgb + rng.normal(0, 12, rgb.shape)).clip(0, 255)
        Image.fromarray(rgb.astype(np.uint8)).resize((600, 600)).save(
            di / f"d{i}_img.jpg")
        Image.fromarray((m * 255).astype(np.uint8)).resize(
            (600, 600), Image.NEAREST).save(di / f"d{i}.png")
    masks = np.stack([blobs()[22:278, 22:278] for _ in range(20)])
    feats = masks * 0.6 + rng.normal(0.2, 0.1, masks.shape)
    pkl = FAMILY_DIR / "deepict.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"train_features": feats[:16, ..., None].astype(
                         np.float32),
                     "train_labels": masks[:16, ..., None].astype(np.float32),
                     "test_features": feats[16:, ..., None].astype(
                         np.float32),
                     "test_labels": masks[16:, ..., None].astype(np.float32)},
                    f)
    nib = FAMILY_DIR / "nib"
    (nib / "Images").mkdir(parents=True)
    (nib / "Masks").mkdir()
    for i in range(8):
        write_nifti(str(nib / "Images" / f"v{i}.nii.gz"),
                    feats[i, ..., None].astype(np.float32))
        write_nifti(str(nib / "Masks" / f"v{i}.nii.gz"),
                    masks[i, ..., None].astype(np.float32))
    return {"b_subtilis": bs, "omnipose": om, "diabetic": di,
            "deepict": pkl, "deepict_test": pkl, "nib": nib}


def phase_families(torch) -> dict:
    """7j (c): the five in-memory families, fixtures written with PIL,
    pickle and ``write_nifti``: each decoded through ``make_dataset`` (the
    seconds, the items' shapes, binary masks), then ``train_unet`` at full
    width (U-Net base 64, 256^2, batch 2, bf16) for 10 steps, validation
    every 5, from the B. subtilis folder and from the DeePiCt pickle:
    finite losses, a best_val, no kernel launched; steps/s of the second
    interval and the peak."""
    import numpy as np

    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.data.folder import make_dataset
    from semantic_segmentation_torch.train import train_unet
    t0 = time.perf_counter()
    roots = write_family_fixtures()
    out = {"fixtures_s": time.perf_counter() - t0}
    for key, root in roots.items():
        t0 = time.perf_counter()
        ds = make_dataset(key, str(root))
        items = [ds[i] for i in range(len(ds))]
        secs = time.perf_counter() - t0
        check(items and all(np.isfinite(it["image"]).all() for it in items),
              f"7j {key}: no finite items")
        if key != "nib":
            check(all(set(np.unique(it["mask"])) <= {0, 1} for it in items),
                  f"7j {key}: masks not binary")
        out[f"decode_{key}"] = {"items": len(items), "seconds": secs,
                                "image_shape": list(items[0]["image"].shape)}
    for key in ("b_subtilis", "deepict"):
        cfg = parse_config([
            f"--data.dataset={key}", f"--data.dataroot={roots[key]}",
            "--data.image_size=256", "--data.n_train=12", "--data.n_val=2",
            "--data.n_test=2", "--engine.valid_step=5",
            f"--run.save_dir={DP_DIR}", f"--run.name=unet_{key}"])
        check((cfg.model.base_features, cfg.data.batch_size,
               cfg.model.compute_dtype) == (64, 2, "bfloat16"),
              f"7j train_unet {key}: not the full-width configuration")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        # its checkpoints counted, not written: the card's host caps a
        # call's disk writes (CountedSaves)
        with CountedSaves(torch, None) as saves:
            _, res = train_unet.train(cfg, train_iters=10, device=DP_DEV)
        launches = dict(kernels.LAUNCHES)
        check(not any(launches.values()),
              f"7j train_unet {key}: launches {launches}")
        check(len(res["log"]) == 2 and all(math.isfinite(r["loss"])
                                           for r in res["log"])
              and math.isfinite(res["best_val"]),
              f"7j train_unet {key}: {res}")
        steady = res["log"][-1]
        out[f"train_unet_{key}"] = {
            "steps_per_s": steady["steps"] / steady["seconds"],
            "first_interval_s": res["log"][0]["seconds"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "best_val": res["best_val"], "test_dice": res.get("test_dice"),
            "checkpoint_bytes_counted": sum(f["bytes"] for f in saves.files),
            "launches": launches}
    return out


# -- 7k. tensor and spatial parallelism ---------------------------------------

TP_DIR = ROOT / "build" / "chip_smoke_tp"
TP_MESH = (1, 2)            # (data, model): the two ranks one model group
TP_SEG_STEPS, TP_NCCL_ITERS = 3, 2
# (b)'s segmenter: train_unet's U-Net at full width, 256^2, batch 2
TP_SEG_ARGV, TP_SEG_SIZE = ("--data.image_size=256",
                            "--model.base_features=64",
                            "--model.compute_dtype=bfloat16"), 256
# (d)'s trainer: train_unet3d at full width, GenSeg-3D's batch of 1
SP_STEPS, SP_CROP, SP_RANKS = 4, 64, 2
SP_ARGV = ("--data.synthetic=true", "--data.n_train=4", "--data.n_val=1",
           "--data.n_test=1", "--data.batch_size=1",
           "--model.base_features=64")


def _tp_seg(torch, pool) -> dict:
    """7k (b): ``tp_seg_step`` for the U-Net segmenter (base 64, 256^2,
    batch 2, bf16) on the mesh (1, 2), 3 steps, against rank 0 alone
    (``harness.seg_alone_and_on_ranks``): the losses, parameters, BN
    statistics and the last step's gradients each within 4x its one-ulp
    spread."""
    from semantic_segmentation_torch.data.pipeline import stack_dataset
    from semantic_segmentation_torch.data.synthetic import \
        SyntheticSegDataset
    from semantic_segmentation_torch.parallel import harness
    argv = TP_SEG_ARGV + (f"--run.device={DP_DEV}",)
    data = stack_dataset(SyntheticSegDataset(n=2 * TP_SEG_STEPS,
                                             size=TP_SEG_SIZE, seed=11))
    batches = [{k: data[k][2 * i:2 * i + 2] for k in ("image", "mask")}
               for i in range(TP_SEG_STEPS)]
    rec = pool.run(harness.seg_alone_and_on_ranks, argv, DP_DEV, batches,
                   TP_MESH)
    one, two = rec["one"], rec["runs"][0]
    check(all(math.isfinite(v) for v in one["losses"] + two["losses"]),
          f"7k seg: losses {one['losses']} {two['losses']}")
    _within_spread(two["gap"], rec["spread"], "7k seg")
    check(two["tp"]["calls"] > 0, f"7k seg: model group {two['tp']}")
    return {"tp_seg": {
        "steps": TP_SEG_STEPS, "mesh": TP_MESH,
        "steps_per_s_two_ranks": TP_SEG_STEPS / sum(two["seconds"]),
        "steps_per_s_one_process": TP_SEG_STEPS / sum(one["seconds"]),
        "peak_bytes_per_rank": two["peak_bytes_per_rank"],
        "peak_bytes_one_process": one["peak_bytes"],
        "gather_bytes_per_step": two["tp"]["bytes"] / TP_SEG_STEPS,
        "gather_s_per_step": two["tp"]["seconds"] / TP_SEG_STEPS,
        "gap": two["gap"], "spread": rec["spread"],
        "losses": two["losses"], "launches": two["launches"]}}


def _spatial_unet3d(torch, pool) -> dict:
    """7k (d): ``train_unet3d`` at full width (base 64, crop 64^3, batch 1)
    with ``run.spatial_axis=2`` on the pool's two ranks (one depth slab
    each), 4 steps with one validation, against ``spatial_axis=1`` alone
    on rank 0 (``harness.unet3d_alone_and_on_ranks``): the logged loss,
    the final parameters and the first step's averaged gradients (by
    norm: before RMSprop's first step moves the conv biases that BN
    cancels by 10 lr in the sign of their rounding, which parts the runs
    alone by as much as it parts the ranks) each within 4x its one-ulp
    spread."""
    from semantic_segmentation_torch.parallel import harness
    argv = SP_ARGV + (f"--engine.valid_step={SP_STEPS}",
                      f"--run.device={DP_DEV}",
                      f"--run.save_dir={TP_DIR / 'unet3d'}")
    rec = pool.run(harness.unet3d_alone_and_on_ranks, argv, SP_STEPS,
                   SP_CROP, SP_RANKS)
    one, two = rec["one"], rec["runs"][0]
    for r in (one, two):
        check(all(math.isfinite(x["loss"]) for x in r["results"]["log"])
              and math.isfinite(r["results"]["test_dice"]),
              f"7k unet3d: {r['results']}")
    _within_spread({k: two["gap"][k] for k in ("losses", "params",
                                                "first_grads")},
                   rec["spread"], "7k unet3d")
    check(two["halo"]["calls"] > 0, f"7k unet3d: halos {two['halo']}")
    zero = {"warp_affine": 0, "equalize_uint8": 0, "histogram256": 0,
            "conv_down4": 0}
    check(two["launches"] == one["launches"] == zero,
          f"7k unet3d: launches {two['launches']}")
    steps = sum(x["steps"] for x in two["results"]["log"])
    return {"spatial_unet3d": {
        "steps": SP_STEPS, "crop": SP_CROP, "ranks": SP_RANKS,
        "halo_bytes_per_step": two["halo"]["bytes"] / steps,
        "halo_s_per_step": two["halo"]["seconds"] / steps,
        "halo_calls_per_step": two["halo"]["calls"] / steps,
        "steps_per_s_two_ranks_correctness_harness":
            steps / sum(x["seconds"] for x in two["results"]["log"]),
        "steps_per_s_one_process":
            steps / sum(x["seconds"] for x in one["results"]["log"]),
        "peak_bytes_per_rank": two["peak_bytes_per_rank"],
        "peak_bytes_one_process": one["peak_bytes"],
        "gap": two["gap"], "spread": rec["spread"],
        "best_val": [one["results"]["best_val"],
                     two["results"]["best_val"]],
        "launches": two["launches"]}}


def tp_in_group(ckpt: str) -> dict:
    """7k (c), in 7j (b)'s child after the entry, whose one-rank NCCL
    group is still up: ``tp_engine_step`` over it (mesh 1 x 1: every
    covered layer sharded into one shard, every gather and model-group sum
    through NCCL), 2 ``decay_only`` iterations at the full-width flagship,
    against the same iterations alone in that process (the collectives
    off): ``harness.alone_and_on_ranks``'s record."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.parallel import harness
    argv = tuple(DP_ARGV) + (f"--run.pretrained_pix2pix={ckpt}",)
    cfg = parse_config(list(argv), preset="end2end_jsrt")
    rec = harness.alone_and_on_ranks(argv, "end2end_jsrt", DP_DEV,
                                     _dp_steps(cfg, TP_NCCL_ITERS),
                                     meshes=((1, 1),), nudged=False)
    return rec


def tp_nccl_stats(rec: dict) -> dict:
    """7k (c)'s checks on ``tp_in_group``'s record: the run over the group
    equal to the run alone bit for bit, a group of one giving the plain
    values."""
    one, two = rec["one"], rec["runs"][0]
    check(two["tp"]["calls"] > 0 and two["grad_allreduce"]["calls"] > 0,
          f"7k nccl: model group {two['tp']}, gradients "
          f"{two['grad_allreduce']}")
    check(two["metrics"] == one["metrics"] and
          all(v == 0.0 for v in two["gap"].values()),
          f"7k nccl: not bit for bit: {two['metrics']} against "
          f"{one['metrics']}, gaps {two['gap']}")
    return {
        "iters": TP_NCCL_ITERS, "mesh": (1, 1), "equal": True,
        "it_per_s_nccl": TP_NCCL_ITERS / sum(two["seconds"]),
        "it_per_s_plain": TP_NCCL_ITERS / sum(one["seconds"]),
        "gather_calls_per_iter": two["tp"]["calls"] / TP_NCCL_ITERS,
        "peak_bytes_nccl": two["peak_bytes"][0],
        "peak_bytes_plain": one["peak_bytes"][0],
        "launches": two["launches"]}


# -- 7l. the long-horizon experiments' scripts ---------------------------

LONG_DIR = ROOT / "build" / "chip_smoke_long"
VALIDATE_ITERS, VALIDATE_STEP, CHAOS_ITERS, NASWIN_ITERS = 40, 20, 10, 10
VALIDATE_FIELDS = ("best_val", "first_val", "test_dice", "val_trajectory",
                   "last_losses", "steady_it_per_s", "wall_s",
                   "peak_mem_bytes", "launches")


def _full_width(cfg, label: str, size: int = 256):
    m = cfg.model
    check((cfg.data.image_size, cfg.data.batch_size, m.netG, m.ngf, m.ndf,
           m.base_features, m.compute_dtype) ==
          (size, 2, f"unet_{size}", 64, 64, 64, "bfloat16"),
          f"7l {label}: not the full-width configuration")


def phase_long_horizon(torch) -> dict:
    """7l: the validation, the chaos control's card mode and two NAS-win
    arms through their scripts' functions, each path's launches counted."""
    from scripts import drift_torch_chaos_control as chaos
    from scripts import nas_torch_win, validate_torch_learning
    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    out = {}

    # (a) the learning validation
    argv = [f"--engine.valid_step={VALIDATE_STEP}"]
    cfg = parse_config(validate_torch_learning.ARGV + argv,
                       preset="end2end_jsrt")
    _full_width(cfg, "validate")
    t0 = time.perf_counter()
    rec = validate_torch_learning.validate(
        VALIDATE_ITERS, "cuda", argv, str(LONG_DIR / "validate"))
    missing = [k for k in VALIDATE_FIELDS if k not in rec]
    check(not missing, f"7l validate: record lacks {missing}")
    check(rec["losses_finite"] and math.isfinite(rec["best_val"])
          and math.isfinite(rec["test_dice"])
          and len(rec["val_trajectory"]) == VALIDATE_ITERS // VALIDATE_STEP,
          f"7l validate: {rec}")
    panels = flagship_panels(cfg, VALIDATE_ITERS)
    want = {"warp_affine": VALIDATE_ITERS + panels,
            "equalize_uint8": VALIDATE_ITERS, "histogram256": 0,
            "conv_down4": 0}
    check(rec["launches"] == want,
          f"7l validate: launches {rec['launches']}, not {want}")
    out["validate_learning"] = {**rec, "panels": panels,
                                "phase_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    # (b) the chaos control's card mode: base, base again, one ulp
    cfg = chaos.config("cuda")
    _full_width(cfg, "chaos control")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rec = chaos.chaos_control(CHAOS_ITERS, "cuda")
    launches = dict(kernels.LAUNCHES)
    check(rec["losses_finite"] and all(math.isfinite(rec[k]) for k in (
        "final_dice_base", "final_dice_repeat", "final_dice_ulp")),
        f"7l chaos control: {rec}")
    want = {"warp_affine": 3 * CHAOS_ITERS, "equalize_uint8": 3 * CHAOS_ITERS,
            "histogram256": 0, "conv_down4": 0}
    check(launches == want, f"7l chaos control: launches {launches}, not "
          f"{want}")
    print(f"[chaos control] {CHAOS_ITERS} iterations: run-to-run loss gap "
          f"{rec['loss_rel_repeat']}, Dice {rec['run_to_run_dice_gap_pt']} "
          f"pt; 1-ulp loss gap {rec['loss_rel_ulp']}, Dice "
          f"{rec['torch_vs_torch_ulp_dice_gap_pt']} pt")
    out["chaos_control"] = {**rec, "launches": launches,
                            "phase_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    # (c) two NAS-win arms from tables biased toward k8
    for mode, hypergrad_warps in (("frozen", 1), ("searched", 3)):
        spec = {"mode": mode, "kernel": 8, "seed": 0}
        cfg = nas_torch_win.arm_config(spec, "cuda", (),
                                       str(LONG_DIR / "nas_win"), size=64)
        _full_width(cfg, f"nas_win {mode}", size=64)
        t0 = time.perf_counter()
        rec, start, final = nas_torch_win.run_arm(
            spec, NASWIN_ITERS, "cuda", (), str(LONG_DIR / "nas_win"),
            size=64)
        check(math.isfinite(rec["test_dice"]), f"7l nas_win {mode}: {rec}")
        if mode == "frozen":
            check(torch.equal(start, final),
                  f"7l nas_win frozen: the tables moved by "
                  f"{rec['arch_max_moved']}")
            check(abs(rec["bias_col_lead_final"] - nas_torch_win.BIAS)
                  <= 5e-3, f"7l nas_win frozen: lead {rec}")
        else:
            check(rec["arch_max_moved"] > 0
                  and rec["arch_grad_norm_mean"] is not None
                  and rec["arch_grad_norm_mean"] > 0,
                  f"7l nas_win searched: the search did not move: {rec}")
        panels = flagship_panels(cfg, NASWIN_ITERS)
        want = {"warp_affine": hypergrad_warps * NASWIN_ITERS + panels,
                "equalize_uint8": 0, "histogram256": 0, "conv_down4": 0}
        check(rec["launches"] == want,
              f"7l nas_win {mode}: launches {rec['launches']}, not {want}")
        out[f"nas_win_{mode}"] = {**rec, "panels": panels,
                                  "phase_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
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
    for name in ("equalize_uint8", "histogram256"):    # after phase 3's
        records[name]["cases"] = records[name].get("cases", []) + [
            c for c in cases if c["kernel"] == name]

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
    """Phase 8 in this (fresh) process: phase 3's warp and equalize checks
    make the inputs (its cluster and down-conv checks ran in phase 3 of
    this call), then the kernel timing and the benchmark paths; the
    records and each path's launch counts go to TIMING_FILE."""
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    G, arch = _generator(torch, dev)
    records, timers, gen_img = phase_kernels(torch, dev, G, arch,
                                             all_checks=False)
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


def bbdm_child(torch, flagship_it_per_s: float) -> int:
    """Phase 7f in this (fresh) process; its stats go to BBDM_FILE."""
    from semantic_segmentation_torch.train.train_bbdm import \
        prefer_cudnn_heuristic_mode_b
    prefer_cudnn_heuristic_mode_b(BBDM_DEV)     # before the first conv
    out = phase_bbdm(torch, {"steady_it_per_s": flagship_it_per_s})
    out.update(phase_lbbdm(torch))
    BBDM_FILE.write_text(json.dumps(out))
    return 0


def run_bbdm_child(flagship: dict) -> dict:
    """Phase 7f in a child process; {label: stats}."""
    sys.stdout.flush()
    BBDM_FILE.unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         BBDM_ARG, str(flagship["steady_it_per_s"])]
                        ).returncode
    check(rc == 0 and BBDM_FILE.is_file(),
          f"phase 7f: the child process exited {rc}")
    return json.loads(BBDM_FILE.read_text())


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
    if sys.argv[1:2] == [BBDM_ARG]:
        return bbdm_child(torch, float(sys.argv[2]))
    if sys.argv[1:2] == [NCCL_ARG]:
        return nccl_child(torch, sys.argv[2], sys.argv[3:])
    from semantic_segmentation_torch.bench.timing import card_line

    # each phase's wall seconds (the script must end within 1,200 s)
    phase_s, t_lap = {}, [time.perf_counter()]

    def lap(name: str):
        now = time.perf_counter()
        phase_s[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {card} | torch: {name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    lap("1")
    # 2. build
    from semantic_segmentation_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    print(f"[build] {sorted(built) or 'all cached'} in "
          f"{time.perf_counter() - t0:.2f} s")

    lap("build")
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

    lap("3-5")
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

    lap("6-7")
    # 7b. the real-data path: folder, resume, test_seg, train_unet
    folder = phase_real_data(torch, ckpt, trainer_stats["end2end_trainer"])
    print(f"[folder_trainer] {card}: " + json.dumps(folder))
    paths["folder_trainer"] = folder["launches"]

    lap("7b")
    # 7c. the ISIC family
    for label, stats in phase_isic(torch).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        paths[label] = stats["launches"]

    lap("7c")
    # 7d. the segmenter zoo: DeepLabV3 in the flagship (remat, accumulate,
    # test_seg, export_seg), DeepLabV2 and the bilinear U-Net in train_unet
    for label, stats in phase_zoo(torch, ckpt,
                                  trainer_stats["end2end_trainer"]).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        if "launches" in stats:
            paths[label] = stats["launches"]

    lap("7d")
    # 7e. GenSeg-3D: end2end_3d (synthetic and NIfTI), its darts mode,
    # train_pix2pix_3d, train_unet3d, and the small case card against CPU
    for label, stats in phase_3d(torch,
                                 trainer_stats["end2end_trainer"]).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        if "launches" in stats:
            paths[label] = stats["launches"]

    lap("7e")
    # 7f. pixel-space BBDM, in a fresh process: train_bbdm, sample_only,
    # end2end_bbdm at its preset, with the fake branch and the
    # photometric chain, darts, and the small case card against CPU
    # 7i. (in the same process) latent BBDM with its VQGAN and trainer
    for label, stats in run_bbdm_child(
            trainer_stats["end2end_trainer"]).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        if "launches" in stats:
            paths[label] = stats["launches"]

    lap("7f-7i")
    # 7g. the soft-intro VAE family: train_vae (mse and vgg),
    # end2end_sivae (decay_only and darts), inference_vae, FID and LPIPS
    # through evaluate_samples, and the small case card against CPU
    for label, stats in phase_vae(torch,
                                  trainer_stats["end2end_trainer"]).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        if "launches" in stats:
            paths[label] = stats["launches"]
    torch.cuda.empty_cache()

    lap("7g")
    # 7h. the rest of the pix2pix family: test_pix2pix and its report,
    # wgangp, colorization, the JAX package's .msgpack checkpoints
    for label, stats in phase_pix2pix_family(torch, ckpt).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        if "launches" in stats:
            paths[label] = stats["launches"]
    torch.cuda.empty_cache()

    lap("7h")
    # 7j (a), 7k (a), (b), (d): two gloo ranks on the card against one
    # process, data- and tensor-parallel from one set of runs alone, then
    # tp_seg_step and train_unet3d at run.spatial_axis=2 on them
    for label, stats in phase_parallel_ranks(torch, ckpt).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        paths[label] = stats["launches"]
    torch.cuda.empty_cache()

    lap("7j(a)+7k(a,b,d)")
    # 7j (b), (c): the real entry over NCCL at world size 1, and in its
    # process 7k (c), tp_engine_step over that one-rank group; the
    # in-memory families
    for label, stats in [*phase_dp_nccl(torch, ckpt, trainer_stats[
            "end2end_trainer"]).items(), *phase_families(torch).items()]:
        print(f"[{label}] {card}: " + json.dumps(stats))
        if isinstance(stats, dict) and "launches" in stats:
            paths[label] = stats["launches"]
    torch.cuda.empty_cache()

    lap("7j(b,c)+7k(c)")
    # 7l. the long-horizon experiments' scripts: the learning validation,
    # the chaos control's card mode, two NAS-win arms
    for label, stats in phase_long_horizon(torch).items():
        print(f"[{label}] {card}: " + json.dumps(stats))
        paths[label] = stats["launches"]
    torch.cuda.empty_cache()

    lap("7l")
    # 8. timing and the benchmark paths, in a fresh process
    records, bench_paths = run_timing_child()
    paths.update(bench_paths)
    lap("8")
    print("[phase seconds] " + json.dumps(phase_s))
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
