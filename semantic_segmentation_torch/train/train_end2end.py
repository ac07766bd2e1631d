"""End-to-end GenSeg training, the flagship entry point — the port of
``semantic_segmentation_tpu/train/train_end2end.py``.

The four Betty problems become closures over the shared nets:

- netG (:142-154): GAN(D(mask, G(mask)), True) + lambda_L1 * L1.
- netD (:158-172): 0.5 * (fake + real) GAN loss; G runs in train mode under
  ``no_grad`` (its BN stats still update, as the reference's forward does),
  D twice with its stats threaded between the calls.
- unet (:177-226), the hot loop: real loss (BCE + Dice, or + Jaccard for
  the ISIC family) + loss_lambda * fake loss, the fake branch being
  augment(mask) [warp kernel] -> threshold 0.1 -> G -> post-process ->
  segmenter. The post-process is ``uint8_chain`` (min-max -> uint8 ->
  equalize [equalize kernel] -> gamma(0.5) -> /255, the JSRT script's),
  ``photometric`` (min-max -> uint8 -> the ISIC script's ``fake_trans``
  chain, its equalize the same kernel -> /255) or ``minmax``
  (differentiable, with ``detach_fakes`` False the live search's). The
  segmenter runs twice, real branch then fake.
- arch (outer, :229-236): the segmenter's validation loss, read by the
  darts and unroll hypergradients (not evaluated under ``decay_only``).

The segmenter is the U-Net (transposed-conv or ``--model.bilinear``),
DeepLabV3 (``--model.seg_model=deeplab``), whose train-mode forwards draw
the ASPP dropout, DeepLabV2 (``deeplabv2``) or the Swin-UNet (``vit``),
whose train-mode forwards draw stochastic-depth masks. ``--model.remat``
recomputes the train-mode forwards of G, D and the segmenter in the
backward (JAX ``train_end2end.py:57-74``), their draws made before each
checkpointed call; ``--optim.accumulate=k`` steps the segmenter's RMSprop
on the mean of k micro-gradients; ``--run.seg_pretrained`` starts the
segmenter from a reference torch checkpoint.

Validation Dice (Jaccard for ISIC) every ``valid_step``; best-val
snapshot; ReduceLROnPlateau on the unet lr every len(train) steps, with
the four validation panels (``panels/it<it>.png``: G on the augmented
[warp kernel], thresholded first validation mask); the metric stream,
periodic and final checkpoints and resume; final test and OOD scores of
the best segmenter; ``torch.save`` of it.

The public ops keep the JAX package's NHWC layout; the nets are NCHW. The
closures permute at the boundary, a view at C = 1.

Data parallelism (``--run.data_axis=n``, or a ``--run.multihost=true``
launch; ``parallel/``): each rank runs the engine on its rows of every
global batch (``data.batch_size``), with the BN statistics, the
batch-folded Dice and the fake batch's min-max of the global batch, the
draws at its shape, and every gradient averaged over ranks
(``engine/bilevel.py``), so the run equals the single-process one up to
the order of its sums. Validation runs whole on every rank, so every rank
takes the same decisions (best score, plateau, checkpoints); rank 0 alone
writes logs, panels, checkpoints and ``unet_best.pt``, and a resumed run
restores every rank from its files. With ``data_axis`` > 1 in one
process, ``train`` starts the ranks itself and returns rank 0's engine.

Usage: ``python -m semantic_segmentation_torch.train.train_end2end
--preset=end2end_jsrt --data.dataroot=<JSRT dir>
[--data.ood_roots=nlm:<dir>,sz:<dir>:_mask] [--engine.hypergrad=darts]
[--run.device=cpu]`` (``--data.synthetic=true`` for generated data,
``--run.resume=true`` to continue a run); the live search:
``--preset=end2end_nas``; the ISIC family: ``--preset=end2end_isic
--data.dataroot=<ISIC dir> --model.output_nc=3`` and
``--preset=end2end_isic224``.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import time

import torch
import torch.distributed as dist

from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import adam_torch
from semantic_segmentation_torch.core.profiling import StepTimer, trace
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.engine.bilevel import (BilevelEngine,
                                                        InnerProblem)
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.models.seg import SegProblem, seg_loss_fn
from semantic_segmentation_torch.ops import image as iops
from semantic_segmentation_torch.ops.augment import random_augment_batch
from semantic_segmentation_torch.ops.layers import checkpointed
from semantic_segmentation_torch.ops.losses import gan_loss, l1_loss
from semantic_segmentation_torch.ops.metrics import eval_batch_score
from semantic_segmentation_torch.ops.photometric import random_photometric
from semantic_segmentation_torch.parallel import collectives, launch
from semantic_segmentation_torch.parallel.data_parallel import (
    replicate_state, to_cpu)
from semantic_segmentation_torch.parallel.mesh import (maybe_init_distributed,
                                                       mesh_from_config,
                                                       rank_device,
                                                       shard_batch)
from semantic_segmentation_torch.train.common import (apply_seg_pretrained,
                                                      autocast_for,
                                                      fold_generator,
                                                      load_splits, seg_metric,
                                                      seg_model_kwargs)
from semantic_segmentation_torch.train.train_pix2pix import (build_pix2pix,
                                                             load_model)
from semantic_segmentation_torch.train.train_unet import evaluate_split
from semantic_segmentation_torch.utils.visuals import save_image_grid

PROBLEMS = ("netG", "netD", "unet")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def build_problems(cfg: Config, p2p: Pix2Pix, seg: SegProblem, amp,
                   outer_generator: torch.Generator | None = None):
    """The three inner GenSeg problems and the arch problem's outer loss as
    engine closures. Returns (problems, outer_loss). The outer loss draws
    from ``outer_generator`` (the engine's ``hyper_generator``).

    Each loss takes ``(batch, draws, params=None, generator=None)``
    (``InnerProblem``): ``generator`` draws what ``draws`` does not inject:
    'affine' (B, 3, 3), the augment matrices; 'dropout' ({depth or block:
    keep-mask}), G's dropout; 'photometric' (``draw_photometric``'s dict);
    'seg_real', 'seg_fake' (the Swin's {block: (2, B) keep-masks}, or
    DeepLabV3's {'aspp': keep-mask}), the draws of the two segmenter
    forwards. ``params`` ({problem name or
    'arch': tensors}) runs each net it names on those weights instead of
    its module's, every net then on scratch BN buffers
    (train_end2end.py:75-144 of the JAX package reads ``state.params`` the
    same way)."""
    loss_lambda = cfg.optim.loss_lambda
    detach = cfg.engine.detach_fakes
    postprocess = cfg.engine.fake_postprocess
    if postprocess not in ("uint8_chain", "photometric", "minmax"):
        raise ValueError(f"unknown fake_postprocess {postprocess!r}")

    remat = cfg.model.remat

    def run(fn, *args):
        """``fn(*args)``, its activations recomputed in the backward under
        ``model.remat``."""
        return checkpointed(fn, *args) if remat else fn(*args)

    def g_fwd(mask, arch_upconv, masks, generator, keep, g):
        """G in train mode; under remat its dropout is drawn before the
        checkpointed call, in the order the forward would draw it."""
        if remat and masks is None:
            masks = p2p.G.draw_dropout(mask.shape, generator, mask.device)
        return run(p2p.g_apply, mask, arch_upconv, True, masks,
                   None if remat else generator, keep, g)

    def seg_fwd(images, u, keep, masks, generator):
        """The segmenter in train mode, its draws made first under remat."""
        if remat and masks is None:
            masks = seg.draw(images.shape, generator)
        return run(seg.apply, images, True, u, keep, masks,
                   None if remat else generator)

    def nets(params):
        """(G, D, U-Net weights, arch tables, keep_stats) of one call: the
        modules' own with their buffers, or ``params``' on scratch ones."""
        if params is None:
            return None, None, None, p2p.arch, True
        return (params.get("netG"), params.get("netD"), params.get("unet"),
                params.get("arch", p2p.arch), False)

    def loss_netG(batch, draws, params=None, generator=None):
        g, d, _, arch, keep = nets(params)
        mask = _nchw(batch["mask_pix2pix"].float())
        image = _nchw(batch["image_pix2pix"].float())
        with amp():
            fake = g_fwd(mask, arch["upconv"], draws.get("dropout"),
                         generator, keep, g)
            pred_fake = run(p2p.d_apply, torch.cat([mask, fake], 1), True,
                            keep, d)
        return gan_loss(pred_fake, True, p2p.gan_mode) + \
            p2p.lambda_L1 * l1_loss(fake, image)

    def loss_netD(batch, draws, params=None, generator=None):
        g, d, _, arch, keep = nets(params)
        mask = _nchw(batch["mask_pix2pix"].float())
        image = _nchw(batch["image_pix2pix"].float())
        with amp(), torch.no_grad():
            fake = g_fwd(mask, arch["upconv"], draws.get("dropout"),
                         generator, keep, g)
        with amp():
            pred_fake = run(p2p.d_apply, torch.cat([mask, fake], 1), True,
                            keep, d)
            pred_real = run(p2p.d_apply, torch.cat([mask, image], 1), True,
                            keep, d)
        return 0.5 * (gan_loss(pred_fake, False, p2p.gan_mode)
                      + gan_loss(pred_real, True, p2p.gan_mode))

    def loss_unet(batch, draws, params=None, generator=None):
        g, _, u, arch, keep = nets(params)
        images = _nchw(batch["image"].float())
        masks = batch["mask"].float()                       # NHWC
        with amp():
            # real branch (train_end2end_jsrt.py:181-183)
            logits = seg_fwd(images, u, keep, draws.get("seg_real"),
                             generator)
            loss = seg_loss_fn(logits, _nchw(masks), seg.n_classes,
                               seg.loss_type)
            # fake branch (:186-204)
            aug = random_augment_batch(masks, generator, draws.get("affine"))
            fake_mask = iops.threshold_mask(aug, 0.1)
            with torch.no_grad() if detach else contextlib.nullcontext():
                fake_image = g_fwd(_nchw(fake_mask), arch["upconv"],
                                   draws.get("dropout"), generator, keep, g)
            if postprocess == "uint8_chain":
                # integer ops: no gradient flows through them (the JAX
                # package's integer cast gives zero), so say so
                fake_image = _nchw(iops.equalize_gamma_chain(
                    _nhwc(fake_image.detach()), 0.5))
            elif postprocess == "photometric":
                # the ISIC fake_trans (train_end2end_isic.py:178-183,
                # applied :264): global min-max -> uint8 -> photometric
                # chain -> /255; integer ops, so no gradient
                u8 = iops.to_uint8(iops.minmax_normalize(
                    _nhwc(fake_image.detach())))
                u8 = random_photometric(u8, generator,
                                        draws=draws.get("photometric"))
                fake_image = _nchw(u8.float() / 255.0)
            else:
                fake_image = iops.minmax_normalize(fake_image)
            fake_logits = seg_fwd(fake_image, u, keep, draws.get("seg_fake"),
                                  generator)
            fake_loss = seg_loss_fn(fake_logits, _nchw(fake_mask),
                                    seg.n_classes, seg.loss_type)
        return loss + loss_lambda * fake_loss

    def outer_loss(params, val_batch):
        """The arch problem (:229-236): the segmenter's validation loss, a
        train-mode forward (batch statistics) on scratch BN buffers, its
        draws from ``outer_generator``; not recomputed under remat, as in
        the JAX package."""
        u = params.get("unet") if params is not None else None
        images = _nchw(val_batch["image"].float())
        masks = _nchw(val_batch["mask"].float())
        with amp():
            logits = seg.apply(images, True, u, keep_stats=False,
                               generator=outer_generator)
            return seg_loss_fn(logits, masks, seg.n_classes, seg.loss_type)

    problems = [
        InnerProblem("netG", loss_netG, p2p.G, p2p.opt_g, cfg.optim.lr),
        InnerProblem("netD", loss_netD, p2p.D, p2p.opt_d, cfg.optim.lr),
        InnerProblem("unet", loss_unet, seg.net, seg.make_opt(),
                     cfg.optim.unet_lr),
    ]
    return problems, outer_loss


def build_engine(cfg: Config, device, seed: int | None = None):
    """Models (weights drawn from a CPU generator seeded with ``seed``, then
    moved to ``device``), problems and engine. Returns (engine, p2p, seg).
    With ``run.pretrained_pix2pix`` G, D and the arch tables are loaded from
    that directory (``train_pix2pix.save_model``'s files), and with
    ``run.seg_pretrained`` the segmenter from that checkpoint, before any
    optimizer is made."""
    p2p, seg = build_nets(cfg, device, seed)
    return engine_over(cfg, p2p, seg, device, seed), p2p, seg


def build_nets(cfg: Config, device, seed: int | None = None):
    """``build_engine``'s models: (p2p, seg)."""
    device = torch.device(device)
    seed = cfg.run.seed if seed is None else seed
    init_gen = torch.Generator().manual_seed(seed)
    m = cfg.model
    p2p = build_pix2pix(cfg, device, init_gen)
    if cfg.run.pretrained_pix2pix:
        load_model(p2p, cfg.run.pretrained_pix2pix)
    seg = SegProblem(m.seg_model, m.output_nc, m.classes,
                     lr=cfg.optim.unet_lr, loss_type=seg_metric(cfg),
                     device=device, generator=init_gen,
                     accumulate=cfg.optim.accumulate,
                     **seg_model_kwargs(cfg))
    apply_seg_pretrained(cfg, seg.net)
    return p2p, seg


def engine_over(cfg: Config, p2p: Pix2Pix, seg: SegProblem, device,
                seed: int | None = None) -> BilevelEngine:
    """``build_engine``'s problems and engine over the models ``p2p`` and
    ``seg``: engines of several presets can share one set of nets."""
    device = torch.device(device)
    seed = cfg.run.seed if seed is None else seed
    hyper_gen = torch.Generator(device=device).manual_seed(seed + 6)
    problems, outer_loss = build_problems(cfg, p2p, seg,
                                          autocast_for(cfg, device),
                                          hyper_gen)
    # end2end arch optimizer: Adam(arch_lr, (0.5, 0.999), wd=1e-5)
    # (train_end2end_jsrt.py:324)
    arch_opt = adam_torch(list(p2p.arch.values()), cfg.optim.arch_lr, 0.5,
                          weight_decay=cfg.optim.arch_weight_decay)
    e = cfg.engine
    return BilevelEngine(
        problems, p2p.arch, arch_opt, outer_loss,
        unroll_steps=e.unroll_steps, roll_back=e.roll_back,
        hypergrad=e.hypergrad, darts_epsilon=e.darts_epsilon,
        arch_children=e.arch_children,
        generator=torch.Generator(device=device).manual_seed(seed + 5),
        hyper_generator=hyper_gen)


def index_streams(cfg: Config, n_train: int, n_val: int, start: int = 0,
                  names=PROBLEMS):
    """The batch-index streams of the inner problems ``names`` (the i-th
    seeded ``seed * 7 + i``) and the validation stream, fast-forwarded to
    iteration ``start``: each inner stream draws K batches an iteration,
    the validation stream one."""
    streams = {name: epoch_index_batches(n_train, cfg.data.batch_size,
                                         seed=cfg.run.seed * 7 + i)
               for i, name in enumerate(names)}
    val_stream = epoch_index_batches(n_val, cfg.data.batch_size,
                                     seed=cfg.run.seed + 99)
    for s in streams.values():
        for _ in range(start * cfg.engine.unroll_steps):
            next(s)
    for _ in range(start):
        next(val_stream)
    return streams, val_stream


def crosses_epoch(it: int, chunk: int, n_train: int) -> bool:
    """Whether the chunk of ``chunk`` iterations ending at ``it`` crosses a
    multiple of ``n_train``: where the trainer steps the plateau and saves
    the validation panels (every len(train) global steps,
    train_end2end_jsrt.py:206-223, 254-255, applied at chunk
    boundaries)."""
    n = max(n_train, 1)
    return (it // n) != ((it - chunk) // n)


@torch.no_grad()
def panel_fakes(p2p: Pix2Pix, masks, amp, mats=None, generator=None):
    """The panel's fake pair (JAX ``_panel_fakes``): the NHWC ``masks``
    augmented [warp kernel; affine ``mats`` (N, 3, 3), or drawn from
    ``generator``] and thresholded at 0.1, and G's image of that mask in
    eval mode, min-max normalized. Returns (fake_mask, fake_image),
    NHWC."""
    fake_mask = iops.threshold_mask(
        random_augment_batch(masks, generator, mats), 0.1)
    with amp():
        fake = p2p.g_apply(_nchw(fake_mask), p2p.arch["upconv"], False)
    return fake_mask, iops.minmax_normalize(_nhwc(fake.float()))


def save_validation_panels(p2p: Pix2Pix, val_dev: dict, it: int,
                           save_dir: str, log, amp, mats=None,
                           generator=None) -> dict:
    """The reference's four wandb panels (train_end2end_jsrt.py:206-223):
    the first validation image, its mask, ``panel_fakes``' image and mask,
    as ``panels/it<it>.png`` and wandb images. Returns the panels."""
    masks = val_dev["mask"][:1].float()
    fake_mask, fake_image = panel_fakes(p2p, masks, amp, mats, generator)
    panels = {"show_image": val_dev["image"][0].float().cpu().numpy(),
              "show_mask": masks[0].cpu().numpy(),
              "show_fake_image": fake_image[0].cpu().numpy(),
              "show_fake_mask": fake_mask[0].cpu().numpy()}
    save_image_grid(list(panels.values()),
                    os.path.join(save_dir, "panels", f"it{it}.png"), cols=4)
    log.log_images(panels, it)
    return panels


def _log_mode_notes(log, e):
    """The JAX trainer's two notes on the hypergradient mode."""
    if e.hypergrad == "darts" and set(e.arch_children) <= {"netG", "netD"}:
        log.info("NOTE: the darts hypergradient is structurally zero under "
                 "this config (the outer loss touches only the unet; both "
                 "reference wirings share this): the arch moves only by "
                 "Adam weight decay, and hypergrad=decay_only gives the same "
                 "trajectory faster. For a live search use "
                 "--preset=end2end_nas.")
    if e.hypergrad == "decay_only" and not (
            e.detach_fakes or set(e.arch_children) <= {"netG", "netD"}):
        log.info("WARNING: hypergrad=decay_only assumes the structural zero "
                 "(detached fakes, or arch children without validation-loss "
                 "gradients); this config may have a live hypergradient "
                 "that decay_only drops: use darts or unroll.")


def _rank_train(cfg: Config, train_iters, device, init_state=None):
    """``train`` on one rank that ``train`` started: rank 0's engine state
    (on the CPU) and results."""
    engine, results = train(cfg, train_iters, device, init_state)
    return to_cpu(engine.state_dict()), results


def build_state(cfg: Config, device=None) -> dict:
    """The engine state ``train(cfg, ..., device)`` starts from, on the CPU,
    for a script to edit and pass back as ``train``'s ``init_state`` (the
    JAX package's ``init_engine_state``): the ``state_dict()`` of the
    engine ``build_engine`` makes on ``device`` (the draws' generators have
    a device's format), the stage-1 and segmenter checkpoints of ``cfg``
    loaded."""
    engine, _, _ = build_engine(cfg, resolve_device(device or
                                                    cfg.run.device))
    return to_cpu(engine.state_dict())


def load_init_state(engine: BilevelEngine, init_state: dict):
    """Start ``engine`` from ``init_state`` (a ``state_dict()``, as
    ``build_state`` gives it) in place of its fresh state. An entry given as
    None stays the fresh one: the JAX package's NAS warm start gives the
    arch tables' Adam a fresh state (``opt_arch =
    engine.arch_tx.init(arch)``), here ``init_state['arch_optimizer'] =
    None``. A key, problem or shape the engine does not hold raises."""
    fresh = engine.state_dict()
    unknown = set(init_state) - set(fresh)
    if unknown:
        raise ValueError(f"init_state: unknown keys {sorted(unknown)}")
    engine.load_state_dict({k: fresh[k] if init_state.get(k) is None else
                            init_state[k] for k in fresh})


def train(cfg: Config, train_iters: int | None = None, device=None,
          init_state: dict | None = None):
    """Train ``cfg`` on ``device`` (default ``cfg.run.device``, 'cuda').
    Returns (engine, results); ``results['chunks']`` has one record per
    validation interval this call ran: iterations, wall seconds (ending in
    a device sync), losses and val score.

    ``init_state`` (JAX ``train``'s): an engine state to start from in
    place of the fresh one (``build_state``, edited; ``load_init_state``),
    loaded on every rank. A resumed run (``run.resume`` with a checkpoint)
    continues from its checkpoint, which the run saved from that start.

    Run artifacts under ``<save_dir>/<name>``: ``metrics.jsonl`` (losses,
    ``val_score``, ``best_val`` and ``iters_per_sec`` per interval, the arch
    tables under ``darts``/``unroll``, the final results), ``ckpt/<it>``
    (the engine state with the host trajectory: best_val, the iteration,
    the best U-Net, the plateau; every ``run.save_every`` iterations and at
    the end with ``run.final_checkpoint``), and ``unet_best.pt``. With
    ``run.resume`` the run continues from the latest checkpoint exactly as
    if it had not stopped. With ``run.data_axis`` > 1 and no process group
    up, the ranks start here (module docstring)."""
    mesh = mesh_from_config(cfg)
    if mesh is not None and not dist.is_initialized():
        state, results = launch.run_ranks(
            _rank_train, mesh.size,
            (cfg, train_iters, device, to_cpu(init_state)),
            mesh.device_type)
        engine, _, _ = build_engine(cfg, resolve_device(device or
                                                        cfg.run.device))
        engine.load_state_dict(state)
        return engine, results
    dev = rank_device(resolve_device(device or cfg.run.device))
    engine, p2p, seg = build_engine(cfg, dev)
    if init_state is not None:
        load_init_state(engine, init_state)
    replicate_state(mesh, engine)
    amp = autocast_for(cfg, dev)
    val_metric = seg_metric(cfg)
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
        # ReduceLROnPlateau(max, patience=5) on the unet's RMSprop
        # (train_end2end_jsrt.py:73)
        plateau = torch.optim.lr_scheduler.ReduceLROnPlateau(
            engine.problems[PROBLEMS.index("unet")].optimizer, mode="max",
            factor=cfg.optim.plateau_factor,
            patience=cfg.optim.plateau_patience)

        e = cfg.engine
        _log_mode_notes(log, e)
        if dist.is_initialized():
            log.info("data-parallel over a %s group of %d ranks",
                     dist.get_backend(), dist.get_world_size())

        K = e.unroll_steps
        n_train = len(splits["train"]["image"])
        n_val = len(splits["val"]["image"])
        train_dev = to_device_split(splits["train"], dev)
        val_dev = to_device_split(splits["val"], dev)
        val_images = _nchw(val_dev["image"].float())
        val_masks = _nchw(val_dev["mask"])

        def snapshot_unet():
            return {k: v.detach().clone() for k, v in
                    seg.net.state_dict().items()}

        iters = train_iters or cfg.engine.train_iters
        best_val, it = 0.0, 0
        best_unet = snapshot_unet()

        def save_ckpt():
            # the engine state and the host trajectory beside it: a run
            # resumed from here continues as the uninterrupted one
            ckpt.save(it, {"engine": engine.state_dict(),
                           "host": {"best_val": best_val, "it": it,
                                    "best_unet": best_unet,
                                    "plateau": plateau.state_dict()}},
                      {"val_score": best_val}, force=True)

        if cfg.run.resume:
            restored, _ = ckpt.restore({"engine": None, "host": None})
            if restored is not None:
                engine.load_state_dict(restored["engine"])
                h = restored["host"]
                best_val, it = float(h["best_val"]), int(h["it"])
                best_unet = {k: v.to(dev) for k, v in h["best_unet"].items()}
                plateau.load_state_dict(h["plateau"])
                log.info("resumed from checkpoint at step %d%s", it,
                         "" if init_state is None else
                         " (in place of init_state)")
        streams, val_stream = index_streams(cfg, n_train, n_val, start=it)

        chunks = []
        timer = StepTimer(skip=1)
        timer.tick()
        with trace(cfg.run.profile_dir):
            while it < iters:
                t0 = time.perf_counter()
                S = min(cfg.engine.valid_step, iters - it)
                for _ in range(S):
                    # the global batches, of which this rank takes its rows
                    batch_stack = [{n: shard_batch(mesh, take_batch(
                                        train_dev, next(s)))
                                    for n, s in streams.items()}
                                   for _ in range(K)]
                    metrics = engine.engine_step(
                        batch_stack, shard_batch(mesh, take_batch(
                            val_dev, next(val_stream))))
                it += S
                with torch.no_grad(), amp(), collectives.replicated():
                    val = float(eval_batch_score(seg.eval_logits(val_images),
                                                 val_masks, seg.n_classes,
                                                 val_metric))
                m_host = {k: float(v) for k, v in metrics.items()}
                chunks.append({"it": it, "iters": S,
                               "seconds": time.perf_counter() - t0,
                               "val_score": val, **m_host})
                if val > best_val:
                    best_val = val
                    best_unet = snapshot_unet()
                log.info("it %d: %s val %.4f best %.4f", it, m_host, val,
                         best_val)
                log.log({**m_host, "val_score": val, "best_val": best_val},
                        it)
                if e.hypergrad in ("darts", "unroll"):
                    # the search's trajectory: the (small) arch tables in full
                    log.log({f"arch_{k}": v.detach().cpu().tolist()
                             for k, v in engine.arch.items()}, it)
                # plateau stepping and the panels every len(train_set)
                # global steps, applied per chunk boundary; the panel's
                # affine draws from their own fold of the seed
                if crosses_epoch(it, S, n_train):
                    plateau.step(best_val)
                    if collectives.is_main():
                        with collectives.replicated():
                            save_validation_panels(
                                p2p, val_dev, it, save_dir, log, amp,
                                generator=fold_generator(
                                    cfg.run.seed, 2 ** 30 + it, dev))
                # after the plateau step, so the checkpoint holds this
                # iteration's whole state
                if cfg.run.save_every and it % cfg.run.save_every == 0:
                    save_ckpt()
                timer.tick()
                log.log({"iters_per_sec": timer.steps_per_sec * S}, it)

        if cfg.run.final_checkpoint:
            save_ckpt()
        results = {"best_val": best_val}
        best_net = copy.deepcopy(seg.net)
        best_net.load_state_dict(best_unet)
        if splits["test"] is not None:
            results[f"test_{val_metric}"] = evaluate_split(
                best_net, splits["test"], cfg.data.batch_size, seg.n_classes,
                val_metric, amp)
            results.setdefault("test_dice", results[f"test_{val_metric}"])
        for name, data in splits["ood"]:
            results[f"ood_{name}"] = evaluate_split(
                best_net, data, cfg.data.batch_size, seg.n_classes,
                val_metric, amp)
        if collectives.is_main():
            torch.save(best_unet, os.path.join(save_dir, "unet_best.pt"))
        log.log(results, it)
        log.info("final: %s", results)
        ckpt.wait()
        return engine, {**results, "chunks": chunks}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv, preset="end2end_jsrt")
    maybe_init_distributed(cfg)
    train(cfg)


if __name__ == "__main__":
    main()
