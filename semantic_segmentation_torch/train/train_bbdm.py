"""BBDM pre-training — the port of
``semantic_segmentation_tpu/train/train_bbdm.py`` (``BBDM/runners/
BaseRunner.py:24-594`` and ``BBDMRunner.py:17-250``), in pixel space or,
with a frozen VQGAN (``BBDMModel(vqgan=...)``, passed in through
``train(cfg, model=...)`` as in the JAX package: no CLI option), in its
latent space:

- the Brownian bridge (``models/diffusion/bbdm.py``) around the ADM
  denoiser with its NAS cells (``models/diffusion/adm_unet.py``), the arch
  table fixed at its init (the bilevel program ``train_end2end_bbdm``
  searches it);
- Adam(lr 1e-4, betas (0.9, 0.999), eps 1e-8) with ReduceLROnPlateau(min,
  factor 0.5, patience 3000, cooldown 3000, min_lr 5e-7) on the
  validation loss (Template-BBDM.yaml:56-66); ``optim.accumulate`` steps
  Adam on the mean of k micro-gradients (``core/optim.Accumulate``,
  ``optax.MultiSteps`` there);
- the EMA of the weights (decay 0.995 every 8 steps, a plain copy before
  step 30,000);
- checkpoints: ``ckpt`` (the latest, every ``run.save_every`` iterations
  and at the end) and ``ckpt_top`` (the ``run.topk_checkpoints`` best by
  validation loss), each the whole trainer state with the host trajectory
  (plateau, best loss, epoch and position in it), so a run resumed
  (``run.resume``) mid-epoch continues as the uninterrupted one; the
  weights, EMA and arch as ``bbdm_best.pt`` and ``bbdm_latest.pt``;
- ``run.sample_only``: the reference's run without ``-t``: the latest
  checkpoint samples every test (or val) condition with the EMA weights,
  writes condition/sample/real grids and scores the samples' diversity.

Draws come from ``train.common.fold_generator``: the train step of
iteration ``it`` from fold ``2 * it`` of ``run.seed + 3``, the validation
from fold ``2 * it + 1`` (the JAX package folds its key the same way). The
batches are the JAX package's: ``batch_iterator`` over
``default_rng((seed, epoch))``. Items are NHWC in [0, 1] (``image_pix2pix``
the target x0, ``mask_pix2pix`` the condition y); the net is NCHW.

Data parallelism (``--run.data_axis=n``, or a ``--run.multihost=true``
launch; ``parallel/``), the reference's ``mp.spawn`` with NCCL DDP
(``BBDM/main.py:70-127``): each rank steps on its rows of the global
batch, with the bridge's ``t`` and noise drawn at the global batch's shape
and the gradients averaged over ranks; the validation runs whole on every
rank; rank 0 alone writes. With ``data_axis`` > 1 in one process,
``train`` starts the ranks itself (a ``model`` passed in goes to each
rank as a copy) and returns rank 0's model.

Usage: ``python -m semantic_segmentation_torch.train.train_bbdm
--preset=bbdm --data.dataset=bbdm_colorization_rgb --data.dataroot=<dir>
[--model.output_nc=3] [--run.sample_only=true] [--run.device=cpu]``
(``--data.synthetic=true`` for generated mask -> image pairs).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import (Accumulate, adam_torch,
                                                    set_learning_rate)
from semantic_segmentation_torch.data.pipeline import (batch_iterator,
                                                       eval_batches)
from semantic_segmentation_torch.models.diffusion.adm_unet import (
    ADMUNet, init_weights_)
from semantic_segmentation_torch.models.diffusion.bbdm import (
    BridgeSchedule, BrownianBridge)
from semantic_segmentation_torch.models.diffusion.ema import (EMAConfig,
                                                              ema_init,
                                                              ema_step)
from semantic_segmentation_torch.models.diffusion.latent_bbdm import \
    LatentBrownianBridge
from semantic_segmentation_torch.models.diffusion.vqgan import VQModel
from semantic_segmentation_torch.ops import gen_metrics
from semantic_segmentation_torch.ops.nas import NUM_OPS
from semantic_segmentation_torch.parallel import collectives, launch
from semantic_segmentation_torch.parallel.data_parallel import (
    replicate_state, to_cpu)
from semantic_segmentation_torch.parallel.mesh import (maybe_init_distributed,
                                                       mesh_from_config,
                                                       rank_device,
                                                       shard_batch)
from semantic_segmentation_torch.train.common import (fold_generator,
                                                      load_splits)
from semantic_segmentation_torch.utils.visuals import save_image_grid


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


MODE_B = "TORCH_CUDNN_USE_HEURISTIC_MODE_B"


def prefer_cudnn_heuristic_mode_b(device) -> None:
    """On a CUDA ``device``, ask cuDNN for its heuristic mode B unless the
    environment already says (``TORCH_CUDNN_USE_HEURISTIC_MODE_B``, 1 or
    0). Its instant heuristics give the denoiser's bf16 convs their
    non-tensor-core kernels (``implicit_convolve_sgemm``): a batch-2
    forward 583 ms on an H100 against 119 ms under mode B, and
    ``cudnn.benchmark`` autotunes for minutes at these shapes (PERF.md).
    PyTorch reads the variable once, when the process plans its first
    conv, and it then holds for every conv of the process (the
    ``end2end_bbdm`` segmenter's batch-2 step runs 1.5x slower under it,
    a far smaller cost); so the entry points call this before any CUDA
    work, and it warns where CUDA is already initialized (a conv may have
    fixed the mode)."""
    if torch.device(device).type != "cuda" or MODE_B in os.environ:
        return
    if torch.cuda.is_initialized():
        warnings.warn(
            f"{MODE_B} set after CUDA was initialized: if this process "
            "already ran a conv, cuDNN keeps its instant heuristics and the "
            "denoiser's convs run about 5x slower; set it in the "
            "environment before the process starts", stacklevel=2)
    os.environ[MODE_B] = "1"


def to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) NHWC batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device) for k, v in batch.items()}


class BBDMModel:
    """The bridge, the denoiser, its arch table, Adam and the EMA on one
    device. Weights and arch are drawn on ``device`` from ``generator``
    (a generator on that device). ``ema=False`` keeps no EMA (the bilevel
    program has none).

    With ``vqgan`` (a ``models/diffusion/vqgan.VQModel`` on ``device``,
    frozen here) the bridge runs in its latent space, latent BBDM
    (Template-LBBDM-*.yaml, ``models/diffusion/latent_bbdm.py``): the
    denoiser takes the latent and its condition's latent (``2 *
    vqgan.embed_dim`` channels in, ``channels`` out, which must be the
    latent's), the loss encodes target and condition first, and samples
    are decoded back to images. ``latent_stats`` ({'mean', 'std'}, from
    ``latent.estimate_latent_stats``) normalizes the latents where
    ``normalize_latent``; it is None, and nothing is normalized, until the
    caller sets it, as in the JAX package."""

    def __init__(self, channels: int = 1, model_channels: int = 128,
                 channel_mult=(1, 4, 8), num_res_blocks: int = 2,
                 schedule: BridgeSchedule | None = None,
                 objective: str = "grad", loss_type: str = "l1",
                 lr: float = 1e-4, accumulate: int = 1,
                 ema_cfg: EMAConfig | None = None,
                 compute_dtype: str = "bfloat16", device="cpu",
                 generator: torch.Generator | None = None, ema: bool = True,
                 vqgan: VQModel | None = None,
                 normalize_latent: bool = False):
        self.device = torch.device(device)
        in_channels = 2 * (channels if vqgan is None else vqgan.embed_dim)
        with self.device:
            self.unet = ADMUNet(in_channels, channels, model_channels,
                                num_res_blocks,
                                channel_mult=tuple(channel_mult))
        init_weights_(self.unet, generator)
        if self.device.type == "cuda":
            # channels-last: with cuDNN's heuristic mode B (which the entry
            # points ask for, ``prefer_cudnn_heuristic_mode_b``) the bf16
            # convs run tensor-op kernels
            self.unet.to(memory_format=torch.channels_last)
        self.n_cells = self.unet.n_cells
        self.arch = 1e-3 * torch.randn(self.n_cells, NUM_OPS,
                                       generator=generator,
                                       device=self.device)
        self.sched = schedule or BridgeSchedule()
        self.ema_cfg = ema_cfg or EMAConfig()
        self.bridge = BrownianBridge(self.sched, objective, loss_type)
        self.latent, self.latent_stats = None, None
        if vqgan is not None:
            vqgan.requires_grad_(False).eval()
            self.latent = LatentBrownianBridge(
                vqgan, self.sched, objective, loss_type,
                condition_key="first_stage",
                normalize_latent=normalize_latent)
        if compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self.kernel_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                             else None)
        self.lr = lr
        opt = adam_torch(self.unet.parameters(), lr, beta1=0.9)
        self.opt = Accumulate(opt, accumulate) if accumulate > 1 else opt
        self.ema = (ema_init(dict(self.unet.named_parameters())) if ema
                    else None)
        self.step = 0

    def amp(self):
        """bf16 autocast under ``compute_dtype`` bfloat16 (the JAX
        denoiser's ``dtype``), else nothing."""
        if self.kernel_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.kernel_dtype)

    def set_lr(self, lr: float):
        set_learning_rate(self.opt, lr)

    def denoiser(self, params: dict | None = None, arch=None, kernels=None):
        """The bridge's ``denoise(x_t, t, context, train)`` on ``params``
        ({name: tensor}; the module's own weights when None), under the arch
        table ``arch`` (``self.arch`` when None) or ``kernels``
        (``ADMUNet.assemble``'s)."""
        arch = self.arch if arch is None else arch

        def denoise(x_t, t, context, train):
            del train                      # no dropout: train = eval
            with self.amp():
                if params is None:
                    return self.unet(x_t, t, arch, context, kernels)
                return functional_call(self.unet, params,
                                       (x_t, t, arch, context, kernels))
        return denoise

    def loss_fn(self, batch, draws=None, generator=None, params=None,
                arch=None, train: bool = True):
        """The bridge loss of an NHWC batch: x0 = ``image_pix2pix``, y =
        ``mask_pix2pix``, both mapped to [-1, 1]. Returns (loss, aux)."""
        x0 = _nchw(batch["image_pix2pix"].float()) * 2.0 - 1.0
        y = _nchw(batch["mask_pix2pix"].float()) * 2.0 - 1.0
        if self.latent is not None:
            return self.latent.p_losses(self.denoiser(params, arch), x0, y,
                                        draws, generator, self.latent_stats,
                                        train=train)
        return self.bridge.p_losses(self.denoiser(params, arch), x0, y,
                                    draws, generator, train=train)

    def train_step(self, batch, draws=None, generator=None) -> dict:
        """One Adam (or accumulation) step, then the EMA step at the step
        count before it. Under data parallelism ``batch`` is this rank's
        rows, the gradients are averaged over ranks and the loss is the
        global batch's."""
        loss, _ = self.loss_fn(batch, draws, generator)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        collectives.all_reduce_grads(self.unet.parameters())
        self.opt.step()
        if self.ema is not None:
            ema_step(self.ema_cfg, self.step, self.ema,
                     dict(self.unet.named_parameters()))
        self.step += 1
        return {"loss": collectives.mean_over_ranks(loss.detach())}

    @torch.no_grad()
    def val_loss(self, batch, draws=None, generator=None):
        return self.loss_fn(batch, draws, generator, train=False)[0]

    @torch.no_grad()
    def sample_loop(self, y, params: dict | None = None, arch=None,
                    noises=None, generator=None):
        """The whole sampler from the NCHW condition ``y`` in [-1, 1], with
        every cell's mixed kernel assembled once for the run; through the
        frozen VQGAN when latent (``noises`` then of the latent's shape)."""
        arch = self.arch if arch is None else arch
        kernels = self.unet.assemble(arch, params, self.kernel_dtype)
        denoise = self.denoiser(params, arch, kernels)
        if self.latent is not None:
            return self.latent.sample(denoise, y, noises, generator,
                                      self.latent_stats)
        return self.bridge.p_sample_loop(denoise, y, noises, generator)

    def sample(self, cond, use_ema: bool = True, noises=None,
               generator=None):
        """mask -> image: the NHWC condition ``cond`` in [0, 1] to an NHWC
        sample in [0, 1], with the EMA weights unless ``use_ema`` is
        False."""
        y = _nchw(cond.float()) * 2.0 - 1.0
        params = self.ema if use_ema and self.ema is not None else None
        img = self.sample_loop(y, params, noises=noises, generator=generator)
        return _nhwc((img + 1.0) * 0.5)

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"unet": self.unet.state_dict(), "arch": self.arch,
                "opt": self.opt.state_dict(), "ema": self.ema,
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.unet.load_state_dict(state["unet"])
        self.arch.copy_(state["arch"])
        self.opt.load_state_dict(state["opt"])
        if self.ema is not None:
            for k, v in self.ema.items():
                v.copy_(state["ema"][k])
        self.step = int(state["step"])

    def weights(self) -> dict:
        """The ``bbdm_best``/``bbdm_latest`` file: weights, EMA, arch."""
        return {"params": self.unet.state_dict(), "ema": self.ema,
                "arch": self.arch}


def build_model(cfg: Config, device, accumulate: int | None = None,
                ema: bool = True) -> BBDMModel:
    """The full-width model of ``cfg`` (``model.output_nc`` channels,
    ``model.compute_dtype``), drawn on ``device`` from ``run.seed``."""
    device = torch.device(device)
    return BBDMModel(
        channels=cfg.model.output_nc,
        accumulate=cfg.optim.accumulate if accumulate is None else accumulate,
        compute_dtype=cfg.model.compute_dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(cfg.run.seed),
        ema=ema)


def make_plateau(model: BBDMModel):
    """Template-BBDM.yaml's lr_scheduler block."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        model.opt, mode="min", factor=0.5, patience=3000, threshold=1e-4,
        min_lr=5e-7, cooldown=3000)


def _rank_train(cfg: Config, train_iters, model_file, device):
    """``train`` on one rank that ``train`` started, from its own copy of
    the model in ``model_file`` (None: built here); rank 0's model state
    (on the CPU) and results."""
    model = None
    if model_file is not None:
        dev = rank_device(resolve_device(device or cfg.run.device))
        model = torch.load(model_file, map_location=dev, weights_only=False)
        model.device = dev
    model, results = train(cfg, train_iters, model, device)
    return to_cpu(model.state_dict()), results


def _spawn(cfg: Config, train_iters, model, device, mesh):
    """The ranks of ``mesh`` started from this process; rank 0's model (in
    ``model``, or a new one) and results."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="bbdm-ranks-") as tmp:
        model_file = None
        if model is not None:
            model_file = os.path.join(tmp, "model.pt")
            torch.save(model, model_file)
        state, results = launch.run_ranks(
            _rank_train, mesh.size, (cfg, train_iters, model_file, device),
            mesh.device_type)
    model = model or build_model(cfg, resolve_device(device or
                                                     cfg.run.device))
    model.load_state_dict(state)
    return model, results


def train(cfg: Config, train_iters: int | None = None,
          model: BBDMModel | None = None, device=None):
    """Train ``cfg`` on ``device`` (default ``cfg.run.device``, 'cuda').
    Returns (model, results): ``best_val`` and ``log``, one record per
    validation: the iteration, the steps since the last one and their wall
    seconds (ending in a device sync), the train and validation loss, and
    the seconds of the validation and the checkpoint writes. With
    ``run.data_axis`` > 1 and no process group up, the ranks start here
    (module docstring)."""
    mesh = mesh_from_config(cfg)
    if mesh is not None and not dist.is_initialized():
        return _spawn(cfg, train_iters, model, device, mesh)
    dev = rank_device(resolve_device(device or cfg.run.device))
    model = model or build_model(cfg, dev)
    replicate_state(mesh, model.unet)
    replicate_state(mesh, model.opt)
    replicate_state(mesh, {"arch": model.arch, "ema": model.ema})
    splits = load_splits(cfg)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    with MetricsLogger(save_dir, cfg.run.wandb, cfg.run.wandb_project,
                       cfg.run.name, cfg.to_dict()) as log:
        plateau = make_plateau(model)
        ckpt_latest = CheckpointManager(os.path.join(save_dir, "ckpt"),
                                        max_to_keep=1, best_key=None)
        ckpt_top = CheckpointManager(os.path.join(save_dir, "ckpt_top"),
                                     max_to_keep=cfg.run.topk_checkpoints,
                                     best_key="val_loss", best_mode="min")
        root = cfg.run.seed + 3
        iters = train_iters or cfg.engine.train_iters
        it, epoch, best_val, epoch_pos = 0, 0, float("inf"), 0

        def host_state():
            return {"best_val": best_val, "epoch": epoch, "it": it,
                    "epoch_pos": epoch_pos, "plateau": plateau.state_dict()}

        def save(manager, metrics=None):
            manager.save(it, {"state": model.state_dict(),
                              "host": host_state()}, metrics, force=True)

        if cfg.run.resume:
            restored, _ = ckpt_latest.restore({"state": None, "host": None})
            if restored is not None:
                model.load_state_dict(restored["state"])
                h = restored["host"]
                best_val = float(h["best_val"])
                epoch, it = int(h["epoch"]), int(h["it"])
                epoch_pos = int(h["epoch_pos"])
                plateau.load_state_dict(h["plateau"])
                log.info("resumed BBDM trainer at it=%d (epoch %d)", it,
                         epoch)

        records = []
        t0, last_it = time.perf_counter(), it
        skip = epoch_pos
        while it < iters:
            rng_np = np.random.default_rng((cfg.run.seed, epoch))
            for batch in batch_iterator(splits["train"], cfg.data.batch_size,
                                        rng_np):
                if skip > 0:      # fast-forward the interrupted epoch
                    skip -= 1
                    continue
                metrics = model.train_step(
                    to_device(shard_batch(mesh, batch), dev),
                    generator=fold_generator(root, 2 * it, dev))
                it += 1
                epoch_pos += 1
                if it % cfg.engine.valid_step == 0:
                    loss = float(metrics["loss"])    # waits for the steps
                    train_s = time.perf_counter() - t0
                    # one fold for every batch, as the JAX package's key
                    # the whole split on every rank
                    with collectives.replicated():
                        vls = [float(model.val_loss(
                            to_device(b, dev),
                            generator=fold_generator(root, 2 * it + 1, dev)))
                            for b in eval_batches(splits["val"],
                                                  cfg.data.batch_size)]
                    val = float(np.mean(vls)) if vls else float("inf")
                    if val < best_val:
                        best_val = val
                        if collectives.is_main():
                            torch.save(model.weights(),
                                       os.path.join(save_dir, "bbdm_best.pt"))
                    plateau.step(val)
                    save(ckpt_top, {"val_loss": val})
                    records.append({"it": it, "steps": it - last_it,
                                    "seconds": train_s, "loss": loss,
                                    "val_loss": val,
                                    "val_and_save_seconds":
                                        time.perf_counter() - t0 - train_s})
                    log.info("it %d: loss %.5f val_loss %.5f best %.5f", it,
                             loss, val, best_val)
                    log.log({"loss": loss, "val_loss": val,
                             "best_val_loss": best_val}, it)
                    t0, last_it = time.perf_counter(), it
                if cfg.run.save_every and it % cfg.run.save_every == 0:
                    save(ckpt_latest)
                if it >= iters:
                    break
            if it < iters:  # the epoch ran out (not an iters-break in it)
                epoch += 1
                epoch_pos = 0
        save(ckpt_latest)
        if collectives.is_main():
            torch.save(model.weights(),
                       os.path.join(save_dir, "bbdm_latest.pt"))
        return model, {"best_val": best_val, "log": records}


def sample_to_eval(model: BBDMModel, data, batch_size: int, out_dir: str,
                   seed: int = 0, n_per_cond: int = 1):
    """``BBDMRunner.sample_to_eval``: ``n_per_cond`` samples per condition
    of the stacked NHWC split ``data`` (sample ``si`` of batch ``bi`` from
    fold ``bi * 131 + si`` of ``seed``), a condition/sample/real grid per
    batch as ``cond<bi>.png``. Returns (samples (N, n_per_cond, H, W, C),
    reals (N, H, W, C)), numpy in [0, 1]."""
    all_samples, all_reals = [], []
    for bi, b in enumerate(eval_batches(data, batch_size)):
        cond = torch.as_tensor(b["mask_pix2pix"], dtype=torch.float32,
                               device=model.device)
        per_cond = [model.sample(cond, generator=fold_generator(
                        seed, bi * 131 + si, model.device)).cpu().numpy()
                    for si in range(n_per_cond)]
        samples = np.stack(per_cond, axis=1)
        all_samples.append(samples)
        all_reals.append(np.asarray(b["image_pix2pix"], np.float32))
        save_image_grid(
            [b["mask_pix2pix"][0].astype(np.float32), samples[0, 0],
             b["image_pix2pix"][0]],
            os.path.join(out_dir, f"cond{bi}.png"), cols=3)
    return np.concatenate(all_samples), np.concatenate(all_reals)


def evaluate_samples(samples: np.ndarray, reals: np.ndarray,
                     inception=None, alex=None) -> dict:
    """The BBDM/evaluation scores (FID.py, LPIPS.py, diversity.py) of
    ``sample_to_eval``'s output: ``samples`` (N, n_per_cond, H, W, C),
    ``reals`` (N, H, W, C), both in [0, 1]. The diversity always; FID
    between the first samples and the reals with ``inception`` (the port's
    ``InceptionV3Pool3`` on its device), their mean LPIPS with ``alex``
    ((``AlexNetFeatures``, its five lin weights)); the real weights map
    with ``utils/torch_port.port_inception_v3`` / ``port_alexnet_lpips``."""
    out = {"diversity": gen_metrics.sample_diversity(samples)}
    flat = samples[:, 0]
    if inception is not None:
        out["fid"] = gen_metrics.fid(inception, flat, reals)
    if alex is not None:
        out["lpips"] = float(np.mean(gen_metrics.lpips(alex[0], alex[1],
                                                       flat, reals)))
    return out


def sample_eval(cfg: Config, model: BBDMModel | None = None,
                n_per_cond: int = 1, device=None):
    """The ``BBDM/main.py`` run without ``-t`` (main.py:106-126): the
    latest checkpoint of ``run.save_dir/run.name`` (a fresh model if there
    is none) samples the test split (the val split without one), writes
    the grids under ``sample_to_eval/`` and logs the scores. Returns
    (samples, scores)."""
    dev = resolve_device(device or cfg.run.device)
    model = model or build_model(cfg, dev)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"), max_to_keep=1,
                             best_key=None)
    restored, rstep = ckpt.restore({"state": None, "host": None})
    if restored is not None:
        model.load_state_dict(restored["state"])
    splits = load_splits(cfg)
    data = splits["test"] if splits.get("test") is not None else splits["val"]
    samples, reals = sample_to_eval(model, data, cfg.data.batch_size,
                                    os.path.join(save_dir, "sample_to_eval"),
                                    n_per_cond=n_per_cond)
    results = evaluate_samples(samples, reals)
    with MetricsLogger(save_dir) as log:
        log.log({f"sample_eval/{k}": float(v) for k, v in results.items()},
                int(rstep or 0))
        log.info("sample_to_eval: %s", results)
    return samples, results


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    cfg = parse_config(argv)
    cfg.run.name = cfg.run.name or "bbdm"
    prefer_cudnn_heuristic_mode_b(cfg.run.device)
    maybe_init_distributed(cfg)
    if cfg.run.sample_only:
        # the sampler has no batch reduction: rank 0 samples and writes
        if not collectives.is_main():
            return None
        with collectives.replicated():
            return sample_eval(cfg)
    return train(cfg)


if __name__ == "__main__":
    main()
