"""Configuration: one typed dataclass tree + CLI overrides.

The port's own copy of ``semantic_segmentation_tpu/core/config.py``, with
the same sections, field names and defaults, so one command line means the
same run on both packages. It holds only the fields and presets the port
uses, plus ``run.device``: an option of the JAX package that the port does
not implement yet (the data mesh) is refused, not ignored.

CLI: ``--section.field=value`` overrides any leaf (parsed with the field's
type; a tuple field splits on commas); ``--preset=name`` applies a named
preset first.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any


@dataclass
class DataConfig:
    """Dataset locations and regime (train_end2end_jsrt.py:78-97)."""
    dataroot: str = "../data/JSRT"
    dataset: str = "jsrt"            # jsrt | isic | se | liver3 | ...
    ood_roots: tuple = ()            # out-of-domain eval sets,
                                     # [name:]path[:mask_suffix] each
    mask_suffix: str = ""            # SZ uses '_mask', PH2 '_lesion'
    image_size: int = 256
    n_train: int = 7
    n_val: int = 2
    n_test: int = 72
    batch_size: int = 2
    synthetic: bool = False          # synthetic data (tests/bench)


@dataclass
class ModelConfig:
    """Generator/discriminator/segnet choices (options/base_options.py:28-38,
    train_end2end_jsrt.py:61-64)."""
    seg_model: str = "unet"          # unet | deeplab | deeplabv2 |
                                     # vit (swin, swin_unet)
    netG: str = "unet_256"           # unet_{256,...,32} | resnet_{9,6}blocks
    netD: str = "basic"              # basic | n_layers | pixel
    ngf: int = 64
    ndf: int = 64
    n_layers_D: int = 3
    norm: str = "batch"              # batch | instance | none
    no_dropout: bool = False
    # init_net's --init_type/--init_gain (models_pix2pix/networks.py:73-122):
    # normal | xavier | kaiming | orthogonal, applied to G/D at construction
    init_type: str = "normal"
    init_gain: float = 0.02
    input_nc: int = 1
    output_nc: int = 1
    classes: int = 1
    bilinear: bool = False
    base_features: int = 64          # U-Net width (64 = reference)
    # Swin-UNet stochastic depth (swin_tiny_patch4_window7_224_lite.yaml:4
    # DROP_PATH_RATE; applied per block at reference :209-210, :662-664)
    drop_path_rate: float = 0.2
    # --use-checkpoint (train_options.py:87): recompute each Swin block's
    # activations in the backward (torch.utils.checkpoint)
    use_checkpoint: bool = False
    # recompute the train-mode forwards of G, D and the segmenter in the
    # end2end problems' backward instead of keeping their activations
    # (torch.utils.checkpoint; the JAX package's jax.checkpoint)
    remat: bool = False
    compute_dtype: str = "bfloat16"  # torch.autocast dtype; 'float32' = off


@dataclass
class OptimConfig:
    """Learning rates & optimizer settings (scripts/train_end2end_jsrt.sh,
    train_options.py:26-33, pix2pix_model.py:75-82,
    train_end2end_jsrt.py:70-73, :324)."""
    lr: float = 2e-6                 # G/D Adam lr (end2end); pretrain 2e-5
    beta1: float = 0.5
    arch_lr: float = 1e-6
    arch_weight_decay: float = 1e-5  # end2end arch Adam (jsrt:324)
    unet_lr: float = 1e-4            # RMSprop
    gan_mode: str = "vanilla"
    lambda_L1: float = 100.0
    loss_lambda: float = 1.0         # weight of fake-image seg loss
    lr_policy: str = "linear"
    n_epochs: int = 10000            # pretrain scripts pass --n_epochs 10000
    epoch_count: int = 1
    n_epochs_decay: int = 100
    lr_decay_iters: int = 50
    plateau_patience: int = 5        # ReduceLROnPlateau(max, patience=5)
    plateau_factor: float = 0.1
    accumulate: int = 1              # the seg optimizer (and train_bbdm's
                                     # Adam, BBDM accumulate_grad_batches):
                                     # the mean of k micro-gradients steps
                                     # it on every k-th step
                                     # (optax.MultiSteps)


@dataclass
class EngineConfig:
    """Bilevel engine settings (train_end2end_jsrt.py:289-295)."""
    train_iters: int = 5000
    unroll_steps: int = 1
    valid_step: int = 10
    roll_back: bool = True
    hypergrad: str = "darts"         # darts | unroll | decay_only | none
    darts_epsilon: float = 0.01      # finite-difference r / ||v||
    detach_fakes: bool = True        # reference detaches G(fakes) in unet step
    fake_postprocess: str = "uint8_chain"  # uint8_chain | photometric | minmax
    # darts children of the arch problem (Betty u2l edges); the reference
    # wiring's ('netG',) makes the darts hypergradient structurally zero
    arch_children: tuple = ("netG",)


@dataclass
class RunConfig:
    """Output, checkpointing, logging, seed and device."""
    save_dir: str = "./checkpoints"
    name: str = "end2end-JSRT-9-unet"
    pretrained_pix2pix: str = ""     # stage-1 G/D checkpoint dir ('' = fresh)
    final_checkpoint: bool = True    # end2end: save the whole engine state
                                     # at the end
    resume: bool = False             # end2end: restore the latest engine
                                     # checkpoint and continue from it
    seed: int = 0
    log_every: int = 10
    save_every: int = 0              # end2end: save the engine state every N
                                     # iterations; pix2pix: G/D every N
                                     # epochs; 0 = only at the end
    topk_checkpoints: int = 3        # BBDM top-k-by-val-loss retention
    sample_only: bool = False        # BBDM main.py without -t: restore the
                                     # latest checkpoint, sample_to_eval and
                                     # the diversity score, no training
    seg_pretrained: str = ""         # torch checkpoint to start the seg
                                     # net from: torchvision
                                     # deeplabv3_resnet50 / ImageNet
                                     # resnet50 (backbone) / deeplabv2 /
                                     # swin-tiny / reference unet, mapped
                                     # onto the port's names
    model_file: str = ""             # test_seg: explicit checkpoint file
                                     # (the port's .pt, or a reference
                                     # milesial state_dict .pkl/.pth)
    export_path: str = ""            # export_seg: artifact output ('' =
                                     # <save_dir>/<name>/serving.pt2)
    export_platforms: str = ""       # export_seg: comma list of devices
                                     # (cpu, cuda), one artifact each; ''
                                     # = run.device
    export_batch: int = 0            # 0 = symbolic batch dim (one artifact,
                                     # any batch size); >0 pins it
    export_allow_fresh: bool = False  # export_seg: permit serializing a
                                      # fresh random init
    wandb: bool = False
    wandb_project: str = "end2end-JSRT"
    profile_dir: str = ""            # torch.profiler Chrome trace dir
                                     # ('' = off)
    device: str = "cuda"             # entry points run here; 'cpu' on request
    data_axis: int = 1               # data-parallel mesh size: 1 = off,
                                     # 0 = all visible cards, n = first n
                                     # (batch_size must divide the mesh
                                     # size; parallel/mesh.py)
    multihost: bool = False          # join the process group of a
                                     # multi-process launch at entry (the
                                     # DDP launcher, BBDM/main.py:70-87);
                                     # the group is then the data axis
    coordinator: str = ""            # host:port of rank 0, with
    num_processes: int = 0           # the process count and this
    process_id: int = -1             # process's id; '' / 0 / -1 = read
                                     # torchrun's MASTER_ADDR, MASTER_PORT,
                                     # WORLD_SIZE and RANK
    spatial_axis: int = 1            # 3D spatial-parallel mesh size: 1 =
                                     # off, 0 = every visible card
    amp: bool = True                 # kept for CLI familiarity (a no-op,
                                     # as in the JAX package: the compute
                                     # dtype is model.compute_dtype)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_dict(self):
        return dataclasses.asdict(self)


# The JAX package's presets whose entry points the port has; the others
# come with their slices.
PRESETS: dict[str, dict[str, Any]] = {
    # scripts/train_end2end_jsrt.sh; decay_only skips the darts term that is
    # structurally zero under this wiring (engine/bilevel.py docstring).
    "end2end_jsrt": {"engine.hypergrad": "decay_only"},
    # scripts/train_pix2pix_lung.sh (200 epochs x 80 imgs, lr 2e-5)
    "pix2pix_jsrt": {"optim.lr": 2e-5, "engine.train_iters": 8000,
                     "data.n_train": 80, "data.n_val": 20, "data.n_test": 0,
                     "run.name": "pix2pix-JSRT"},
    # scripts/train_pix2pix_isic.sh: the stage-1 run at output_nc 3 on
    # ISIC2018
    "pix2pix_isic": {"optim.lr": 2e-5, "engine.train_iters": 8000,
                     "data.dataset": "isic", "data.n_train": 80,
                     "data.n_val": 20, "data.n_test": 0,
                     "model.output_nc": 3, "run.name": "pix2pix-ISIC"},
    # ColorizationModel (models_pix2pix/colorization_model.py): L -> ab,
    # input_nc 1, output_nc 2, the boilerplate pix2pix lr
    "pix2pix_colorization": {"data.dataset": "pix2pix_colorization",
                             "model.input_nc": 1, "model.output_nc": 2,
                             "optim.lr": 2e-4,
                             "run.name": "pix2pix-colorization"},
    # scripts/train_end2end_isic.sh: 40 labeled (32+8), 594 test, Jaccard
    # loss; fakes post-processed by the fake_trans photometric chain
    # (train_end2end_isic.py:178-183, applied :264). output_nc stays 1 as
    # in the JAX preset: an RGB run passes --model.output_nc=3.
    "end2end_isic": {"data.dataset": "isic", "data.n_train": 32,
                     "data.n_val": 8, "data.n_test": 594,
                     "engine.fake_postprocess": "photometric",
                     "engine.hypergrad": "decay_only",
                     "run.name": "end2end-ISIC-40-unet"},
    # the Swin-UNet ISIC variant (util/ISIC_224_loader.py + --seg_model
    # vit): 224 inputs, the ResNet generator (any size) instead of the
    # 256-only unet G
    "end2end_isic224": {"data.dataset": "isic224", "data.image_size": 224,
                        "data.n_train": 32, "data.n_val": 8,
                        "data.n_test": 594, "model.seg_model": "vit",
                        "model.netG": "resnet_9blocks",
                        "engine.fake_postprocess": "photometric",
                        "run.name": "end2end-ISIC224-swin"},
    # live architecture search: the exact unrolled hypergradient through the
    # generator into the arch tables
    "end2end_nas": {"engine.hypergrad": "unroll",
                    "engine.detach_fakes": False,
                    "engine.fake_postprocess": "minmax",
                    "run.name": "end2end-JSRT-9-nas"},
    # GenSeg-3D/train_end2end.sh: hippocampus 98 volumes, 68/10/20, batch 1
    # (GenSeg-3D/options/base_options.py:47), the 3D pipeline's default
    # --norm instance (base_options.py:36); the same structural zero as 2D
    "end2end_3d": {"data.n_train": 68, "data.n_val": 10, "data.n_test": 20,
                   "data.batch_size": 1, "model.norm": "instance",
                   "optim.lr": 2e-4, "engine.hypergrad": "decay_only",
                   "run.name": "end2end-3d"},
    # BBDM Template-BBDM.yaml regime (pixel space)
    "bbdm": {"data.batch_size": 8, "engine.train_iters": 400000,
             "engine.valid_step": 50, "run.name": "bbdm"},
    # BBDM/train_end2end.py:278: fake weight 0.0; the same structural zero
    # (sampled fakes detached, outer loss = unet val loss)
    "end2end_bbdm": {"optim.loss_lambda": 0.0,
                     "engine.hypergrad": "decay_only",
                     "run.name": "end2end-bbdm"},
    # Soft-intro_VAE regime (ISIC-style splits)
    "sivae": {"data.dataset": "isic", "data.n_train": 32, "data.n_val": 8,
              "data.n_test": 594, "run.name": "sivae"},
    # the same structural zero as the other bilevel programs
    "end2end_sivae": {"data.dataset": "isic", "data.n_train": 32,
                      "data.n_val": 8, "data.n_test": 594,
                      "engine.hypergrad": "decay_only",
                      "run.name": "end2end-sivae"},
}

def _set_by_path(cfg: Config, path: str, raw: str | Any):
    section, _, leaf = path.partition(".")
    obj: Any = getattr(cfg, section, None)
    by_name = {f.name: f for f in fields(obj)} if obj is not None else {}
    if leaf not in by_name:
        raise SystemExit(f"unknown option --{path} (the port has no such "
                         "field, or does not implement it yet)")
    value = raw
    if isinstance(raw, str):            # parsed with the field's type
        current = getattr(obj, leaf)
        if isinstance(current, bool):
            value = raw.lower() in ("1", "true", "yes")
        elif isinstance(current, tuple):
            value = tuple(x for x in raw.split(",") if x)
        else:
            value = type(current)(raw)
    setattr(obj, leaf, value)


def parse_config(argv: list[str] | None = None, preset: str | None = None) -> Config:
    """Build a Config from ``--a.b=c`` style CLI args (and optional preset)."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = Config()
    rest = []
    for a in argv:
        if a.startswith("--preset="):
            preset = a.split("=", 1)[1]
        else:
            rest.append(a)
    if preset:
        if preset not in PRESETS:
            raise SystemExit(f"unknown preset {preset!r} (the port has "
                             f"{sorted(PRESETS)})")
        for k, v in PRESETS[preset].items():
            _set_by_path(cfg, k, v)
    for a in rest:
        if not a.startswith("--") or "=" not in a:
            raise SystemExit(f"unrecognized argument {a!r}; use --a.b=c")
        k, v = a[2:].split("=", 1)
        _set_by_path(cfg, k, v)
    return cfg


def resolve_device(name: str | None = None):
    """The torch device an entry point runs on: ``cuda`` unless the caller
    asks for ``cpu``. Raises when CUDA is asked for and absent — a run never
    drops to the CPU on its own."""
    import torch
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--run.device=cpu) "
            "to run on the CPU")
    return dev
