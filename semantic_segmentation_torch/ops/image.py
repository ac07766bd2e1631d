"""Device-side image ops with the reference's uint8 numerics — the port of
``semantic_segmentation_tpu/ops/image.py``.

The fake-image post-processing of the end-to-end unet step
(``running_files/train_end2end_jsrt.py:196-200``): global min-max ->
uint8 -> histogram equalize -> gamma(0.5) -> /255, in integer arithmetic
that bit-matches PIL's ``ImageOps.equalize`` and torchvision's
``adjust_gamma``. Public functions keep the JAX package's NHWC contract.

``equalize_uint8`` and ``histogram256`` are the wrappers of the CUDA kernels
``kernels/csrc/equalize_uint8.cu`` and ``kernels/csrc/histogram256.cu``: a
CUDA tensor launches the kernel, a CPU tensor runs the plain PyTorch version
beside it (``*_ref``). Both kernels count with one thread-block cluster per
image (``kernels/csrc/hist256_cluster.cuh``); ``hist256_plan`` picks the
cluster size and the shared-memory layout from the shapes alone, so the CPU
tests can check it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.kernels.build import launch
from semantic_segmentation_torch.parallel import collectives

SMS = 132                  # streaming multiprocessors of an H100 SXM
HIST_THREADS = 256         # threads per CTA (hist256_cluster.cuh kThreads)
# dynamic shared bytes a CTA may take: the H100's 227 KB (232,448 bytes)
# less 1 KB for the kernels' static shared arrays
SMEM_MAX = 232448 - 1024
MIN_SLICE = 16 * HIST_THREADS   # bytes per CTA: one 16-byte load a thread
MAX_CLUSTER = 16           # the non-portable cluster size of an H100
# the equalize sends all its bins to every CTA of the cluster: at
# (64, 512, 512) 16-CTA clusters were slower than 8, at 256^2 the two were
# within the spread of repeated runs (scripts/sweep_torch_hist.py)
MAX_CLUSTER_EQUALIZE = 8


class Hist256Plan(NamedTuple):
    """How ``histogram256.cu`` and ``equalize_uint8.cu`` lay out one call.
    A cluster of ``cluster`` CTAs owns one image; the grid is ``ctas`` =
    ``cluster`` x images. CTA rank r counts bytes [r * slice_bytes,
    (r + 1) * slice_bytes) of its image (``hist256_slices``). With ``keep``
    (the equalize only) the slice stays in shared memory between the count
    and the apply. ``smem_bytes``: dynamic shared memory per CTA."""
    cluster: int
    ctas: int
    slice_bytes: int
    keep: bool
    smem_bytes: int


def _counts_bytes(c: int, cluster: int, equalize: bool) -> int:
    """Shared bytes of the CTA's counts and its slots: a row per CTA of the
    cluster of the bins it needs, its own 256 / cluster (histogram) or all
    c x 256 (equalize)."""
    return 4 * (c * 256 + (cluster * c * 256 if equalize else 256))


def hist256_plan(images: int, hw: int, c: int = 1,
                 equalize: bool = False) -> Hist256Plan:
    """The layout of one call on ``images`` images of ``hw`` pixels and
    ``c`` interleaved channels. The cluster is the smallest power of two in
    [2, 16] (the equalize: [2, 8]) that puts two CTAs on each of the
    card's ``SMS`` (so that slices stay small and an SM holds several
    CTAs), halved while a CTA would get less than ``MIN_SLICE`` bytes or
    the equalize's slots would not fit. Raises ValueError where the counts
    do not fit in shared memory."""
    nbytes = hw * c
    want = -(-2 * SMS // max(images, 1))
    cluster = min(MAX_CLUSTER_EQUALIZE if equalize else MAX_CLUSTER,
                  max(2, 1 << (want - 1).bit_length()))
    while cluster > 2 and (nbytes < cluster * MIN_SLICE or (
            equalize and _counts_bytes(c, cluster, True) > SMEM_MAX)):
        cluster //= 2
    per_cta = -(-nbytes // cluster)
    slice_bytes = max(16, -(-per_cta // 16) * 16)
    counts = _counts_bytes(c, cluster, equalize)
    keep = equalize and counts + slice_bytes + 16 <= SMEM_MAX
    smem = counts + (slice_bytes + 16 if keep else 0)
    if smem > SMEM_MAX:
        raise ValueError(f"hist256_plan: {c} channels need {smem} bytes of "
                         f"shared memory per CTA, more than {SMEM_MAX}")
    return Hist256Plan(cluster, cluster * images, slice_bytes, keep, smem)


def hist256_slices(plan: Hist256Plan, nbytes: int) -> list[tuple[int, int]]:
    """The [start, stop) bytes of an image of ``nbytes`` bytes that each
    rank of the cluster counts, as the kernels cut them (empty at the end
    where the image is short)."""
    return [(min(r * plan.slice_bytes, nbytes),
             min((r + 1) * plan.slice_bytes, nbytes))
            for r in range(plan.cluster)]


def _check_cluster_grid(name: str, n: int, nbytes: int, plan: Hist256Plan):
    if nbytes >= 2**31 or plan.ctas >= 2**31:
        raise ValueError(f"{name}: {n} images of {nbytes} bytes exceed the "
                         f"kernel's 32-bit sizes")


def minmax_normalize(x):
    """(x - min) / (max - min) over the WHOLE batch — the reference
    normalizes fake image batches globally (``train_end2end_jsrt.py:197``);
    under data parallelism over the global batch, with the gradient of the
    extremes (``parallel/collectives.global_min_max``)."""
    x = x.float()
    lo, hi = collectives.global_min_max(x)
    return (x - lo) / (hi - lo)


def to_uint8(x):
    """torch ``mul(255).add_(0.5).clamp_(0,255).to(torch.uint8)``: scale,
    round-half-up via +0.5, clamp, truncate (``train_end2end_jsrt.py:199``)."""
    return torch.clamp(x.float() * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def _equalize_lut(hist):
    """PIL ``ImageOps.equalize`` LUT per row of ``hist`` (P, 256), in
    integer arithmetic (``semantic_segmentation_tpu/ops/image.py:50-71``)."""
    hist = hist.to(torch.int64)
    bins = torch.arange(256, device=hist.device)
    nonzero = hist > 0
    # last nonzero bin; any bin when the histogram is empty (then identity)
    last_idx = 255 - torch.argmax(nonzero.flip(-1).to(torch.uint8), dim=-1)
    last_count = hist.gather(-1, last_idx[:, None])[:, 0]
    step = (hist.sum(-1) - last_count) // 255
    cum_excl = torch.cumsum(hist, -1) - hist
    lut = torch.clamp((step[:, None] // 2 + cum_excl)
                      // torch.clamp(step, min=1)[:, None], 0, 255)
    identity = (nonzero.sum(-1) <= 1) | (step == 0)
    return torch.where(identity[:, None], bins, lut)


def equalize_uint8_ref(img_u8):
    """Plain PyTorch version of the equalize kernel: every (image, channel)
    plane of an NHWC uint8 batch equalized on its own histogram."""
    n, h, w, c = img_u8.shape
    planes = img_u8.permute(0, 3, 1, 2).reshape(n * c, h * w).long()
    hist = torch.zeros(n * c, 256, dtype=torch.int64, device=img_u8.device)
    hist.scatter_add_(1, planes, torch.ones_like(planes))
    out = _equalize_lut(hist).gather(1, planes).to(torch.uint8)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).contiguous()


def equalize_uint8(img_u8):
    """Equalize an NHWC uint8 batch per (image, channel) plane. A CUDA
    tensor goes through the kernel, in one launch for all planes; a CPU
    tensor through ``equalize_uint8_ref``."""
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 4:
        raise ValueError(f"equalize_uint8 takes an NHWC uint8 batch, got "
                         f"{img_u8.dtype} {tuple(img_u8.shape)}")
    if img_u8.device.type == "cpu":
        return equalize_uint8_ref(img_u8)
    if img_u8.device.type != "cuda":
        raise ValueError(f"equalize_uint8: unsupported device {img_u8.device}")
    x = img_u8.contiguous()
    n, h, w, c = x.shape
    plan = hist256_plan(n, h * w, c, True)
    _check_cluster_grid("equalize_uint8", n, h * w * c, plan)
    out = torch.empty_like(x)
    launch("equalize_uint8", x.device, x.data_ptr(), out.data_ptr(), n, h * w,
           c, plan.cluster, plan.slice_bytes, int(plan.keep), plan.smem_bytes)
    return out


def histogram256_ref(imgs_u8):
    """Plain PyTorch version of the histogram kernel: (N, H, W) uint8 ->
    (N, 256) int32, one ``bincount`` over the pixels offset by 256 per
    image."""
    n = imgs_u8.shape[0]
    offs = 256 * torch.arange(n, device=imgs_u8.device)[:, None]
    flat = imgs_u8.reshape(n, -1).long() + offs
    return torch.bincount(flat.reshape(-1), minlength=256 * n).reshape(
        n, 256).to(torch.int32)


def histogram256(imgs_u8):
    """Per-image 256-bin histograms, the port of ``histogram256``/
    ``histogram256_pallas`` (``semantic_segmentation_tpu/ops/
    pallas_kernels.py:61-76, 260-274``): (N, H, W) uint8 -> (N, 256) int32.
    A CUDA tensor goes through ``kernels/csrc/histogram256.cu``, one launch
    that writes every count; a CPU tensor through ``histogram256_ref``."""
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 3:
        raise ValueError(f"histogram256 takes (N, H, W) uint8, got "
                         f"{imgs_u8.dtype} {tuple(imgs_u8.shape)}")
    if imgs_u8.device.type == "cpu":
        return histogram256_ref(imgs_u8)
    if imgs_u8.device.type != "cuda":
        raise ValueError(f"histogram256: unsupported device {imgs_u8.device}")
    x = imgs_u8.contiguous()
    n, h, w = x.shape
    plan = hist256_plan(n, h * w)
    _check_cluster_grid("histogram256", n, h * w, plan)
    out = torch.empty(n, 256, dtype=torch.int32, device=x.device)
    launch("histogram256", x.device, x.data_ptr(), out.data_ptr(), n, h * w,
           plan.cluster, plan.slice_bytes, plan.smem_bytes)
    return out


@functools.lru_cache(maxsize=16)
def _gamma_lut(gamma: float, gain: float, device: torch.device):
    v = torch.arange(256, dtype=torch.float32)
    out = torch.floor((255.0 + 1.0 - 1e-3) * gain * torch.pow(v / 255.0, gamma))
    return torch.clamp(out, 0, 255).to(torch.uint8).to(device)


def adjust_gamma_uint8(img_u8, gamma: float, gain: float = 1.0):
    """torchvision ``adjust_gamma`` on uint8: floor((256 - 1e-3) * gain *
    (v/255)**gamma). The 256 levels are computed once on the CPU, where the
    tests hold them bit-exact against the JAX package, and gathered on the
    device: no device ``pow`` can move a level by an ulp."""
    lut = _gamma_lut(float(gamma), float(gain), img_u8.device)
    return lut[img_u8.long()]


def equalize_gamma_chain(x, gamma: float = 0.5):
    """The fake-image post-processing of the end-to-end unet step
    (``train_end2end_jsrt.py:197-200``): global min-max -> uint8 ->
    equalize -> gamma -> back to [0, 1] float32. Input NHWC float; an input
    that requires grad is refused, since no gradient flows through the
    integer ops (the equalize kernel's float entry)."""
    kernels.refuse_grad("equalize_gamma_chain", x)
    u8 = to_uint8(minmax_normalize(x))
    u8 = adjust_gamma_uint8(equalize_uint8(u8), gamma)
    return u8.float() / 255.0


def threshold_mask(x, thresh: float = 0.1):
    """Binarize like ``torch.where(x > 0.1, 1, 0)``
    (``train_end2end_jsrt.py:191-193``)."""
    return (x > thresh).float()
