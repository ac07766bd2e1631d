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
beside it (``*_ref``).
"""

from __future__ import annotations

import functools

import torch

from semantic_segmentation_torch.kernels.build import launch


def minmax_normalize(x):
    """(x - min) / (max - min) over the WHOLE batch — the reference
    normalizes fake image batches globally (``train_end2end_jsrt.py:197``)."""
    x = x.float()
    lo, hi = x.min(), x.max()
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
    out = torch.empty_like(x)
    launch("equalize_uint8", x.device, x.data_ptr(), out.data_ptr(), n, h * w,
           c)
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
    A CUDA tensor goes through ``kernels/csrc/histogram256.cu``; a CPU tensor
    through ``histogram256_ref``."""
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 3:
        raise ValueError(f"histogram256 takes (N, H, W) uint8, got "
                         f"{imgs_u8.dtype} {tuple(imgs_u8.shape)}")
    if imgs_u8.device.type == "cpu":
        return histogram256_ref(imgs_u8)
    if imgs_u8.device.type != "cuda":
        raise ValueError(f"histogram256: unsupported device {imgs_u8.device}")
    x = imgs_u8.contiguous()
    n, h, w = x.shape
    if n > 65535:
        raise ValueError(f"histogram256: at most 65535 images, got {n}")
    out = torch.zeros(n, 256, dtype=torch.int32, device=x.device)
    launch("histogram256", x.device, x.data_ptr(), out.data_ptr(), n, h * w)
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
    equalize -> gamma -> back to [0, 1] float32. Input NHWC float."""
    u8 = to_uint8(minmax_normalize(x))
    u8 = adjust_gamma_uint8(equalize_uint8(u8), gamma)
    return u8.float() / 255.0


def threshold_mask(x, thresh: float = 0.1):
    """Binarize like ``torch.where(x > 0.1, 1, 0)``
    (``train_end2end_jsrt.py:191-193``)."""
    return (x > thresh).float()
