"""On-device stochastic augmentation: the reference's imgaug pipeline as one
batched affine warp — the port of ``semantic_segmentation_tpu/ops/
augment.py``.

The reference applies, per image and in a random order
(``running_files/train_end2end_jsrt.py:100-112, 186-190``): Fliplr(0.5),
CropAndPad(percent=(0, 0.1)), Affine scale (0.8, 1.2), translate +-10%,
rotate +-15 deg, shear +-8 deg. Every member is affine, so the parameters are
drawn from a ``torch.Generator``, the six 3x3 matrices are composed in a
random order per image, and ONE bilinear warp is applied to the batch.
``torch.Generator`` cannot reproduce ``jax.random`` draws, so
``random_augment_batch`` also takes the matrices as an input.

``warp_affine_batch`` is the wrapper of the CUDA kernel
``kernels/csrc/warp_affine.cu``: a CUDA tensor launches the kernel, a CPU
tensor runs ``warp_affine_batch_ref``, the plain PyTorch version beside it.
"""

from __future__ import annotations

import math

import torch

from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.kernels.build import launch
from semantic_segmentation_torch.parallel import collectives


def _about_center(mat, h: float, w: float):
    """Conjugate (n, 3, 3) affines to act about the image center (the
    imgaug/skimage Affine convention)."""
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    pre = torch.tensor([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]],
                       device=mat.device)
    post = torch.tensor([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]],
                        device=mat.device)
    return pre @ mat @ post


def sample_affine_batch(n: int, h: int, w: int,
                        generator: torch.Generator | None = None,
                        device=None):
    """(n, 3, 3) composed forward matrices, one random parameter set and one
    random application order per image (``random_order=True``). Drawn on
    ``device`` (default: the generator's) from ``generator``."""
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    h, w = float(h), float(w)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    eye = torch.eye(3, device=dev).expand(n, 3, 3)
    do_flip = torch.rand(n, generator=generator, device=dev) < 0.5
    flip = eye.clone()
    flip[:, 0, 0] = torch.where(do_flip, -1.0, 1.0)
    flip[:, 0, 2] = torch.where(do_flip, w - 1.0, 0.0)

    # CropAndPad(percent=(0, 0.1)): independent per-side pads, resized back
    pads = uniform((n, 4), 0.0, 0.1)
    top, right, bottom, left = (pads[:, 0] * h, pads[:, 1] * w,
                                pads[:, 2] * h, pads[:, 3] * w)
    sx = w / (w + left + right)
    sy = h / (h + top + bottom)
    croppad = eye.clone()
    croppad[:, 0, 0], croppad[:, 0, 2] = sx, left * sx
    croppad[:, 1, 1], croppad[:, 1, 2] = sy, top * sy

    sxy = uniform((n, 2), 0.8, 1.2)
    scale = eye.clone()
    scale[:, 0, 0], scale[:, 1, 1] = sxy[:, 0], sxy[:, 1]
    scale = _about_center(scale, h, w)

    txy = uniform((n, 2), -0.1, 0.1)
    translate = eye.clone()
    translate[:, 0, 2], translate[:, 1, 2] = txy[:, 0] * w, txy[:, 1] * h

    r = uniform((n,), -15.0, 15.0) * math.pi / 180.0
    rot = eye.clone()
    rot[:, 0, 0], rot[:, 0, 1] = torch.cos(r), -torch.sin(r)
    rot[:, 1, 0], rot[:, 1, 1] = torch.sin(r), torch.cos(r)
    rot = _about_center(rot, h, w)

    shear = eye.clone()
    shear[:, 0, 1] = torch.tan(uniform((n,), -8.0, 8.0) * math.pi / 180.0)
    shear = _about_center(shear, h, w)

    mats = torch.stack([flip, croppad, scale, translate, rot, shear], 1)
    order = torch.argsort(torch.rand((n, 6), generator=generator, device=dev),
                          dim=1)
    rows = torch.arange(n, device=dev)
    mat = eye
    for j in range(6):
        mat = mats[rows, order[:, j]] @ mat
    return mat


def _inverse(mats):
    """Per-image inverse affines in f32 (``jnp.linalg.inv`` of the JAX path;
    the ``_ex`` form does not wait on the device to check for errors)."""
    return torch.linalg.inv_ex(mats.float())[0]


def warp_affine_batch_ref(imgs_nhwc, mats, cval: float = 0.0):
    """Plain PyTorch version of the warp kernel: the 4-tap gather of
    ``semantic_segmentation_tpu/ops/augment.py:121-153`` (out-of-bounds taps
    give ``cval``), coordinates in the elementwise order a*x + (b*y + c)."""
    n, h, w, c = imgs_nhwc.shape
    inv = _inverse(mats)
    dev = imgs_nhwc.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    sx = inv[:, 0, 0, None] * xs + (inv[:, 0, 1, None] * ys
                                    + inv[:, 0, 2, None])
    sy = inv[:, 1, 0, None] * xs + (inv[:, 1, 1, None] * ys
                                    + inv[:, 1, 2, None])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = imgs_nhwc.float().reshape(n, h * w, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(valid[..., None], vals, cval)

    out = (tap(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
           + tap(y0, x0 + 1) * (fx * (1 - fy))[..., None]
           + tap(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
           + tap(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    return out.reshape(n, h, w, c)


def warp_affine_batch(imgs_nhwc, mats, cval: float = 0.0):
    """Bilinear warp of an NHWC float32 batch by per-image FORWARD affines
    (n, 3, 3). A CUDA tensor goes through the kernel; a CPU tensor through
    ``warp_affine_batch_ref``. Inputs that require grad are refused."""
    if imgs_nhwc.dim() != 4 or imgs_nhwc.dtype != torch.float32:
        raise ValueError(f"warp_affine_batch takes an NHWC float32 batch, "
                         f"got {imgs_nhwc.dtype} {tuple(imgs_nhwc.shape)}")
    kernels.refuse_grad("warp_affine_batch", imgs_nhwc, mats)
    n, h, w, c = imgs_nhwc.shape
    if tuple(mats.shape) != (n, 3, 3) or mats.device != imgs_nhwc.device:
        raise ValueError(f"mats must be ({n}, 3, 3) on {imgs_nhwc.device}, "
                         f"got {tuple(mats.shape)} on {mats.device}")
    if imgs_nhwc.device.type == "cpu":
        return warp_affine_batch_ref(imgs_nhwc, mats, cval)
    if imgs_nhwc.device.type != "cuda":
        raise ValueError(f"warp_affine_batch: unsupported device "
                         f"{imgs_nhwc.device}")
    if n * h * w * c >= 2**31 or n > 65535:
        raise ValueError(f"warp_affine_batch: the kernel indexes in 32 bits "
                         f"and takes n <= 65535, got {tuple(imgs_nhwc.shape)}")
    x = imgs_nhwc.contiguous()
    coef = _inverse(mats)[:, :2, :].reshape(n, 6).contiguous()
    out = torch.empty_like(x)
    launch("warp_affine", x.device, x.data_ptr(), coef.data_ptr(),
           out.data_ptr(), n, h, w, c, float(cval))
    return out


def random_augment_batch(imgs_nhwc, generator: torch.Generator | None = None,
                         mats=None):
    """The imgaug-equivalent pipeline, one random parameter set per image
    (``train_end2end_jsrt.py:188-189``). Input (N, H, W, C); ``mats``
    (N, 3, 3) replaces the draw when given. Under data parallelism the
    matrices are the global batch's (drawn, or given, at its size) and
    this rank warps with its rows."""
    n, h, w, _ = imgs_nhwc.shape
    if mats is None:
        mats = sample_affine_batch(collectives.global_batch(n), h, w,
                                   generator, imgs_nhwc.device)
    mats = collectives.rows(mats.to(imgs_nhwc.device), n)
    return warp_affine_batch(imgs_nhwc.float(), mats)
