"""Device-side photometric augmentations — the port of
``semantic_segmentation_tpu/ops/photometric.py``: the ``fake_trans``
torchvision pipeline of the ISIC end-to-end script
(``train_end2end_isic.py:178-183``): RandomEqualize(0.5),
RandomPosterize(4 bits, 1.0), RandomAdjustSharpness(0.3, 0.5),
RandomAutocontrast(0.5), ColorJitter(saturation=0.5), on NHWC uint8
batches.

The equalize is ``ops/image.equalize_uint8``, the CUDA kernel on the card.
Each coin selects with ``torch.where`` on a device tensor, as the JAX
package does with ``jnp.where``: no coin is read back to the host, so the
equalize launches once per call whatever its coin says.
"""

from __future__ import annotations

import torch

from semantic_segmentation_torch.ops.image import equalize_uint8
from semantic_segmentation_torch.parallel import collectives

# torchvision's sharpness kernel [[1,1,1],[1,5,1],[1,1,1]] / 13, row-major
_SHARPEN_TAPS = tuple(v / 13.0 for v in (1.0, 1.0, 1.0, 1.0, 5.0, 1.0,
                                         1.0, 1.0, 1.0))


def posterize_uint8(img_u8, bits: int = 4):
    """Keep the top ``bits`` bits (torchvision posterize)."""
    return img_u8 & ((0xFF << (8 - bits)) & 0xFF)


def autocontrast_uint8(img_u8):
    """Per-(image, channel) min-max stretch to [0, 255] (torchvision
    autocontrast). NHWC."""
    x = img_u8.float()
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    stretch = hi > lo
    scale = torch.where(stretch, 255.0 / (hi - lo), 1.0)
    out = torch.where(stretch, (x - lo) * scale, x)
    return torch.clamp(out + 0.5, 0, 255).to(torch.uint8)


def sharpen_f32(img_u8, factor: float):
    """The float32 blend of ``adjust_sharpness_uint8`` before rounding.
    The 3x3 sum is taken tap by tap (no convolution library, so no TF32 on
    the card); its order is not XLA's, so a value within an ulp of a
    half-level may round the other way than in the JAX package."""
    x = img_u8.float()
    n, h, w, c = x.shape
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    blurred = None
    for t, wt in enumerate(_SHARPEN_TAPS):
        dy, dx = divmod(t, 3)
        term = pad[:, dy:dy + h, dx:dx + w] * wt
        blurred = term if blurred is None else blurred + term
    out = blurred + factor * (x - blurred)
    interior = torch.zeros(h, w, dtype=torch.bool, device=x.device)
    interior[1:-1, 1:-1] = True
    return torch.where(interior[None, :, :, None], out, x)


def adjust_sharpness_uint8(img_u8, factor: float):
    """torchvision adjust_sharpness: blend with the 3x3 smoothing of each
    plane, border rows and columns unchanged."""
    out = sharpen_f32(img_u8, factor)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def adjust_saturation_uint8(img_u8, factor):
    """Blend with the grayscale image (Rec601 luma); grayscale inputs are
    returned unchanged, like torchvision on 1-channel tensors."""
    if img_u8.shape[-1] != 3:
        return img_u8
    x = img_u8.float()
    luma = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[
        ..., None]
    out = luma + factor * (x - luma)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def draw_photometric(batch: int, per_image: bool = False,
                     generator: torch.Generator | None = None, device=None):
    """The draws of one ``random_photometric`` call: ``coins`` (3,) bool
    (equalize, sharpness, autocontrast), or (3, batch) per image, each true
    with probability 0.5; ``saturation`` () or (batch,), uniform in
    [0.5, 1.5)."""
    shape = (batch,) if per_image else ()
    coins = torch.rand((3,) + shape, generator=generator, device=device) < 0.5
    sat = 0.5 + torch.rand(shape, generator=generator, device=device)
    return {"coins": coins, "saturation": sat}


def random_photometric(img_u8, generator: torch.Generator | None = None,
                       per_image: bool = False, draws: dict | None = None):
    """The fake_trans pipeline on an NHWC uint8 batch. ``draws``
    (``draw_photometric``'s) replaces the draw from ``generator``.

    Batch coins (the default) are the reference's: it applies
    ``fake_trans`` to the whole batched tensor (train_end2end_isic.py:264),
    and each torchvision transform draws one ``torch.rand(1)`` per call.
    ``per_image`` draws coins and saturation factors per image (those of
    the global batch under data parallelism, of which this rank takes its
    rows)."""
    n = img_u8.shape[0]
    if draws is None:
        draws = draw_photometric(collectives.global_batch(n) if per_image
                                 else n, per_image, generator, img_u8.device)
    shape = (n, 1, 1, 1) if per_image else ()
    if per_image:
        draws = {"coins": collectives.rows(draws["coins"], n, dim=1),
                 "saturation": collectives.rows(draws["saturation"], n)}
    coin = [c.reshape(shape) for c in draws["coins"]]
    out = torch.where(coin[0], equalize_uint8(img_u8), img_u8)
    out = posterize_uint8(out, 4)
    out = torch.where(coin[1], adjust_sharpness_uint8(out, 0.3), out)
    out = torch.where(coin[2], autocontrast_uint8(out), out)
    return adjust_saturation_uint8(out, draws["saturation"].reshape(shape))
