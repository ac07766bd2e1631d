"""BBDM's dataset variants beyond aligned pairs — the port's copy of the
BBDM part of ``semantic_segmentation_tpu/data/extra.py``
(``BBDM/datasets/custom.py``): one directory of images, each item a target
image and a condition synthesized from it (the image itself, its luma, the
image with a box zeroed, or the L channel of its LAB decode). Items are
``{"image_pix2pix": HWC float32, "mask_pix2pix": HWC float32}`` in [0, 1];
the BBDM trainer's loss maps them to [-1, 1]. numpy and PIL (imported
where a file is opened), identical to the JAX package's arrays. The other
in-memory families of that module come with ROADMAP.md section 1 item 8.
"""

from __future__ import annotations

import os

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif")


class _ImageDir:
    """custom.py ImagePathDataset core: one directory of images, resized;
    ``flip`` doubles the dataset with mirrored copies (custom.py:__len__)."""

    def __init__(self, directory: str, image_size: int, flip: bool):
        self.paths = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.lower().endswith(_EXTS))
        if not self.paths:
            raise RuntimeError(f"no images under {directory}")
        self.image_size = image_size
        self.flip = flip

    def __len__(self):
        return len(self.paths) * (2 if self.flip else 1)

    def load(self, index):
        from PIL import Image
        flipped = index >= len(self.paths)
        im = Image.open(self.paths[index % len(self.paths)]).convert("RGB")
        im = im.resize((self.image_size, self.image_size),
                       resample=Image.BILINEAR)
        if flipped:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(im, np.float32) / 255.0


class SingleImageDataset(_ImageDir):
    """custom_single: unconditional, the condition is the image."""

    def __getitem__(self, index):
        img = self.load(index)
        return {"image_pix2pix": img, "mask_pix2pix": img}


class ColorizationDataset(_ImageDir):
    """custom_colorization_RGB (custom.py:104-151): the condition is the
    ITU-R 601-2 luma replicated to 3 channels."""

    def __getitem__(self, index):
        img = self.load(index)
        luma = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])
        cond = np.repeat(luma[..., None], 3, axis=-1)
        return {"image_pix2pix": img, "mask_pix2pix": cond}


class InpaintingDataset(_ImageDir):
    """custom_inpainting (custom.py:154-211): the condition is the image
    with a random 128-180 px box zeroed, drawn from ``(seed, index)``."""

    def __init__(self, directory: str, image_size: int = 256,
                 flip: bool = False, seed: int = 0):
        super().__init__(directory, image_size, flip)
        self.seed = seed

    def __getitem__(self, index):
        img = self.load(index)
        h = w = self.image_size
        rng = np.random.default_rng((self.seed, index))
        lo = min(128, h // 2)
        hi = min(180, h - 1)
        mh = int(rng.integers(lo, hi + 1))
        mw = int(rng.integers(lo, hi + 1))
        px = int(rng.integers(0, h - mh + 1))
        py = int(rng.integers(0, w - mw + 1))
        cond = img.copy()
        cond[px:px + mh, py:py + mw, :] = 0.0
        return {"image_pix2pix": img, "mask_pix2pix": cond}


_RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                        [0.212671, 0.715160, 0.072169],
                        [0.019334, 0.119193, 0.950227]])


def rgb_to_lab_u8(rgb: np.ndarray) -> np.ndarray:
    """8-bit RGB -> 8-bit LAB with OpenCV's COLOR_RGB2LAB conventions (L
    scaled to 0..255 by 255/100, a and b offset by 128), the decode of
    ``BBDM/datasets/custom.py:83-85``, in float math (cv2's fixed-point
    table rounds within 1 LSB of it)."""
    x = rgb.astype(np.float64) / 255.0
    xyz = x @ _RGB_TO_XYZ.T
    xyz[..., 0] /= 0.950456
    xyz[..., 2] /= 1.088754

    def f(t):
        return np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)

    y = xyz[..., 1]
    lum = np.where(y > 0.008856, 116.0 * np.cbrt(y) - 16.0, 903.3 * y)
    fx, fy, fz = f(xyz[..., 0]), f(y), f(xyz[..., 2])
    a = 500.0 * (fx - fy) + 128.0
    b = 200.0 * (fy - fz) + 128.0
    lab = np.stack([lum * 255.0 / 100.0, a, b], axis=-1)
    return np.clip(np.round(lab), 0, 255).astype(np.uint8)


def lab_to_rgb(lab01: np.ndarray) -> np.ndarray:
    """The inverse of :func:`rgb_to_lab_u8`'s float formula: an
    8-bit-convention LAB array scaled to [0, 1] -> float RGB in [0, 1]."""
    lab = np.asarray(lab01, np.float64)
    lum = lab[..., 0] * 100.0
    a = lab[..., 1] * 255.0 - 128.0
    b = lab[..., 2] * 255.0 - 128.0
    y = np.where(lum > 903.3 * 0.008856, ((lum + 16.0) / 116.0) ** 3,
                 lum / 903.3)
    fy = np.where(y > 0.008856, np.cbrt(y), 7.787 * y + 16.0 / 116.0)
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        return np.where(t ** 3 > 0.008856, t ** 3, (t - 16.0 / 116.0) / 7.787)

    xyz = np.stack([finv(fx) * 0.950456, y, finv(fz) * 1.088754], axis=-1)
    rgb = xyz @ np.linalg.inv(_RGB_TO_XYZ).T
    return np.clip(rgb, 0.0, 1.0)


class LABColorizationDataset(_ImageDir):
    """custom_colorization_LAB (custom.py:58-102): the target is the 8-bit
    LAB decode, the condition its L channel replicated to 3 channels; [0, 1]
    here composes with the trainer's (x * 2 - 1) to the reference's
    (lab - 127.5) / 127.5."""

    def __getitem__(self, index):
        img = self.load(index)
        lab = rgb_to_lab_u8(
            np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        ).astype(np.float32) / 255.0
        cond = np.repeat(lab[..., :1], 3, axis=-1)
        return {"image_pix2pix": lab, "mask_pix2pix": cond}


class Pix2PixColorizationDataset(_ImageDir):
    """The pix2pix colorization pairs (``models_pix2pix/colorization_model.
    py:7-13``, input_nc 1, output_nc 2): the condition is the L channel of
    the 8-bit LAB decode, the target its a and b channels, both in [0, 1];
    ``lab_to_rgb`` renders (L, ab) for the visuals."""

    def __getitem__(self, index):
        img = self.load(index)
        lab = rgb_to_lab_u8(
            np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        ).astype(np.float32) / 255.0
        return {"image_pix2pix": lab[..., 1:], "mask_pix2pix": lab[..., :1]}


BBDM_FAMILIES = {"single": SingleImageDataset,
                 "colorization_rgb": ColorizationDataset,
                 "colorization_lab": LABColorizationDataset,
                 "inpainting": InpaintingDataset}
