"""Images and image grids — the port of ``tensor2im``, ``save_image``,
``save_image_grid`` and ``save_image_raw`` of
``semantic_segmentation_tpu/utils/visuals.py`` (``util/util.py:9-103``):
the BBDM sample grids, the validation panels and the soft-intro VAE's
inference images as PNG files, numpy and PIL (imported where a file is
written). The static HTML report comes with ``test_pix2pix`` (ROADMAP.md
section 1, item 12).
"""

from __future__ import annotations

import os

import numpy as np


def tensor2im(arr, scale_tanh: bool = True) -> np.ndarray:
    """(H, W, C) float -> uint8 image; outputs in [-1, 1] are remapped as
    util/util.py's tensor2im does."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 4:
        a = a[0]
    if scale_tanh and a.min() < -0.01:
        a = (a + 1.0) / 2.0
    a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if a.shape[-1] == 1:
        a = a[..., 0]
    return a


def save_image(arr, path: str):
    """One (H, W, C) float image as a PNG (``tensor2im``'s mapping)."""
    save_image_raw(tensor2im(arr), path)


def save_image_grid(arrs, path: str, cols: int = 4):
    """A row-major grid of (H, W, C) images; a mix of gray and RGB panels
    is promoted to RGB."""
    ims = [tensor2im(a) for a in arrs]
    h, w = ims[0].shape[:2]
    rows = (len(ims) + cols - 1) // cols
    mode_rgb = any(im.ndim == 3 for im in ims)
    if mode_rgb:
        ims = [np.repeat(im[..., None], 3, -1) if im.ndim == 2 else im
               for im in ims]
    grid = np.zeros((rows * h, cols * w) + ((3,) if mode_rgb else ()),
                    np.uint8)
    for i, im in enumerate(ims):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    save_image_raw(grid, path)


def save_image_raw(u8: np.ndarray, path: str):
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(u8).save(path)
