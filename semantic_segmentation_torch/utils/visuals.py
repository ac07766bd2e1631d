"""Images, image grids and the HTML report — the port of
``semantic_segmentation_tpu/utils/visuals.py`` (``util/util.py:9-103`` and
GenSeg-3D's HTML visualizer, ``util/visualizer.py:16-295``, without a
display server): the sample grids, the validation panels and the
inference images as PNG files, a volume's three mid-planes, and
``test_pix2pix``'s static ``index.html`` of titled image rows. numpy and
PIL (imported where a file is written).
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


def volume_mid_slices(vol) -> np.ndarray:
    """The three mid-planes of a (D, H, W[, 1]) volume side by side,
    min-max normalized to uint8 (the mri_viewer's view)."""
    v = np.asarray(vol, np.float32)
    if v.ndim == 4:
        v = v[..., 0]
    lo, hi = v.min(), v.max()
    v = (v - lo) / (hi - lo + 1e-8)
    d, h, w = v.shape
    panes = [v[d // 2], v[:, h // 2], v[:, :, w // 2]]
    size = max(p.shape for p in panes)
    canvas = np.zeros((size[0], sum(p.shape[1] for p in panes)), np.float32)
    x = 0
    for p in panes:
        canvas[: p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1]
    return (canvas * 255).astype(np.uint8)


class HTMLReport:
    """An ``index.html`` of titled rows of images (html_handler.py), the
    images as PNGs under ``images/``."""

    def __init__(self, directory: str, title: str = "results"):
        self.dir = directory
        self.title = title
        self.rows: list[tuple[str, list[str]]] = []
        os.makedirs(directory, exist_ok=True)

    def add_row(self, title: str, images: dict):
        """``images``: name -> (H, W, C) float array, saved as
        ``images/<title>_<name>.png``."""
        rel_paths = []
        for name, arr in images.items():
            rel = os.path.join("images", f"{title}_{name}.png")
            save_image(arr, os.path.join(self.dir, rel))
            rel_paths.append(rel)
        self.rows.append((title, rel_paths))

    def write(self):
        parts = [f"<html><head><title>{self.title}</title></head><body>",
                 f"<h1>{self.title}</h1>"]
        for title, paths in self.rows:
            parts.append(f"<h3>{title}</h3><div>")
            parts.extend(f'<img src="{p}" style="max-width:256px">'
                         for p in paths)
            parts.append("</div>")
        parts.append("</body></html>")
        with open(os.path.join(self.dir, "index.html"), "w") as f:
            f.write("\n".join(parts))
