"""The image history buffer — the port of
``semantic_segmentation_tpu/utils/image_pool.py`` (``util/image_pool.py:
5-54``): a replay buffer of up to ``pool_size`` images that answers each
incoming image with the image itself or, with probability 0.5 once full,
a stored one that the new image replaces. ``pool_size=0`` (pix2pix's) is a
pass-through. Host-side numpy state drawn from ``default_rng(seed)``, the
JAX package's draws; no trainer of either package uses it."""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images: list[np.ndarray] = []
        self._rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return images
        out = []
        for image in images:
            if len(self.images) < self.pool_size:
                self.images.append(image.copy())
                out.append(image)
            elif self._rng.random() > 0.5:
                idx = int(self._rng.integers(0, self.pool_size))
                out.append(self.images[idx].copy())
                self.images[idx] = image.copy()
            else:
                out.append(image)
        return np.stack(out)
