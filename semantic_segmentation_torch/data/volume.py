"""3D volume datasets and transforms — the port's own copy of
``semantic_segmentation_tpu/data/volume.py``, numpy identical, so both
packages draw the same volumes. The GenSeg-3D data layer
(``GenSeg-3D/data/nifti_dataset.py:21-162``, ``base_dataset.py:93-170``,
``transforms.py:7-187``) without torchio/nibabel: native NIfTI IO + numpy
transforms on host, stacked NDHWC arrays for the device pipeline.

Default preprocessing matches ``get_transform_torchio`` at the canonical
flags (preprocess='take_center_and_crop', load 64, crop 64): CropOrPad to
64^3 about the volume center, optional LR/AP random flip, RescaleIntensity
to [0,1], then (x - 0.5)/0.5 -> [-1, 1]. Truth maps are binarized
(``truth != min``); ``A``'s foreground mask rides along
(nifti_dataset.py:150-157).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from semantic_segmentation_torch.data.nifti import read_nifti


def crop_or_pad(vol: np.ndarray, target: int):
    """torchio CropOrPad: center crop / symmetric pad each spatial axis."""
    out = vol
    for ax in range(3):
        size = out.shape[ax]
        if size > target:
            lo = (size - target) // 2
            out = np.take(out, range(lo, lo + target), axis=ax)
        elif size < target:
            lo = (target - size) // 2
            pads = [(0, 0)] * out.ndim
            pads[ax] = (lo, target - size - lo)
            out = np.pad(out, pads)
    return out


def rescale_intensity(vol: np.ndarray):
    lo, hi = float(vol.min()), float(vol.max())
    if hi == lo:
        return np.zeros_like(vol, dtype=np.float32)
    return ((vol - lo) / (hi - lo)).astype(np.float32)


def normalize_05(vol: np.ndarray):
    return (vol - 0.5) / 0.5


def pad_to_divisible(vol: np.ndarray, k: int = 16):
    """transforms.py PadToDivisible (trailing-side pad)."""
    pads = []
    for ax in range(3):
        r = (-vol.shape[ax]) % k
        pads.append((0, r))
    pads += [(0, 0)] * (vol.ndim - 3)
    return np.pad(vol, pads)


def normalize_intensity_nonzero(vol: np.ndarray):
    """transforms.py NormalizeIntensity: z-score over nonzero voxels."""
    mask = vol != 0
    if not mask.any():
        return vol.astype(np.float32)
    mean, std = vol[mask].mean(), vol[mask].std()
    return ((vol - mean) / (std + 1e-5)).astype(np.float32)


class NiftiPairedDataset:
    """NIfTIDataset equivalent: imgsA/imgsB(+truths) dirs with same-named
    volumes; full-3D mode. Returns A, B in [-1,1], ``mask`` = A-foreground,
    ``truth`` = binarized label (zeros when absent), all NDHWC-style
    (D, H, W, 1) float32."""

    def __init__(self, root: str, dir_a: str = "imgsA", dir_b: str = "imgsB",
                 dir_truth: str = "truths", crop_size: int = 64,
                 random_flip: bool = True, seed: int = 0,
                 sliced: bool = False, chosen_slice: int = 0,
                 image_size: int = 256):
        """``sliced=True`` is the reference's 2D ``chosen_slice`` mode
        (nifti_dataset.py:119-131 + util/util.py:91-108): take z-slice
        ``chosen_slice``, min-max normalize, resize to ``image_size``, and
        return (H, W, 1) items in [-1, 1] (the 2D pipeline's
        Normalize(0.5, 0.5)); truth binarized against its min."""
        self.paths_a = sorted(glob(os.path.join(root, dir_a, "*.nii*")))
        self.paths_b = sorted(glob(os.path.join(root, dir_b, "*.nii*")))
        assert len(self.paths_a) == len(self.paths_b) and self.paths_a, \
            f"no paired volumes under {root}"
        self.truth_dir = os.path.join(root, dir_truth)
        self.crop_size = crop_size
        self.random_flip = random_flip
        self.seed = seed
        self.sliced = sliced
        self.chosen_slice = chosen_slice
        self.image_size = image_size

    def __len__(self):
        return len(self.paths_a)

    def _slice_item(self, a, b, truth):
        def prep2d(v):
            v = np.asarray(v, np.float64)[:, :, self.chosen_slice]
            v = (v - v.min()) / max(v.max() - v.min(), 1e-12)
            from PIL import Image
            im = Image.fromarray((v * 255).astype(np.uint8), "L").resize(
                (self.image_size, self.image_size), resample=Image.BICUBIC)
            return np.asarray(im, np.float32) / 255.0
        a2, b2 = prep2d(a), prep2d(b)
        if truth is not None:
            t = np.asarray(truth, np.float64)[:, :, self.chosen_slice]
            t = (t != t.min()).astype(np.float32)
            from PIL import Image
            t = np.asarray(Image.fromarray(t).resize(
                (self.image_size, self.image_size),
                resample=Image.NEAREST), np.float32)
        else:
            t = np.zeros_like(b2)
        mask_a = (a2 != a2.min()).astype(np.float32)
        # 2D pipeline ends with Normalize(0.5, 0.5) -> [-1, 1]
        return {"A": (a2 * 2 - 1)[..., None], "B": (b2 * 2 - 1)[..., None],
                "mask": mask_a[..., None], "truth": t[..., None]}

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, idx))
        a, _ = read_nifti(self.paths_a[idx])
        b, _ = read_nifti(self.paths_b[idx])
        assert os.path.basename(self.paths_a[idx]) == \
            os.path.basename(self.paths_b[idx])
        tp = os.path.join(self.truth_dir, os.path.basename(self.paths_a[idx]))
        truth = read_nifti(tp)[0] if os.path.exists(tp) else None
        if self.sliced:
            return self._slice_item(a, b, truth)

        def prep(v):
            return crop_or_pad(np.asarray(v, np.float32), self.crop_size)

        a, b = prep(a), prep(b)
        truth = prep(truth) if truth is not None else np.zeros_like(b)
        if self.random_flip:  # LR / AP axes (base_dataset.py:163-165)
            for ax in (0, 1):
                if rng.random() < 0.5:
                    a, b, truth = (np.flip(x, axis=ax) for x in (a, b, truth))
        truth = (truth != truth.min()).astype(np.float32)
        mask_a = (a != a.min()).astype(np.float32)
        a = normalize_05(rescale_intensity(a))
        b = normalize_05(rescale_intensity(b))
        return {
            "A": a[..., None].astype(np.float32),
            "B": b[..., None].astype(np.float32),
            "mask": mask_a[..., None],
            "truth": truth[..., None],
        }


class SyntheticVolumeDataset:
    """Deterministic synthetic paired volumes with the NiftiPairedDataset
    contract (hippocampus-like blobs) — test/bench fixture."""

    def __init__(self, n: int = 8, size: int = 32, seed: int = 0):
        self.n, self.size, self.seed = n, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, idx))
        s = self.size
        zz, yy, xx = np.mgrid[0:s, 0:s, 0:s].astype(np.float32) / s
        c = rng.uniform(0.3, 0.7, 3)
        r = rng.uniform(0.15, 0.3, 3)
        blob = (((xx - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 +
                ((zz - c[2]) / r[2]) ** 2) < 1.0
        truth = blob.astype(np.float32)
        a = truth * 0.8 + 0.1 + 0.05 * rng.standard_normal((s, s, s))
        b = truth * 0.5 + 0.3 * np.sin(8 * xx) * np.cos(7 * yy) + \
            0.05 * rng.standard_normal((s, s, s))
        a = normalize_05(rescale_intensity(a.astype(np.float32)))
        b = normalize_05(rescale_intensity(b.astype(np.float32)))
        return {
            "A": a[..., None].astype(np.float32),
            "B": b[..., None].astype(np.float32),
            "mask": (a != a.min()).astype(np.float32)[..., None],
            "truth": truth[..., None],
        }
