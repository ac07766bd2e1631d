"""In-memory loader families beyond the paired folders — the port's copy
of ``semantic_segmentation_tpu/data/extra.py``, identical in its arrays:

- the reference's five 2D families that load the whole dataset into arrays
  up front and normalize globally (``ArrayPairs`` and the resize helpers,
  PIL mode ``F`` as the JAX package resizes):

  - ``BSubtilisDataset`` (``util/B_subtilis_data.py``): ``source/`` and
    ``target_boundaries/``, the dataset's z-score, masks > 0.01;
  - ``OmniposeDataset`` (``util/omnipose_data.py``): ``*_img.tif`` /
    ``*_masks.tif``, per-image min-max, masks > 0.01;
  - ``DiabeticDataset`` (``util/diabetic_data.py``): ``*_img.jpg`` /
    ``*.png``, /255, 512 px by default;
  - ``DeePiCtDataset`` (``util/deepict_data.py``): one pickle of
    ``{train,test}_{features,labels}`` NHWC arrays;
  - ``NibSliceDataset`` (``util/data_loading_nib.py:44-134``): per-file 2D
    NIfTI images (``data/nifti.read_nifti``), per-image min-max, raw label
    ids.

  Train items are resized to ``img_size``² (the stochastic crop and flips
  of the reference run on the device, ``ops/augment.py``); eval items take
  torchvision's eval sizing (shorter side, then a center crop). Items are
  ``{"image": HWC float32, "mask": HW1 int32}``.
- BBDM's dataset variants (``BBDM/datasets/custom.py``): one directory of
  images, each item a target image and a condition synthesized from it
  (the image itself, its luma, the image with a box zeroed, or the L
  channel of its LAB decode). Items are ``{"image_pix2pix": HWC float32,
  "mask_pix2pix": HWC float32}`` in [0, 1]; the BBDM trainer's loss maps
  them to [-1, 1].

numpy and PIL (imported where a file is opened).
"""

from __future__ import annotations

import os

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif")


def _resize_shorter(a: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    """torchvision ``transforms.Resize(size)`` on HxW(xC): the shorter side
    to ``size``."""
    h, w = a.shape[:2]
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    return _resize_exact(a, nh, nw, nearest)


def _resize_exact(a: np.ndarray, nh: int, nw: int,
                  nearest: bool) -> np.ndarray:
    """Each channel through PIL mode ``F`` (float32), bilinear or
    nearest."""
    from PIL import Image
    squeeze = a.ndim == 2
    if squeeze:
        a = a[..., None]
    resample = Image.NEAREST if nearest else Image.BILINEAR
    chans = [np.asarray(
        Image.fromarray(a[..., c].astype(np.float32), mode="F")
        .resize((nw, nh), resample=resample)) for c in range(a.shape[-1])]
    out = np.stack(chans, axis=-1)
    return out[..., 0] if squeeze else out


def _center_crop(a: np.ndarray, size: int) -> np.ndarray:
    h, w = a.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return a[top:top + size, left:left + size]


def _eval_resize(a: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    return _center_crop(_resize_shorter(a, size, nearest), size)


def _train_resize(a: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    return _resize_exact(a, size, size, nearest)


class ArrayPairs:
    """Pre-decoded (image, mask) arrays with train or eval sizing; masks
    binarized > 0.1 (the reference's ``(mask > 0.1).long()``)."""

    def __init__(self, images, masks, img_size: int, train: bool):
        fit = _train_resize if train else _eval_resize
        self.items = []
        for img, m in zip(images, masks):
            img = fit(np.asarray(img, np.float32), img_size, nearest=False)
            if img.ndim == 2:
                img = img[..., None]
            m = fit(np.asarray(m, np.float32), img_size, nearest=True)
            m = (m > 0.1).astype(np.int32)
            if m.ndim == 3:
                m = m[..., 0]
            self.items.append({"image": img, "mask": m[..., None]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


def _open_f32(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path), np.float32)


class BSubtilisDataset(ArrayPairs):
    """``util/B_subtilis_data.py:11-63``: ``source/`` images with the
    dataset's z-score; masks from ``target_boundaries/`` (same names)
    binarized > 0.01."""

    def __init__(self, root: str, img_size: int = 256, train: bool = True):
        imgs, masks = [], []
        src = os.path.join(root, "source")
        for f in sorted(os.listdir(src)):
            imgs.append(_open_f32(os.path.join(src, f)))
            marr = _open_f32(os.path.join(root, "target_boundaries", f))
            masks.append((marr > 0.01).astype(np.float32))
        flat = np.concatenate([i.ravel() for i in imgs])
        mean, std = flat.mean(), flat.std()
        imgs = [(i - mean) / (std + 1e-5) for i in imgs]
        super().__init__(imgs, masks, img_size, train)


class OmniposeDataset(ArrayPairs):
    """``util/omnipose_data.py:10-62``: ``*_img.tif`` with
    ``*_masks.tif``, per-image min-max, masks > 0.01."""

    def __init__(self, root: str, img_size: int = 256, train: bool = True):
        imgs, masks = [], []
        for f in sorted(os.listdir(root)):
            if not f.endswith("_img.tif"):
                continue
            a = _open_f32(os.path.join(root, f))
            a = (a - a.min()) / max(a.max() - a.min(), 1e-12)
            imgs.append(a)
            marr = _open_f32(os.path.join(
                root, f.replace("_img.tif", "_masks.tif")))
            masks.append((marr > 0.01).astype(np.float32))
        super().__init__(imgs, masks, img_size, train)


class DiabeticDataset(ArrayPairs):
    """``util/diabetic_data.py:11-64``: ``*_img.jpg`` with ``*.png``,
    /255, 512 px by default."""

    def __init__(self, root: str, img_size: int = 512, train: bool = True):
        imgs, masks = [], []
        for f in sorted(os.listdir(root)):
            if not f.endswith("_img.jpg"):
                continue
            imgs.append(_open_f32(os.path.join(root, f)) / 255.0)
            masks.append(_open_f32(os.path.join(
                root, f.replace("_img.jpg", ".png"))))
        super().__init__(imgs, masks, img_size, train)


class DeePiCtDataset(ArrayPairs):
    """``util/deepict_data.py:12-66``: a pickle of
    ``{train,test}_{features,labels}`` NHWC arrays, the train split (or
    the test one with ``train`` False, at eval sizing); the reference's
    host flips and rot90s are the device augment's."""

    def __init__(self, file: str, img_size: int = 256, train: bool = True):
        import pickle
        with open(file, "rb") as f:
            d = pickle.load(f)
        key = "train" if train else "test"
        feats = np.asarray(d[f"{key}_features"], np.float32)
        labels = np.asarray(d[f"{key}_labels"], np.float32)
        super().__init__(list(feats), list(labels), img_size, train)


class NibSliceDataset:
    """``util/data_loading_nib.py:44-134``: per-file 2D NIfTI images paired
    by id (``<id><mask_suffix>.*`` in ``masks_dir``), per-image min-max,
    the labels' raw ids."""

    def __init__(self, images_dir: str, masks_dir: str,
                 mask_suffix: str = ""):
        from pathlib import Path
        self.images_dir = Path(images_dir)
        self.masks_dir = Path(masks_dir)
        self.mask_suffix = mask_suffix
        self.ids = sorted(
            os.path.splitext(f)[0].removesuffix(".nii")
            for f in os.listdir(images_dir)
            if not f.startswith(".") and
            os.path.isfile(os.path.join(images_dir, f)))
        if not self.ids:
            raise RuntimeError(f"No input file found in {images_dir}")

    def __len__(self):
        return len(self.ids)

    def _load(self, directory, stem):
        from semantic_segmentation_torch.data.nifti import read_nifti
        files = list(directory.glob(stem + ".*"))
        if len(files) != 1:
            raise ValueError(f"expected exactly one file for {stem}: "
                             f"{files}")
        data, _ = read_nifti(str(files[0]))
        return data

    def __getitem__(self, idx):
        name = self.ids[idx]
        img = self._load(self.images_dir, name).astype(np.float32)
        mask = self._load(self.masks_dir, name + self.mask_suffix)
        if img.ndim == 2:
            img = img[..., None]
        img = (img - img.min()) / max(img.max() - img.min(), 1e-12)
        if mask.ndim == 3:
            mask = mask[..., 0]
        return {"image": img, "mask": mask.astype(np.int32)[..., None]}


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
