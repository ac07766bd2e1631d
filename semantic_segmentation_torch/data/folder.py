"""Host-side paired image/mask folder datasets — the port's copy of
``semantic_segmentation_tpu/data/folder.py`` for the folder families.

One parameterized loader covers the JSRT/NLM/SZ family
(``util/JSRT_loader.py:13-106``: grayscale, equalize + gamma(0.5) applied on
file load for the segmentation copies only, bicubic mask resize through the
default PIL path) and the ISIC family (``util/ISIC_loader.py``: RGB images,
raw loads, NEAREST mask resize), plus suffix-based mask pairing (SZ
'_mask', PH2 '_lesion').

Decode runs on the host with PIL, imported where a file is opened, so the
package imports without it. Outputs are NHWC numpy float32/int32, the same
arrays as the JAX package's: images /255 in [0, 1]; masks /255 floored to
integer classes (the reference's ``.long()`` cast).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from os.path import splitext
from pathlib import Path

import numpy as np


def _adjust_gamma_pil(im, gamma: float, gain: float = 1.0):
    """torchvision PIL adjust_gamma LUT:
    int((256 - 1e-3) * gain * (i/255)^g)."""
    lut = [int((255 + 1 - 1e-3) * gain * ((i / 255.0) ** gamma))
           for i in range(256)]
    if im.mode == "L":
        return im.point(lut)
    if im.mode == "RGB":
        return im.point(lut * 3)
    return im.convert("L").point(lut)


def _equalize_gamma(im):
    """util/JSRT_loader.py:62: adjust_gamma(ImageOps.equalize(img), 0.5)."""
    from PIL import ImageOps
    if im.mode not in ("L", "RGB", "P"):
        im = im.convert("L")
    return _adjust_gamma_pil(ImageOps.equalize(im), 0.5)


@dataclass(frozen=True)
class DatasetSpec:
    """Per-dataset policy knobs distinguishing the reference's loader clones.

    mask_policy controls label decode:
      - "div255": ``(arr/255).long()`` — reference JSRT/ISIC binary masks
        (JSRT_loader.py:47-49). Floors 1..254 to 0; binary-only by design.
      - "binary_gt0": ``(arr > 0)`` — SE_loader.py:51.
      - "ids": raw integer label ids (liver3_loader.py:50-52) — required for
        classes > 1, where div255 would destroy the labels.
    image_norm: "div255" (most loaders) or "minmax" per-image
    (liver3_loader.py:48).
    equalize_gamma_mask: liver3's ``load()`` applies equalize+gamma to BOTH
    copies including the mask file (liver3_loader.py:62).
    """
    rgb: bool = False                 # image channels (ISIC True)
    equalize_gamma: bool = True       # JSRT/Breast True; ISIC False
    mask_nearest: bool = False        # ISIC resizes masks with NEAREST
    image_size: int = 256
    mask_policy: str = "div255"       # div255 | binary_gt0 | ids
    image_norm: str = "div255"        # div255 | minmax
    equalize_gamma_mask: bool = False
    classes: int = 1


DATASET_SPECS: dict[str, DatasetSpec] = {
    "jsrt": DatasetSpec(),
    "nlm": DatasetSpec(),
    "sz": DatasetSpec(),
    "breast": DatasetSpec(),
    "isic": DatasetSpec(rgb=True, equalize_gamma=False, mask_nearest=True),
    "isic224": DatasetSpec(rgb=True, equalize_gamma=False, mask_nearest=True,
                           image_size=224),
    "ph2": DatasetSpec(rgb=True, equalize_gamma=False, mask_nearest=True),
    "dermis": DatasetSpec(rgb=True, equalize_gamma=False, mask_nearest=True),
    "cell": DatasetSpec(equalize_gamma=False),
    "fetoscopy": DatasetSpec(rgb=True, equalize_gamma=False),
    # util/SE_loader.py: native-mode image, /255; mask NEAREST + (arr>0)
    "se": DatasetSpec(equalize_gamma=False, mask_nearest=True,
                      mask_policy="binary_gt0"),
    # util/liver_data.py: grayscale, no equalize (commented out), /255 both
    "liver": DatasetSpec(equalize_gamma=False),
    # util/liver3_loader.py: equalize+gamma on BOTH files, per-image min-max
    # image norm, raw integer mask ids
    "liver3": DatasetSpec(equalize_gamma=True, equalize_gamma_mask=True,
                          image_norm="minmax", mask_policy="ids"),
}

# the families of the JAX package's make_dataset that are not folders of
# paired files, and the ROADMAP.md section 1 item that ports each
UNPORTED_FAMILIES = {
    "b_subtilis": 8, "bsubtilis": 8, "omnipose": 8, "diabetic": 8,
    "deepict": 8, "deepict_test": 8, "nib": 8,
    "pix2pix_colorization": 4,
}


class PairedImageFolder:
    """BasicDataset equivalent: ids from the images dir; the mask is globbed
    as ``<id><suffix>.*`` in the masks dir (JSRT_loader.py:80-84)."""

    def __init__(self, images_dir: str, masks_dir: str, mask_suffix: str = "",
                 spec: DatasetSpec = DatasetSpec()):
        self.images_dir = Path(images_dir)
        self.masks_dir = Path(masks_dir)
        self.mask_suffix = mask_suffix
        self.spec = spec
        self.ids = sorted(
            splitext(f)[0] for f in os.listdir(images_dir)
            if not f.startswith("."))
        if not self.ids:
            raise RuntimeError(f"No input file found in {images_dir}")

    def __len__(self):
        return len(self.ids)

    def _find(self, directory: Path, stem: str):
        files = list(directory.glob(stem + ".*"))
        if len(files) != 1:
            raise ValueError(f"expected exactly one file for {stem}: {files}")
        return files[0]

    def _open(self, path, seg_copy: bool, is_mask: bool = False):
        from PIL import Image
        im = Image.open(path)
        eq = (self.spec.equalize_gamma_mask if is_mask
              else self.spec.equalize_gamma)
        if seg_copy and eq:
            im = _equalize_gamma(im)
        return im

    def __getitem__(self, idx: int):
        from PIL import Image
        name = self.ids[idx]
        img_file = self._find(self.images_dir, name)
        mask_file = self._find(self.masks_dir, name + self.mask_suffix)
        size = (self.spec.image_size, self.spec.image_size)
        mask_resample = (Image.NEAREST if self.spec.mask_nearest
                         else Image.BICUBIC)

        def img_arr(im):
            im = im.convert("RGB" if self.spec.rgb else "L").resize(size)
            a = np.asarray(im, dtype=np.float32)
            if self.spec.image_norm == "minmax":
                a = (a - a.min()) / max(a.max() - a.min(), 1e-12)
            else:
                a = a / 255.0
            return a[..., None] if a.ndim == 2 else a

        def mask_arr(im):
            im = im.convert("L").resize(size, resample=mask_resample)
            a = np.asarray(im)
            if self.spec.mask_policy == "binary_gt0":
                m = (a > 0).astype(np.int32)
            elif self.spec.mask_policy == "ids" or self.spec.classes > 1:
                m = np.asarray(a, dtype=np.int32)  # raw label ids, no /255
            else:
                m = (a.astype(np.float32) / 255.0).astype(np.int32)
            return m[..., None]

        return {
            "image": img_arr(self._open(img_file, seg_copy=True)),
            "mask": mask_arr(self._open(mask_file, seg_copy=True,
                                        is_mask=True)),
            "image_pix2pix": img_arr(self._open(img_file, seg_copy=False)),
            "mask_pix2pix": mask_arr(self._open(mask_file, seg_copy=False,
                                                is_mask=True)),
        }


def make_dataset(name: str, root: str, mask_suffix: str = "",
                 images_sub: str = "Images", masks_sub: str = "Masks",
                 image_size: int | None = None):
    """The folder families of DATASET_SPECS (any other name takes the
    default spec, as in the JAX package), ``<root>/Images`` and
    ``<root>/Masks``; ``image_size`` overrides the spec's. The in-memory
    and BBDM families are not ported yet and raise."""
    key = name.lower()
    if key.startswith("bbdm_"):
        raise NotImplementedError(
            f"dataset {name!r}: the BBDM families come with ROADMAP.md "
            "section 1 item 10")
    if key in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md section 1 item "
            f"{UNPORTED_FAMILIES[key]})")
    spec = DATASET_SPECS.get(key, DatasetSpec())
    if image_size and image_size != spec.image_size:
        spec = replace(spec, image_size=image_size)
    return PairedImageFolder(os.path.join(root, images_sub),
                             os.path.join(root, masks_sub),
                             mask_suffix=mask_suffix, spec=spec)
