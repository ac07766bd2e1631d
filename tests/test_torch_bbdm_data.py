"""The port's BBDM dataset families (``data/extra.py`` and the ``bbdm_*``
branches of ``data/folder.make_dataset``) against the JAX package's, bit
for bit, on PNG and JPEG files the test writes: ``bbdm_single``,
``bbdm_colorization_rgb``, ``bbdm_colorization_lab``, ``bbdm_inpainting``
(one image folder, ``root/Images`` or ``root`` itself) and
``bbdm_aligned`` (the paired layout, RGB); the LAB conversions; an
unknown variant refused alike."""
import numpy as np
import pytest
from PIL import Image

from semantic_segmentation_tpu.data import extra as jextra
from semantic_segmentation_tpu.data.folder import make_dataset as jmake
from semantic_segmentation_torch.data import extra as textra
from semantic_segmentation_torch.data.folder import make_dataset

FAMILIES = ["bbdm_single", "bbdm_colorization_rgb", "bbdm_colorization_lab",
            "bbdm_inpainting", "bbdm_aligned"]


def write_images(root, n: int = 3, seed: int = 0, masks: bool = False):
    """``n`` RGB images of odd sizes (the loaders resize) under
    ``root/Images``, PNG and JPEG, and with ``masks`` their binary masks
    under ``root/Masks``."""
    rng = np.random.default_rng(seed)
    (root / "Images").mkdir(parents=True, exist_ok=True)
    if masks:
        (root / "Masks").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = 30 + 3 * i, 41 - 2 * i
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ext = "jpg" if i == 1 else "png"
        Image.fromarray(img, "RGB").save(root / "Images" / f"im{i}.{ext}")
        if masks:
            m = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
            Image.fromarray(m, "L").save(root / "Masks" / f"im{i}.png")
    return root


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("size", [32, 256])
def test_bbdm_family_bit_for_bit(name, size, tmp_path):
    root = write_images(tmp_path / "d", masks=name == "bbdm_aligned")
    ref = jmake(name, str(root), image_size=size)
    got = make_dataset(name, str(root), image_size=size)
    assert len(got) == len(ref) == 3
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    assert ref[0]["image_pix2pix"].shape[:2] == (size, size)


def test_single_folder_without_images_sub(tmp_path):
    root = write_images(tmp_path / "d")
    flat = tmp_path / "flat"
    (root / "Images").rename(flat)
    got = make_dataset("bbdm_single", str(flat), image_size=16)
    ref = jmake("bbdm_single", str(flat), image_size=16)
    np.testing.assert_array_equal(got[2]["image_pix2pix"],
                                  ref[2]["image_pix2pix"])


def test_lab_conversions():
    rgb = np.random.default_rng(1).integers(0, 256, (2, 9, 7, 3),
                                            dtype=np.uint8)
    lab = textra.rgb_to_lab_u8(rgb)
    np.testing.assert_array_equal(lab, jextra.rgb_to_lab_u8(rgb))
    lab01 = lab.astype(np.float32) / 255.0
    np.testing.assert_array_equal(textra.lab_to_rgb(lab01),
                                  jextra.lab_to_rgb(lab01))


def test_unknown_variant(tmp_path):
    for make in (jmake, make_dataset):
        with pytest.raises(ValueError, match="unknown BBDM dataset"):
            make("bbdm_sketch", str(tmp_path))
