"""The port's folder datasets against the JAX package's: ``make_dataset``
gives the same arrays bit for bit (all four keys, their dtypes) on PNG
fixtures the tests write, for the JSRT family (with a mask suffix, at the
spec's 256 from 300^2 and at a 32 override), ISIC (RGB, NEAREST masks), SE
(``binary_gt0``) and liver3 (mask equalize, min-max images, raw ids);
``load_splits`` gives the same train/val/test/OOD splits, each OOD set at
its family's own size; the families the port does not have yet raise."""
import ast
import pathlib

import numpy as np
import pytest
from PIL import Image

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.folder import make_dataset as jmake
from semantic_segmentation_tpu.train.common import load_splits as jload_splits
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.folder import make_dataset
from semantic_segmentation_torch.train.common import load_splits

KEYS = ("image", "mask", "image_pix2pix", "mask_pix2pix")


def _write_folder(root: pathlib.Path, n: int, size: int, seed: int,
                  rgb: bool = False, suffix: str = "", mask_values=(0, 255)):
    """``n`` random images and blocky masks as PNGs in Images/ and Masks/."""
    (root / "Images").mkdir(parents=True)
    (root / "Masks").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        shape = (size, size, 3) if rgb else (size, size)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        Image.fromarray(img, "RGB" if rgb else "L").save(
            root / "Images" / f"case{i}.png")
        m = np.full((size, size), mask_values[0], np.uint8)
        for v in mask_values[1:]:
            y, x = rng.integers(0, size // 2, 2)
            h, w = rng.integers(size // 8, size // 2, 2)
            m[y:y + h, x:x + w] = v
        Image.fromarray(m, "L").save(root / "Masks" / f"case{i}{suffix}.png")
    return root


FAMILIES = {   # case: (dataset, folder kwargs, image_size override)
    "jsrt_300_to_256": ("jsrt", dict(size=300, suffix="_mask"), None),
    "jsrt_override_32": ("jsrt", dict(size=300, suffix="_mask"), 32),
    "isic_rgb_nearest": ("isic", dict(size=64, rgb=True), None),
    "se_binary_gt0": ("se", dict(size=64, mask_values=(0, 1, 128)), None),
    "liver3_ids": ("liver3", dict(size=64, mask_values=(0, 1, 2)), None),
}


@pytest.mark.parametrize("case", FAMILIES)
def test_make_dataset_matches_jax(case, tmp_path):
    name, kw, size = FAMILIES[case]
    root = _write_folder(tmp_path / name, 3, seed=len(case), **kw)
    suffix = kw.get("suffix", "")
    ref = jmake(name, str(root), suffix, image_size=size)
    got = make_dataset(name, str(root), suffix, image_size=size)
    assert len(got) == len(ref) == 3
    for i in range(3):
        a, b = ref[i], got[i]
        for k in KEYS:
            assert b[k].dtype == a[k].dtype, (case, k)
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{case} {k}")
    want = size or 256
    assert got[0]["image"].shape[:2] == (want, want)


def test_load_splits_matches_jax(tmp_path):
    jsrt = _write_folder(tmp_path / "jsrt", 6, 300, seed=1)
    sz = _write_folder(tmp_path / "sz", 2, 300, seed=2, suffix="_mask")
    nlm = _write_folder(tmp_path / "nlm", 2, 64, seed=3)
    argv = [f"--data.dataroot={jsrt}", "--data.image_size=32",
            "--data.n_train=2", "--data.n_val=1", "--data.n_test=2",
            f"--data.ood_roots=sz:{sz}:_mask,{nlm}"]
    ref, got = jload_splits(jparse(argv)), load_splits(parse_config(argv))
    for split in ("train", "val", "test"):
        for k in KEYS:
            np.testing.assert_array_equal(got[split][k], ref[split][k])
    assert got["train"]["image"].shape == (2, 32, 32, 1)
    assert [n for n, _ in got["ood"]] == [n for n, _ in ref["ood"]] == \
        ["sz", "jsrt"]
    for (_, a), (_, b) in zip(ref["ood"], got["ood"]):
        for k in KEYS:
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k])
        assert b["image"].shape == (2, 256, 256, 1)   # the spec's size


@pytest.mark.parametrize("name", ["deepict", "deepict_test", "nib",
                                  "b_subtilis", "omnipose", "diabetic",
                                  "bbdm_single", "bbdm_aligned",
                                  "pix2pix_colorization"])
def test_unported_families_raise(name, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_dataset(name, str(tmp_path))


def test_stem_must_match_one_file(tmp_path):
    root = _write_folder(tmp_path / "jsrt", 1, 32, seed=4)
    Image.fromarray(np.zeros((32, 32), np.uint8), "L").save(
        root / "Masks" / "case0.bmp")
    with pytest.raises(AssertionError, match="exactly one file"):
        jmake("jsrt", str(root))[0]
    with pytest.raises(ValueError, match="exactly one file"):
        make_dataset("jsrt", str(root))[0]


def test_pil_is_imported_lazily():
    # the package must import where PIL is absent: no module-level import
    src = pathlib.Path(__file__).resolve().parents[1] / \
        "semantic_segmentation_torch"
    for path in src.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] == "PIL" for n in names), path
