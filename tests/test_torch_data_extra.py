"""The port's in-memory dataset families (``data/extra.py``) against the JAX
package's on the same fixture files, array for array and bit for bit (the
same PIL resizes): B. subtilis, omnipose, diabetic, DeePiCt (both splits)
and the NIfTI slices, each at train and eval sizing, and the
``make_dataset`` dispatch of their seven keys. The fixtures are those of
``tests/test_data_extra.py``, written with PIL, pickle and the port's
``write_nifti``."""
import pickle

import numpy as np
import pytest
from PIL import Image

from semantic_segmentation_torch.data import extra
from semantic_segmentation_torch.data.folder import make_dataset
from semantic_segmentation_torch.data.nifti import write_nifti
from semantic_segmentation_tpu.data import extra as jextra
from semantic_segmentation_tpu.data.folder import make_dataset as jmake

KEYS = ("b_subtilis", "bsubtilis", "omnipose", "diabetic", "deepict",
        "deepict_test", "nib")


def _write_gray(path, arr):
    Image.fromarray(np.asarray(arr).astype(np.uint8), "L").save(path)


def write_family(name: str, root, size=(40, 48)):
    """A small fixture of family ``name`` under ``root``; the path that
    ``make_dataset`` takes for it."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w = size
    if name in ("b_subtilis", "bsubtilis"):
        (root / "source").mkdir()
        (root / "target_boundaries").mkdir()
        for i in range(3):
            _write_gray(root / "source" / f"f{i}.png",
                        rng.integers(0, 255, (h, w)))
            m = np.zeros((h, w))
            m[5:20, 5:20] = 2
            _write_gray(root / "target_boundaries" / f"f{i}.png", m)
        return root
    if name == "omnipose":
        for i in range(2):
            _write_gray(root / f"s{i}_img.tif", rng.integers(10, 250, (h, w)))
            _write_gray(root / f"s{i}_masks.tif",
                        (rng.random((h, w)) > 0.5) * 200.0)
        return root
    if name == "diabetic":
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                root / f"d{i}_img.jpg")
            _write_gray(root / f"d{i}.png", (rng.random((h, w)) > 0.7) * 255.0)
        return root
    if name.startswith("deepict"):
        d = {"train_features": rng.random((4, h, w, 1)).astype(np.float32),
             "train_labels": (rng.random((4, h, w, 1)) > 0.5).astype(
                 np.float32),
             "test_features": rng.random((2, h, w, 1)).astype(np.float32),
             "test_labels": (rng.random((2, h, w, 1)) > 0.5).astype(
                 np.float32)}
        path = root / "deepict.pkl"
        with open(path, "wb") as f:
            pickle.dump(d, f)
        return path
    if name == "nib":
        (root / "Images").mkdir()
        (root / "Masks").mkdir()
        for i in range(2):
            write_nifti(str(root / "Images" / f"v{i}.nii.gz"),
                        rng.normal(size=(h, w, 1)).astype(np.float32))
            write_nifti(str(root / "Masks" / f"v{i}.nii.gz"),
                        rng.integers(0, 3, (h, w, 1)).astype(np.float32))
        return root
    raise ValueError(name)


def assert_same_items(got, ref):
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert set(a) == set(b) == {"image", "mask"}
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("family", ["BSubtilisDataset", "OmniposeDataset",
                                    "DiabeticDataset", "DeePiCtDataset"])
def test_array_families_match_jax(family, train, tmp_path):
    name = {"BSubtilisDataset": "b_subtilis", "OmniposeDataset": "omnipose",
            "DiabeticDataset": "diabetic",
            "DeePiCtDataset": "deepict"}[family]
    path = str(write_family(name, tmp_path / name))
    got = getattr(extra, family)(path, img_size=32, train=train)
    ref = getattr(jextra, family)(path, img_size=32, train=train)
    assert_same_items(got, ref)
    assert got[0]["image"].shape[:2] == (32, 32)


def test_nib_slices_match_jax(tmp_path):
    root = write_family("nib", tmp_path / "nib")
    args = (str(root / "Images"), str(root / "Masks"))
    got, ref = extra.NibSliceDataset(*args), jextra.NibSliceDataset(*args)
    assert got.ids == ref.ids
    assert_same_items(got, ref)
    assert set(np.unique(got[0]["mask"])) <= {0, 1, 2}   # raw ids


@pytest.mark.parametrize("key", KEYS)
def test_make_dataset_routes_the_in_memory_keys(key, tmp_path):
    path = str(write_family(key, tmp_path / key))
    got, ref = make_dataset(key, path), jmake(key, path)
    assert type(got).__name__ == type(ref).__name__
    assert_same_items(got, ref)


def test_train_unet_from_a_pickle(tmp_path):
    # the family feeds train_unet through load_splits: finite losses
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_unet
    path = write_family("deepict", tmp_path / "d", size=(36, 36))
    cfg = parse_config([
        "--data.dataset=deepict", f"--data.dataroot={path}",
        "--data.image_size=32", "--data.n_train=2", "--data.n_val=1",
        "--data.n_test=1", "--model.base_features=8",
        "--model.compute_dtype=float32", "--engine.valid_step=1",
        "--run.device=cpu", f"--run.save_dir={tmp_path}"])
    _, results = train_unet.train(cfg, train_iters=2)
    assert all(np.isfinite(r["loss"]) for r in results["log"])
    assert 0.0 <= results["test_dice"] <= 1.0
