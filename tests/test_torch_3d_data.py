"""The port's GenSeg-3D data layer against the JAX package's, bit for bit:

- NIfTI files written by one package read the same in the other (uint8,
  int16 with ``scl_slope``, float32, ``.nii`` and ``.nii.gz``);
- ``NiftiPairedDataset`` items on a folder written here (volumes larger and
  smaller than the crop, with and without truths, the random flips, the
  ``sliced`` 2D mode) and ``SyntheticVolumeDataset`` items are equal;
- the transforms ``crop_or_pad``, ``rescale_intensity``,
  ``pad_to_divisible`` and ``normalize_intensity_nonzero`` are equal;
- ``volume_metrics`` and ``ssim`` agree to 1e-6, and ``write_metrics_csv``
  writes the same file."""
import os
import struct

import numpy as np
import pytest

from semantic_segmentation_tpu.data import nifti as jnifti
from semantic_segmentation_tpu.data import volume as jvolume
from semantic_segmentation_tpu.ops import gen_metrics as jgen
from semantic_segmentation_torch.data import nifti, volume
from semantic_segmentation_torch.ops import gen_metrics


def _with_slope(path, slope):
    """Set ``scl_slope`` of a written NIfTI-1 file (uncompressed)."""
    with open(path, "r+b") as f:
        f.seek(112)
        f.write(struct.pack("<f", slope))


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32"])
def test_nifti_cross_package(tmp_path, ext, dtype):
    rng = np.random.default_rng(0)
    vol = (rng.normal(size=(7, 9, 5)) * 50).astype(dtype)
    affine = np.diag([1.5, 2.0, 2.5, 1.0])
    for i, (writer, reader) in enumerate(((jnifti, nifti), (nifti, jnifti))):
        p = str(tmp_path / f"v{i}{ext}")
        writer.write_nifti(p, vol, affine)
        a, aff_a = reader.read_nifti(p)
        b, aff_b = writer.read_nifti(p)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(aff_a, aff_b)
        assert np.array_equal(a, vol)
    with open(str(tmp_path / f"v0{ext}"), "rb") as f0, \
            open(str(tmp_path / f"v1{ext}"), "rb") as f1:
        if ext == ".nii":
            assert f0.read() == f1.read()


def test_nifti_int16_scl_slope(tmp_path):
    vol = np.arange(-30, 30, dtype=np.int16).reshape(3, 4, 5)
    p = str(tmp_path / "s.nii")
    jnifti.write_nifti(p, vol)
    _with_slope(p, 2.0)
    a, _ = nifti.read_nifti(p)
    b, _ = jnifti.read_nifti(p)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b) and np.array_equal(a, vol * 2.0)


def _write_folder(root, shapes, truths, seed=0):
    rng = np.random.default_rng(seed)
    for d in ("imgsA", "imgsB", "truths"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, shape in enumerate(shapes):
        a = rng.integers(0, 400, size=shape).astype(np.int16)
        b = (rng.normal(size=shape) * 100).astype(np.float32)
        ext = ".nii.gz" if i % 2 else ".nii"
        jnifti.write_nifti(os.path.join(root, "imgsA", f"v{i}{ext}"), a)
        jnifti.write_nifti(os.path.join(root, "imgsB", f"v{i}{ext}"), b)
        if i in truths:
            t = (rng.random(shape) > 0.8).astype(np.uint8)
            jnifti.write_nifti(os.path.join(root, "truths", f"v{i}{ext}"), t)


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("sliced", [False, True], ids=["3d", "sliced"])
def test_nifti_paired_dataset_items_equal(tmp_path, sliced):
    root = str(tmp_path / "vols")
    # larger and smaller than the crop on different axes; truths for some
    _write_folder(root, [(20, 12, 18), (10, 22, 16), (16, 16, 16),
                         (24, 9, 17)], truths={0, 2})
    kw = dict(crop_size=16, seed=3, sliced=sliced, chosen_slice=4,
              image_size=24)
    ds_t = volume.NiftiPairedDataset(root, **kw)
    ds_j = jvolume.NiftiPairedDataset(root, **kw)
    assert len(ds_t) == len(ds_j) == 4
    for i in range(4):
        _assert_items_equal(ds_t[i], ds_j[i])
        shape = (24, 24, 1) if sliced else (16, 16, 16, 1)
        assert ds_t[i]["A"].shape == shape


def test_synthetic_volumes_equal():
    ds_t = volume.SyntheticVolumeDataset(n=3, size=16, seed=5)
    ds_j = jvolume.SyntheticVolumeDataset(n=3, size=16, seed=5)
    for i in range(3):
        _assert_items_equal(ds_t[i], ds_j[i])


def test_volume_transforms_equal():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(6, 9, 5)).astype(np.float32)
    for fn in ("rescale_intensity", "normalize_05"):
        assert np.array_equal(getattr(volume, fn)(v),
                              getattr(jvolume, fn)(v))
    for t in (4, 8):
        assert np.array_equal(volume.crop_or_pad(v, t),
                              jvolume.crop_or_pad(v, t))
    assert np.array_equal(volume.pad_to_divisible(v, 4),
                          jvolume.pad_to_divisible(v, 4))
    z = np.where(v > 0, v, 0.0)
    assert np.array_equal(volume.normalize_intensity_nonzero(z),
                          jvolume.normalize_intensity_nonzero(z))


def test_volume_metrics_and_csv(tmp_path):
    rng = np.random.default_rng(6)
    fake = rng.random((12, 10, 9, 1)).astype(np.float32) * 2 - 1
    real = rng.random((12, 10, 9, 1)).astype(np.float32) * 2 - 1
    mask = (rng.random((12, 10, 9, 1)) > 0.3).astype(np.float32)
    for m in (mask, None):
        a = gen_metrics.volume_metrics(fake, real, mask=m)
        b = jgen.volume_metrics(fake, real, mask=m)
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(b[k])), k
    assert abs(gen_metrics.ssim(fake[..., 0], real[..., 0])
               - jgen.ssim(fake[..., 0], real[..., 0])) <= 1e-6
    rows = [{"volume": i, **gen_metrics.volume_metrics(fake, real, mask)}
            for i in range(2)]
    gen_metrics.write_metrics_csv(rows, str(tmp_path / "t.csv"))
    jgen.write_metrics_csv(rows, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
