"""The port's 256-bin histogram against the JAX package's
(``ops/pallas_kernels.py``): ``histogram256_ref`` bit for bit against
``histogram256_jnp``, against ``histogram256_pallas`` in interpret mode and
against ``np.bincount``, including two-value images, H*W off multiples of
16 and the channel planes of an RGB batch. On the CPU ``histogram256`` runs
its plain version and counts no kernel launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.ops.pallas_kernels import (histogram256_jnp,
                                                          histogram256_pallas)
from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.ops import image as timg


def _images(family: str) -> np.ndarray:
    rng = np.random.default_rng(9)
    if family == "random_3x32":
        return rng.integers(0, 256, (3, 32, 32), dtype=np.uint8)
    if family == "random_2x16":
        return rng.integers(0, 256, (2, 16, 16), dtype=np.uint8)
    if family == "constant":
        return np.full((2, 16, 16), 201, np.uint8)
    if family == "odd_size":            # H*W not a multiple of 4
        return rng.integers(0, 256, (2, 7, 9), dtype=np.uint8)
    if family == "two_value":
        return np.where(rng.random((2, 16, 16)) < 0.3, 10,
                        200).astype(np.uint8)
    if family == "odd_16":              # H*W = 65, not a multiple of 16
        return rng.integers(0, 256, (3, 5, 13), dtype=np.uint8)
    if family == "rgb_planes":          # c = 3: each channel plane an image
        rgb = rng.integers(0, 256, (2, 16, 8, 3), dtype=np.uint8)
        return np.ascontiguousarray(rgb.transpose(0, 3, 1, 2).reshape(
            6, 16, 8))
    raise KeyError(family)


FAMILIES = ("random_3x32", "random_2x16", "constant", "odd_size",
            "two_value", "odd_16", "rgb_planes")


def _bincount(x: np.ndarray) -> np.ndarray:
    return np.stack([np.bincount(p.ravel(), minlength=256) for p in x])


@pytest.mark.parametrize("family", FAMILIES)
def test_histogram_ref_bit_exact_against_jnp_and_numpy(family):
    x = _images(family)
    ref = np.asarray(histogram256_jnp(jnp.asarray(x)))
    kernels.reset_launches()
    out = timg.histogram256(torch.from_numpy(x))
    assert out.dtype == torch.int32 and out.shape == (x.shape[0], 256)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), _bincount(x))
    np.testing.assert_array_equal(
        timg.histogram256_ref(torch.from_numpy(x)).numpy(), ref)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert kernels.LAUNCHES["histogram256"] == 0


@pytest.mark.parametrize("family", ["random_2x16", "constant", "two_value",
                                    "odd_16", "rgb_planes"])
def test_histogram_ref_bit_exact_against_pallas_interpret(family):
    x = _images(family)
    ref = np.asarray(histogram256_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        timg.histogram256_ref(torch.from_numpy(x)).numpy(), ref)


def test_histogram_constant_plane_has_one_bin():
    out = timg.histogram256(torch.from_numpy(_images("constant"))).numpy()
    assert (out[:, 201] == 256).all() and out.sum() == 2 * 256


@pytest.mark.parametrize("bad", [torch.zeros(2, 4, 4),
                                 torch.zeros(2, 4, 4, 1, dtype=torch.uint8)])
def test_histogram_rejects_other_inputs(bad):
    with pytest.raises(ValueError):
        timg.histogram256(bad)
