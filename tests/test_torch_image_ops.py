"""The port's uint8 image ops against the JAX package's (ops/image.py), bit
for bit: the plain equalize (also against ``equalize_uint8_pallas`` in
interpret mode), to_uint8, adjust_gamma on all 256 levels, the whole
fake-image chain and the threshold, on random, constant and two-value
planes, at c = 1 and 3 and at H*W off multiples of 16. On the CPU
``equalize_uint8`` runs its plain PyTorch version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.ops import image as jimg
from semantic_segmentation_tpu.ops.pallas_kernels import equalize_uint8_pallas
from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.ops import image as timg


def _plane_family(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "random":
        return rng.integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
    if name == "random_3ch":
        return rng.integers(0, 256, (2, 12, 10, 3), dtype=np.uint8)
    if name == "narrow":
        return rng.integers(100, 108, (3, 16, 16, 1), dtype=np.uint8)
    if name == "constant":
        return np.full((2, 16, 16, 1), 77, np.uint8)
    if name == "two_value":
        return np.where(rng.random((2, 16, 16, 1)) < 0.3, 10,
                        200).astype(np.uint8)
    if name == "one_outlier":
        x = np.full((1, 16, 16, 1), 5, np.uint8)
        x[0, 3, 4, 0] = 250
        return x
    if name == "two_value_3ch":
        return np.where(rng.random((2, 16, 16, 3)) < 0.3, 10,
                        200).astype(np.uint8)
    if name == "odd_hw":                # H*W = 63, not a multiple of 16
        return rng.integers(0, 256, (3, 7, 9, 1), dtype=np.uint8)
    if name == "odd_hw_3ch":            # H*W*C = 195
        return rng.integers(0, 256, (2, 5, 13, 3), dtype=np.uint8)
    raise KeyError(name)


FAMILIES = ("random", "random_3ch", "narrow", "constant", "two_value",
            "one_outlier", "two_value_3ch", "odd_hw", "odd_hw_3ch")


@pytest.mark.parametrize("family", FAMILIES)
def test_equalize_bit_exact(family):
    x = _plane_family(family)
    ref = np.asarray(jimg.equalize_uint8(jnp.asarray(x), use_pallas=False))
    kernels.reset_launches()
    out = timg.equalize_uint8(torch.from_numpy(x))
    assert out.dtype == torch.uint8 and out.shape == x.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert kernels.LAUNCHES["equalize_uint8"] == 0


@pytest.mark.parametrize("family", ["random_3ch", "two_value_3ch", "odd_hw",
                                    "odd_hw_3ch"])
def test_equalize_bit_exact_against_pallas_interpret(family):
    x = _plane_family(family)
    ref = np.stack([np.asarray(equalize_uint8_pallas(
        jnp.asarray(x[..., ch]), interpret=True))
        for ch in range(x.shape[-1])], axis=-1)
    out = timg.equalize_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("gamma", [0.5, 0.7, 1.5])
def test_adjust_gamma_all_levels_bit_exact(gamma):
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    ref = np.asarray(jimg.adjust_gamma_uint8(jnp.asarray(v), gamma))
    out = timg.adjust_gamma_uint8(torch.from_numpy(v), gamma).numpy()
    np.testing.assert_array_equal(out, ref)


def test_to_uint8_and_minmax_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.2, 1.2, (2, 16, 16, 1)).astype(np.float32)
    # values on and next to the rounding boundaries (k + 0.5) / 255
    edges = ((np.arange(256) - 0.5) / 255.0).astype(np.float32)
    x.reshape(-1)[:256] = edges
    x.reshape(-1)[256:512] = np.nextafter(edges, np.float32(2))
    np.testing.assert_array_equal(
        timg.to_uint8(torch.from_numpy(x)).numpy(),
        np.asarray(jimg.to_uint8(jnp.asarray(x))))
    np.testing.assert_array_equal(
        timg.minmax_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jimg.minmax_normalize(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equalize_gamma_chain_bit_exact(seed):
    rng = np.random.default_rng(seed)
    # generator-like output: tanh of a smooth field plus noise
    x = np.tanh(rng.normal(0, 1.5, (2, 24, 24, 1))).astype(np.float32)
    ref = np.asarray(jimg.equalize_gamma_chain(jnp.asarray(x), 0.5))
    out = timg.equalize_gamma_chain(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(out, ref)


def test_threshold_mask_exact():
    x = np.random.default_rng(3).uniform(0, 0.2, (2, 8, 8, 1)).astype(
        np.float32)
    x.reshape(-1)[:4] = [0.1, np.nextafter(np.float32(0.1), 1), 0.0, 1.0]
    np.testing.assert_array_equal(
        timg.threshold_mask(torch.from_numpy(x)).numpy(),
        np.asarray(jimg.threshold_mask(jnp.asarray(x))))


def test_equalize_rejects_non_uint8():
    with pytest.raises(ValueError):
        timg.equalize_uint8(torch.zeros(1, 4, 4, 1))
