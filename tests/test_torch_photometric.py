"""The port's photometric ops (``ops/photometric.py``, the ISIC ``fake_trans``
chain) against the JAX package's, on numpy-seeded uint8 batches at C = 1
and C = 3 (one plane constant, so autocontrast's flat case runs):

- posterize, autocontrast, saturation: bit for bit;
- sharpness: bit for bit but for the pixels whose float32 blend lies
  within 1e-3 of a half level (the test names them from the port's float
  blend): the 3x3 sum is taken in another order than XLA's convolution,
  so such a pixel may round to the neighbouring level. Those pixels may
  differ by one level; the count is printed (``-s``);
- ``random_photometric``, batch coins and ``per_image``, with the JAX
  draws injected (the three coins and the saturation factor of
  ``jax.random.split(rng, 4)``): bit for bit with the JAX sharpness
  substituted into the port's chain (so only the composition is tested),
  and without it bit for bit outside the planes that hold a named pixel.
  Over the keys each coin takes both values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.ops import photometric as jp
from semantic_segmentation_torch.ops import photometric as tp

KEYS = range(12)


def _images(c: int, seed: int = 0, shape=(2, 33, 40)):
    rng = np.random.default_rng(seed + 10 * c)
    x = rng.integers(0, 256, shape + (c,), dtype=np.uint8)
    x[1, ..., -1] = 77                       # a flat plane
    x[0, :8] = (x[0, :8] // 37 * 37).astype(np.uint8)   # runs of levels
    return x


def _named(x: np.ndarray, factor: float = 0.3) -> np.ndarray:
    """The pixels whose float32 sharpness blend is within 1e-3 of a half
    level."""
    out = tp.sharpen_f32(torch.from_numpy(x), factor).numpy()
    return np.abs(out - np.floor(out) - 0.5) < 1e-3


@pytest.mark.parametrize("c", [1, 3])
def test_pointwise_ops_bit_exact(c):
    x = _images(c)
    for name in ("posterize_uint8", "autocontrast_uint8"):
        want = np.asarray(getattr(jp, name)(jnp.asarray(x)))
        got = getattr(tp, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    for f in (0.5, 0.73, 1.2, 1.49):
        want = np.asarray(jp.adjust_saturation_uint8(jnp.asarray(x),
                                                     jnp.float32(f)))
        got = tp.adjust_saturation_uint8(
            torch.from_numpy(x), torch.tensor(f, dtype=torch.float32)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"saturation {f}")


@pytest.mark.parametrize("c", [1, 3])
def test_sharpness_within_one_level_on_named_pixels(c):
    diffs, named_total = 0, 0
    for seed in range(4):
        x = _images(c, seed)
        want = np.asarray(jp.adjust_sharpness_uint8(jnp.asarray(x), 0.3))
        got = tp.adjust_sharpness_uint8(torch.from_numpy(x), 0.3).numpy()
        named = _named(x)
        gap = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (gap[~named] == 0).all(), np.argwhere(gap * ~named)[:5]
        assert gap.max() <= 1
        diffs += int((gap > 0).sum())
        named_total += int(named.sum())
    print(f"sharpness C={c}: {diffs} pixels one level apart, all among "
          f"{named_total} named of {4 * x.size}")


def _jax_draws(key, n: int, per_image: bool):
    """The draws ``jp.random_photometric(key, ...)`` makes, as the port
    takes them."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    shape = (n,) if per_image else ()
    coins = [np.array(jax.random.bernoulli(k, 0.5, shape=shape))
             for k in (k1, k2, k3)]
    sat = np.array(jax.random.uniform(k4, shape=shape, minval=0.5,
                                      maxval=1.5))
    return {"coins": torch.from_numpy(np.stack(coins)),
            "saturation": torch.from_numpy(sat)}


def _jax_sharpness(img_u8, factor):
    return torch.from_numpy(np.array(jp.adjust_sharpness_uint8(
        jnp.asarray(img_u8.numpy()), factor)))


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("c", [1, 3])
def test_random_photometric_with_jax_draws(c, per_image, monkeypatch):
    x = _images(c, 5)
    seen = set()
    outside = 0
    for k in KEYS:
        key = jax.random.key(100 + k)
        want = np.asarray(jp.random_photometric(key, jnp.asarray(x),
                                                per_image=per_image))
        draws = _jax_draws(key, x.shape[0], per_image)
        seen.update((i, bool(v)) for i, col in enumerate(draws["coins"])
                    for v in np.atleast_1d(col.numpy()))
        got = tp.random_photometric(torch.from_numpy(x), draws=draws,
                                    per_image=per_image).numpy()
        # planes holding a pixel whose sharpening may round either way
        # (named on the posterized, maybe equalized input of the sharpen)
        coin0 = draws["coins"][0].numpy().reshape((-1, 1, 1, 1))
        pre = np.where(coin0, tp.equalize_uint8(torch.from_numpy(x)).numpy(),
                       x)
        pre = tp.posterize_uint8(torch.from_numpy(pre), 4).numpy()
        coin1 = np.broadcast_to(draws["coins"][1].numpy().reshape(
            (-1, 1, 1, 1)), pre.shape)
        risky = (_named(pre) & coin1).any(axis=(1, 2), keepdims=True)
        if c == 3:           # saturation mixes the channels of a pixel
            risky = risky.any(axis=3, keepdims=True)
        risky = np.broadcast_to(risky, x.shape)
        np.testing.assert_array_equal(got[~risky], want[~risky])
        outside += int((got != want).sum())
        with monkeypatch.context() as m:
            m.setattr(tp, "adjust_sharpness_uint8", _jax_sharpness)
            got = tp.random_photometric(torch.from_numpy(x), draws=draws,
                                        per_image=per_image).numpy()
        np.testing.assert_array_equal(got, want)
    assert seen == {(i, v) for i in range(3) for v in (False, True)}
    print(f"random_photometric C={c} per_image={per_image}: {outside} "
          "pixels apart, all in planes with a named pixel")


def test_draws_from_generator_are_reproducible():
    x = torch.from_numpy(_images(3))
    a = tp.random_photometric(x, torch.Generator().manual_seed(4))
    b = tp.random_photometric(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.dtype == torch.uint8
    d = tp.draw_photometric(5, True, torch.Generator().manual_seed(0))
    assert d["coins"].shape == (3, 5) and d["saturation"].shape == (5,)
    assert ((d["saturation"] >= 0.5) & (d["saturation"] < 1.5)).all()
