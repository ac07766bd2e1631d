"""The weight bridge: the JAX package's params/stats -> the port's modules
(strict load) -> back gives the same pytree, for the generator, the
PatchGAN, the U-Net and the arch tables."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semantic_segmentation_tpu.models.pix2pix.networks import (
    define_D as jdefine_D, define_G as jdefine_G)
from semantic_segmentation_tpu.models.unet import UNet as JUNet
from semantic_segmentation_tpu.ops.nas import init_arch_params
from semantic_segmentation_torch.models.pix2pix.networks import (define_D,
                                                                 define_G)
from semantic_segmentation_torch.models.unet import UNet
from semantic_segmentation_torch.utils.bridge import (arch_to_flax,
                                                      arch_to_torch, load_flax,
                                                      state_dict_to_flax)
from tests.test_torch_sivae_nets import random_variables


def _nets(name):
    arch = init_arch_params(jax.random.key(0))
    if name == "netG":
        return (jdefine_G(1, "unet_32", 4, "batch", True, jnp.float32),
                (jnp.zeros((1, 32, 32, 1)), arch["upconv"]),
                define_G(1, 1, "unet_32", 4, True))
    if name == "netD":
        return (jdefine_D("basic", 4, 3, "batch", jnp.float32),
                (jnp.zeros((1, 32, 32, 2)),), define_D(2, "basic", 4))
    return (JUNet(1, 1, base_features=4, dtype=jnp.float32),
            (jnp.zeros((1, 32, 32, 1)),), UNet(1, 1, 4))


@pytest.mark.parametrize("name", ["netG", "netD", "unet"])
def test_round_trip(name):
    jnet, args, tnet = _nets(name)
    # values drawn from the init's shapes (no flax init is compiled)
    variables = random_variables(jnet, *args, seed=1)
    params = variables["params"]
    # non-trivial running stats, so a mean/var mix-up would show
    stats = jax.tree.map(
        lambda v: np.random.default_rng(v.size).uniform(0.5, 2.0, v.shape)
        .astype(np.float32), variables["batch_stats"])
    load_flax(tnet, params, stats)
    p2, s2 = state_dict_to_flax(tnet, tnet.state_dict())
    for ref, got in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(ref)
                == jax.tree_util.tree_structure(got))
        for a, b in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(got)):
            assert np.asarray(a).shape == b.shape
            np.testing.assert_array_equal(np.asarray(a), b)


def test_arch_round_trip():
    arch = jax.device_get(init_arch_params(jax.random.key(3)))
    back = arch_to_flax(arch_to_torch(arch))
    assert back.keys() == arch.keys()
    for k in arch:
        np.testing.assert_array_equal(back[k], arch[k])
