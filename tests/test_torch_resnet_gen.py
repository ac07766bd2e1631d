"""The port's ResNet generator and pixel discriminator against the JAX
package's, at ngf = ndf = 4, 32^2, f32, on bridged weights, as
``tests/test_torch_nets.py`` holds the flagship's nets:

- ``ResnetGenerator`` with 6 and 9 blocks, dropout on (the JAX package's
  keep-masks injected, keyed by block): eval and train forward, parameter
  gradients, BN running stats;
- ``PixelDiscriminator``: the same checks;
- two ``Pix2Pix.train_step``s at ``output_nc`` 3 with ``resnet_6blocks``
  and the pixel discriminator, dropout masks injected, within the
  tolerances of ``tests/test_torch_pix2pix.py``;
- ``define_G``/``define_D`` dispatch and parameter counts.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.pix2pix.model import Pix2Pix as JPix2Pix
from semantic_segmentation_tpu.models.pix2pix.networks import (
    ResnetBlock as JResnetBlock, define_D as jdefine_D,
    define_G as jdefine_G)
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.models.pix2pix.networks import (
    PixelDiscriminator, ResnetGenerator, define_D, define_G)
from semantic_segmentation_torch.utils.bridge import load_flax
from tests.test_torch_nets import _check_net, _nchw
from tests.test_torch_pix2pix import LR, ARCH_LR, _check_losses, _compare_state


def _gen():
    """An explicit generator for the port's init (overwritten by the
    bridged weights): the global one stays untouched."""
    return torch.Generator().manual_seed(0)


def _resnet_dropout_masks(module, variables, x, rng):
    """{block index: keep-mask (NCHW)} of the flax Dropout layers of one
    train-mode G forward: each Dropout is fed ones in place of its input
    (its inputs are ReLU outputs, which may be 0), so (output != 0) is its
    mask. A mask depends on the key and the shape only; the forward's
    values are not used."""
    masks = {}

    def record(next_fun, args_, kwargs, context):
        if not isinstance(context.module, fnn.Dropout):
            return next_fun(*args_, **kwargs)
        block = context.module.parent
        assert isinstance(block, JResnetBlock)
        out = next_fun(jnp.ones_like(args_[0]), *args_[1:], **kwargs)
        masks[int(block.name[len("res"):])] = _nchw(np.asarray(out != 0))
        return out

    with fnn.intercept_methods(record):
        module.apply(variables, x, train=True, rngs={"dropout": rng},
                     mutable=["batch_stats"])
    return masks


@pytest.mark.parametrize("netG,blocks", [("resnet_6blocks", 6),
                                         ("resnet_9blocks", 9)])
def test_resnet_generator(netG, blocks):
    jg = jdefine_G(1, netG, 4, "batch", True, jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    variables = jg.init(jax.random.key(0), jnp.asarray(x))
    rng = jax.random.key(5)
    masks = _resnet_dropout_masks(jg, variables, jnp.asarray(x), rng)
    assert set(masks) == set(range(blocks))
    tg = define_G(1, 1, netG, 4, True, _gen())
    assert isinstance(tg, ResnetGenerator) and tg.n_blocks == blocks
    _check_net(jg, variables, tg, jnp.asarray(x),
               t_kwargs_fn=lambda: {"dropout_masks": masks}, rng=rng)


def test_pixel_discriminator():
    jd = jdefine_D("pixel", 4, 3, "batch", jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 4)).astype(
        np.float32)
    variables = jd.init(jax.random.key(2), jnp.asarray(x))
    td = define_D(4, "pixel", 4, generator=_gen())
    assert isinstance(td, PixelDiscriminator)
    _check_net(jd, variables, td, jnp.asarray(x))


@pytest.mark.parametrize("netD,n_layers", [("basic", 3), ("n_layers", 3),
                                           ("pixel", 0)])
def test_define_d_dispatch_and_counts(netD, n_layers):
    jd = jdefine_D(netD, 4, n_layers or 3, "batch", jnp.float32)
    params = jax.eval_shape(lambda: jd.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 4))))["params"]
    n_j = sum(int(np.prod(v.shape))
              for v in jax.tree_util.tree_leaves(params))
    td = define_D(4, netD, 4, n_layers or 3, _gen())
    assert sum(p.numel() for p in td.parameters()) == n_j
    with pytest.raises(NotImplementedError):
        define_D(4, "nonesuch")
    with pytest.raises(NotImplementedError):
        define_G(1, 1, "resnet_12blocks")


def test_resnet_generator_ignores_arch_and_keeps_size():
    g = define_G(1, 3, "resnet_6blocks", 4, True,
                 torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, 1, 36, 44, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = g(x)
        b = g(x, torch.ones(8, 3))
    assert a.shape == (1, 3, 36, 44) and torch.equal(a, b)


def test_two_train_steps_at_output_nc3_with_dropout():
    size, nf = 32, 4
    jm = JPix2Pix(input_nc=1, output_nc=3, ngf=nf, ndf=nf,
                  netG="resnet_6blocks", netD="pixel", use_dropout=True,
                  lr=LR, arch_lr=ARCH_LR, compute_dtype=jnp.float32)
    state = jm.init(jax.random.key(3), image_size=size)
    tm = Pix2Pix(1, 3, nf, nf, "resnet_6blocks", "pixel", use_dropout=True,
                 lr=LR, arch_lr=ARCH_LR, generator=_gen())
    load_flax(tm.G, jax.device_get(state.g_params),
              jax.device_get(state.g_stats))
    load_flax(tm.D, jax.device_get(state.d_params),
              jax.device_get(state.d_stats))
    rng_np = np.random.default_rng(4)
    gaps = {}
    for i in range(2):
        b = {"mask_pix2pix": (rng_np.random((2, size, size, 1)) > 0.6)
             .astype(np.float32),
             "image_pix2pix": rng_np.random((2, size, size, 3))
             .astype(np.float32)}
        key = jax.random.key(i + 20)
        draws = tuple(
            _resnet_dropout_masks(jm.G, {"params": state.g_params,
                                         "batch_stats": state.g_stats},
                                  jnp.asarray(b["mask_pix2pix"]), r)
            for r in jax.random.split(key))
        state, mj = jm.train_step(state, b, key)
        mt = tm.train_step({k: torch.from_numpy(v) for k, v in b.items()},
                           dropout_masks=draws)
        _check_losses(mj, mt, i, gaps)
    state_gaps = _compare_state(tm, state)
    print("resnet_6blocks + pixel D, output_nc 3: relative loss gaps",
          {k: f"{v:.2e}" for k, v in gaps.items()},
          "| after two steps (gap, sign-noise elements)", state_gaps)
