"""The port's GenSeg-3D nets against the JAX package's, the two heavier
cases of ``tests/test_torch_3d_nets.py`` (its helpers and tolerances):

- the nd-6 generator (64^3, ngf 2, instance norm) with the JAX package's
  dropout keep-mask injected;
- ``UNet3D`` at base 4 (16^3), with the shared BN's statistics (folded
  twice).

Where f32 conditioning dominates, float64 on both sides, as each test
states."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_segmentation_tpu.models.pix2pix.networks3d import \
    UnetGenerator3D as JG3
from semantic_segmentation_tpu.models.unet3d import UNet3D as JUNet3D
from semantic_segmentation_torch.models.pix2pix.networks3d import \
    UnetGenerator3D
from semantic_segmentation_torch.models.unet3d import UNet3D
from semantic_segmentation_torch.utils.bridge import load_flax
from tests.test_torch_3d_nets import (  # noqa: F401 (the autouse fixture)
    FWD, _arch, _check, _native_cpu_conv3d, _normed, _rel, _to_np, _to_torch)


def _train_with_masks(jg, variables, x, arch, rng):
    """The JAX generator's train-mode output and its dropout keep-masks
    ({depth: mask}, as ``_dropout_masks`` records them), in one jitted
    call."""
    def run(v, x_, a_):
        masks = {}

        def record(next_fun, args_, kwargs, context):
            out = next_fun(*args_, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                masks[int(context.module.name[len("dropout"):])] = out != 0
            return out

        with fnn.intercept_methods(record):
            y, _ = jg.apply(v, x_, a_, train=True, rngs={"dropout": rng},
                            mutable=["batch_stats"])
        return y, masks

    y, masks = jax.jit(run)(variables, jnp.asarray(x), jnp.asarray(arch))
    return np.asarray(y), {d: np.asarray(m) for d, m in masks.items()}


def test_generator3d_nd6_dropout_mask_injected():
    """At nd 6 the instance norms of down_bn4 and up_bn5 normalize 2^3
    voxels a channel, and in f32 the JAX package's own forward lies as far
    from its float64 forward as the port's does (both printed; the port's
    f32 gap is held to 4x the JAX package's). So the eval and train-mode
    forwards (the JAX keep-mask injected) are held in float64 on both
    sides, and the gradients in f32 (XLA:CPU's jitted float64 backward of
    this net crashes)."""
    nd, ngf, size = 6, 2, 64
    x = np.random.default_rng(1).normal(size=(1, size, size, size, 1))
    arch = _arch(nd, 2).astype(np.float64)
    jg = JG3(1, nd, ngf, "linear", True, "instance", dtype=jnp.float32)
    x32, a32 = x.astype(np.float32), arch.astype(np.float32)
    v32 = jax.jit(jg.init)(jax.random.key(3), jnp.asarray(x32), a32)
    rng = jax.random.key(9)
    _, masks = _train_with_masks(jg, v32, x32, a32, rng)
    assert set(masks) == {4}                     # 4 <= d <= nd-2
    t_masks = {d: _to_torch(m) for d, m in masks.items()}
    tg = UnetGenerator3D(1, 1, nd, ngf, "linear", True, "instance")
    assert t_masks[4].shape == tg.draw_dropout(
        (1, 1, size, size, size))[4].shape
    gaps = _check(jg, v32, tg, jnp.asarray(x32), (jnp.asarray(a32),),
                  (torch.from_numpy(a32),), {"dropout_masks": t_masks},
                  rng=rng, zero_modules=_normed("instance", nd),
                  forward=False)
    tg.eval()
    with torch.no_grad():
        port32 = _to_np(tg(_to_torch(x32), torch.from_numpy(a32)))
    with jax.enable_x64(True):
        jg64 = JG3(1, nd, ngf, "linear", True, "instance",
                   dtype=jnp.float64)
        v64 = jax.tree.map(lambda v: v.astype(jnp.float64), v32)
        ref64 = {False: np.asarray(jax.jit(jg64.apply)(
            v64, jnp.asarray(x), jnp.asarray(arch)))}
        # under x64 flax draws its keep-mask from a float64 uniform: another
        # mask than the f32 forward's
        ref64[True], masks64 = _train_with_masks(jg64, v64, x, arch, rng)
    t_masks = {d: _to_torch(m) for d, m in masks64.items()}
    tg.double()
    with torch.no_grad():
        for train in (False, True):
            tg.train(train)
            out = _to_np(tg(_to_torch(x), torch.from_numpy(arch),
                            t_masks if train else None))
            gap = _rel(out, ref64[train])
            print(f"nd 6 float64 {'train' if train else 'eval'} forward "
                  f"{gap:.2e}")
            assert gap <= FWD
    gap_jax = _rel(np.asarray(jg.apply(v32, jnp.asarray(x32),
                                       jnp.asarray(a32))), ref64[False])
    gap_port = _rel(port32, ref64[False])
    print(f"nd 6 f32 eval forward against float64: JAX {gap_jax:.2e}, "
          f"port {gap_port:.2e} (port against JAX in f32 "
          f"{gaps['eval forward']:.2e})")
    assert gap_port <= 4 * gap_jax


def test_unet3d_with_shared_bn():
    """The eval forward and the BN statistics in f32; everything (eval and
    train forward, gradients, statistics) again in float64 on both sides.
    The JAX package's f32 train-mode results are ill-conditioned here: its
    BN takes the variance as E[x^2] - E[x]^2, and its f32 gradients lie up
    to 4.9e-3 of a leaf's largest from its own float64 ones, the port's
    within 2.4e-6; the two f32 train forwards part by 1.1e-5."""
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 16, 1))
    make_j = lambda dt: JUNet3D(1, 2, (4, 8, 16), 32, dtype=dt)  # noqa: E731
    v32 = jax.jit(make_j(jnp.float32).init)(jax.random.key(2),
                                            jnp.asarray(x, jnp.float32))
    tu = UNet3D(1, 2, (4, 8, 16), 32)
    # the shared BN: one module, so one set of statistics folded twice
    assert "bn1" not in dict(tu.s_block1.named_children())
    g32 = _check(make_j(jnp.float32), v32, tu, jnp.asarray(x, jnp.float32),
                 grads=False, forward=False)
    assert g32["eval forward"] <= FWD
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda v: v.astype(jnp.float64), v32)
        _check(make_j(jnp.float64), v64, tu.double(), jnp.asarray(x),
               zero_modules=("conv1", "conv2"))
    tu.float()
