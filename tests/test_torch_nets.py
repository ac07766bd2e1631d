"""The port's nets against the JAX package's on bridged weights, in f32:
the generator (unet_64, so dropout is live, with the JAX package's dropout
masks injected), the PatchGAN and the U-Net (transposed-conv ups at base 4,
bilinear ups at base 8). Train- and eval-mode forward
(rtol 1e-4, atol 1e-5), gradients with respect to params and arch (within
1e-4 of each tensor's largest magnitude) and the BN running stats after one
train forward (within 1e-5)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_segmentation_tpu.models.pix2pix.networks import (
    define_D as jdefine_D, define_G as jdefine_G)
from semantic_segmentation_tpu.models.unet import UNet as JUNet
from semantic_segmentation_tpu.ops.nas import init_arch_params
from semantic_segmentation_torch.models.pix2pix.networks import (define_D,
                                                                 define_G)
from semantic_segmentation_torch.models.unet import UNet
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)

RTOL, ATOL = 1e-4, 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close_tree(port, ref, rel: float) -> float:
    """Each leaf of ``port`` within ``rel`` x the leaf's max |ref|; returns
    the largest such ratio."""
    flat_p = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert flat_p.keys() == flat_r.keys()
    worst = 0.0
    for k, r in flat_r.items():
        r = np.asarray(r)
        scale = max(np.max(np.abs(r)), 1e-12)
        err = np.max(np.abs(np.asarray(flat_p[k]) - r))
        assert err <= rel * scale, (jax.tree_util.keystr(k), err, scale)
        worst = max(worst, err / scale)
    return worst


def _dropout_masks(module, variables, x, *args, rng):
    """The keep-masks the JAX package's flax Dropout layers draw: recorded
    as (output != 0) around each Dropout call (its inputs are BN outputs,
    never exactly 0)."""
    masks = {}

    def record(next_fun, args_, kwargs, context):
        out = next_fun(*args_, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            masks[int(context.module.name[len("dropout"):])] = np.asarray(
                out != 0)
        return out

    with fnn.intercept_methods(record):
        module.apply(variables, x, *args, train=True, rngs={"dropout": rng},
                     mutable=["batch_stats"])
    return masks


def _check_net(jnet, variables, tnet, x, jargs=(), targs=(),
               t_kwargs_fn=lambda: {}, rng=None):
    params, stats = variables["params"], variables.get("batch_stats", {})
    load_flax(tnet, params, stats)
    rngs = {"dropout": rng} if rng is not None else None

    # eval-mode forward on the running stats
    tnet.eval()
    ref = np.asarray(jax.jit(lambda v, x_, a: jnet.apply(v, x_, *a, train=False))(
        variables, x, jargs))
    with torch.no_grad():
        out = _nhwc(tnet(_nchw(x), *targs))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    gaps = {"eval forward": np.max(np.abs(out - ref))}

    # train-mode forward, its stats, and the gradients
    w = np.random.default_rng(11).normal(size=ref.shape).astype(np.float32)

    def jloss(p, jargs_):
        y, mut = jnet.apply({"params": p, "batch_stats": stats}, x, *jargs_,
                            train=True, rngs=rngs, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (yj, stats_j)), (gp_j, ga_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jargs)

    tnet.train()
    targs_t = [a.clone().requires_grad_(True) if isinstance(a, torch.Tensor)
               else a for a in targs]
    yt = tnet(_nchw(x), *targs_t, **t_kwargs_fn())
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), rtol=RTOL, atol=ATOL)
    gaps["train forward"] = np.max(np.abs(_nhwc(yt) - np.asarray(yj)))
    (yt * _nchw(w)).sum().backward()

    gp_t, _ = state_dict_to_flax(
        tnet, {k: p.grad for k, p in tnet.named_parameters()})
    gaps["param grads / max"] = _close_tree(gp_t, jax.device_get(gp_j), 1e-4)
    for a_t, a_j in zip(targs_t, ga_j):
        gaps["arch grad / max"] = _close_tree({"a": a_t.grad.numpy()},
                                              {"a": np.asarray(a_j)}, 1e-4)

    _, stats_t = state_dict_to_flax(tnet, tnet.state_dict())
    flat_t = jax.tree_util.tree_leaves(stats_t)
    flat_j = jax.tree_util.tree_leaves(jax.device_get(stats_j))
    assert len(flat_t) == len(flat_j) > 0
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    gaps["BN stats"] = max(np.max(np.abs(a - b))
                           for a, b in zip(flat_t, flat_j))
    print(type(tnet).__name__, "measured gaps:",
          {k: f"{float(v):.2e}" for k, v in gaps.items()})


def test_generator_unet64_with_dropout():
    ngf, size = 4, 64
    jg = jdefine_G(1, "unet_64", ngf, "batch", True, jnp.float32)
    arch = init_arch_params(jax.random.key(1))["upconv"] * 300.0  # non-flat mix
    x = np.random.default_rng(0).normal(size=(2, size, size, 1)).astype(
        np.float32)
    variables = jax.jit(jg.init)(jax.random.key(0), jnp.asarray(x), arch)
    rng = jax.random.key(5)
    masks = _dropout_masks(jg, variables, jnp.asarray(x), arch, rng=rng)
    assert set(masks) == {4}          # 4 <= d <= nd-2 with nd = 6
    t_masks = {d: _nchw(m) for d, m in masks.items()}
    tg = define_G(1, 1, "unet_64", ngf, True)
    _check_net(jg, variables, tg, jnp.asarray(x), jargs=(arch,),
               targs=(torch.from_numpy(np.array(arch)),),
               t_kwargs_fn=lambda: {"dropout_masks": t_masks}, rng=rng)


def test_patchgan():
    jd = jdefine_D("basic", 4, 3, "batch", jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 2)).astype(
        np.float32)
    variables = jax.jit(jd.init)(jax.random.key(2), jnp.asarray(x))
    _check_net(jd, variables, define_D(2, "basic", 4), jnp.asarray(x))


def test_unet():
    ju = JUNet(1, 1, base_features=4, dtype=jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    variables = jax.jit(ju.init)(jax.random.key(3), jnp.asarray(x))
    _check_net(ju, variables, UNet(1, 1, 4), jnp.asarray(x))


def test_unet_bilinear():
    ju = JUNet(1, 1, bilinear=True, base_features=8, dtype=jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    variables = jax.jit(ju.init)(jax.random.key(4), jnp.asarray(x))
    _check_net(ju, variables, UNet(1, 1, 8, bilinear=True), jnp.asarray(x))


def test_unet_bilinear_parameter_count():
    ju = JUNet(1, 1, bilinear=True, base_features=64, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: ju.init(jax.random.key(0),
                                            jnp.zeros((1, 64, 64, 1))))
    n_j = sum(int(np.prod(a.shape)) for a in
              jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in UNet(1, 1, 64, True).parameters()) == n_j


def test_unet64_parameter_count():
    # tests/test_models.py:32, PARITY.md:23
    n = sum(p.numel() for p in UNet(1, 1, 64).parameters())
    assert n == 31_036_481


def test_generator_eval_mode_ignores_dropout():
    tg = define_G(1, 1, "unet_64", 4, True,
                  torch.Generator().manual_seed(0)).eval()
    arch = torch.zeros(8, 3)
    x = torch.randn(1, 1, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = tg(x, arch, generator=torch.Generator().manual_seed(2))
        b = tg(x, arch, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_generator_forward_leaves_no_reference_cycle():
    """A dropped generator is freed at once, not when the cyclic garbage
    collector next runs: a forward written as a closure that calls itself
    kept every generator (2.2 GB of a full-width stage-1 model with its
    optimizer state) allocated past its last use."""
    import gc
    import weakref
    gc.disable()
    try:
        g = define_G(1, 1, "unet_32", 4, True,
                     torch.Generator().manual_seed(0))
        g(torch.zeros(1, 1, 32, 32), torch.zeros(8, 3))
        ref = weakref.ref(g)
        del g
        assert ref() is None
    finally:
        gc.enable()
