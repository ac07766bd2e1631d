"""The port's ADM denoiser (``models/diffusion/adm_unet.py``) against the
JAX package's on bridged weights, f32, NCHW against NHWC:

- ``timestep_embedding`` (``[cos, sin]``, even and odd widths) within 1e-6;
- ``GroupNorm`` at a fallback width (48 channels: 24 groups) within 1e-5 of
  the largest output;
- ``AttentionBlock`` (32 channels, 4 heads: the qkv split) and
  ``ResBlock`` plain, with a cell, up and down, forward within 1e-5 of the
  largest output;
- ``ADMUNet`` (model_channels 16, one res block, mult (1, 2), attention at
  ds 2 and in the middle, 16^2, conditioned) forward within 1e-5 of the
  largest output, and the gradients of a loss of it (every parameter, the
  arch table, the input) within 5e-5 of each leaf's largest (the biases
  whose gradient is 0 in exact arithmetic, found by the port's float64
  gradient, within 5e-5 of the net's largest); the forward
  with the cells assembled once (``assemble``) equal to the plain one bit
  for bit;
- a 5-step ``p_sample_loop`` around that net (the test's docstring);
- parameter counts equal at full width (model_channels 128, mult (1, 4, 8),
  2 res blocks: 1,211,895,425), the port's built on the ``meta`` device,
  the JAX package's counted with ``jax.eval_shape``.

Every weight is bridged non-zero: the zero-init layers (every ``out_conv``,
the attention ``proj``) would make the net's output and every residual
exactly 0, so a fresh net proves nothing. The largest gaps are printed
(``-s``)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.diffusion import adm_unet as jadm
from semantic_segmentation_tpu.models.diffusion import bbdm as jbbdm
from semantic_segmentation_torch.models.diffusion import adm_unet as tadm
from semantic_segmentation_torch.models.diffusion import bbdm as tbbdm
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)

FWD, GRAD = 1e-5, 5e-5
SMALL = dict(model_channels=16, num_res_blocks=1, channel_mult=(1, 2),
             attention_resolutions=(2,), num_head_channels=8)


def nchw(x):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(x), -1, 1),
                                     order="C"))


def nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


def nonzero(params, seed: int):
    """``params`` with every leaf made random and non-zero: kernels
    N(0, 1/fan_in), biases and norm offsets N(0, 0.1^2), norm scales
    1 + N(0, 0.1^2)."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.default_rng(seed)
    out = []
    for path, v in leaves:
        name = jax.tree_util.keystr(path)
        if v.ndim >= 2:
            fan_in = int(np.prod(v.shape[:-1]))
            new = rng.normal(size=v.shape) / np.sqrt(fan_in)
        elif "scale" in name:
            new = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            new = 0.1 * rng.normal(size=v.shape)
        out.append(jnp.asarray(new, jnp.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def param_shapes(jnet, channels: int, size: int, arch):
    """The JAX net's parameter tree as shapes (``jax.eval_shape``: flax's
    eager init of the net takes a minute on the CPU)."""
    x = jnp.zeros((1, size, size, channels))
    return jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.key(0)}, x, jnp.zeros((1,), jnp.int32), arch,
        context=x))["params"]


def small_nets(seed: int = 0, channels: int = 1, size: int = 16, **kw):
    """(JAX ADMUNet, its non-zero params, the arch table, the port's net
    holding the same weights) at the test width."""
    cfg = {**SMALL, **kw}
    jnet = jadm.ADMUNet(out_channels=channels, dtype=jnp.float32, **cfg)
    n_cells = jadm.ADMUNet.num_cells(cfg["channel_mult"],
                                     cfg["num_res_blocks"])
    rng = np.random.default_rng(seed)
    arch = jnp.asarray(0.5 * rng.normal(size=(n_cells, 3)), jnp.float32)
    params = nonzero(param_shapes(jnet, channels, size, arch), seed + 1)
    tnet = tadm.ADMUNet(2 * channels, channels, **cfg)
    load_flax(tnet, jax.device_get(params))
    return jnet, params, arch, tnet


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) / \
        float(np.max(np.abs(np.asarray(b))))


@pytest.mark.parametrize("dim", [16, 15])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 7, 500, 999])
    ref = np.asarray(jadm.timestep_embedding(jnp.asarray(t), dim))
    got = tadm.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == ref.shape == (5, dim)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_group_norm_fallback_width():
    assert tadm.num_groups(48) == 24 and tadm.num_groups(16) == 16 and \
        tadm.num_groups(256) == 32
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, size=(2, 6, 6, 48)).astype(np.float32)
    jgn = jadm._gn("gn", 48)
    v = {"params": nonzero(jax.eval_shape(lambda: jgn.init(
        jax.random.key(0), jnp.asarray(x)))["params"], 1)}
    ref = np.asarray(jgn.apply(v, jnp.asarray(x)))
    gn = tadm.GroupNorm(48)
    load_flax(gn, jax.device_get(v["params"]))
    gap = _gap(nhwc(gn(nchw(x))), ref)
    print(f"GroupNorm(48): {gap:.2e}")
    assert gap <= FWD


def _block_case(jmod, tmod, x, *args, jargs=(), seed=0):
    params = nonzero(jax.eval_shape(lambda: jmod.init(
        jax.random.key(seed), jnp.asarray(x), *jargs))["params"], seed + 1)
    ref = np.asarray(jax.jit(lambda v, xx: jmod.apply(v, xx, *jargs))(
        {"params": params}, jnp.asarray(x)))
    load_flax(tmod, jax.device_get(params))
    got = nhwc(tmod(nchw(x), *args))
    assert got.shape == ref.shape
    return _gap(got, ref)


def test_attention_block_heads_split():
    x = np.random.default_rng(2).normal(size=(2, 4, 4, 32)).astype(
        np.float32)
    gap = _block_case(jadm.AttentionBlock(32, 8, jnp.float32),
                      tadm.AttentionBlock(32, 8), x)
    print(f"AttentionBlock(32, 4 heads): {gap:.2e}")
    assert gap <= FWD


@pytest.mark.parametrize("kind", ["plain", "cell", "up", "down"])
def test_res_block(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    emb = rng.normal(size=(2, 24)).astype(np.float32)
    arch = (0.5 * rng.normal(size=(2, 3))).astype(np.float32)
    cell = -1 if kind == "plain" else 1
    kw = {"up": kind == "up", "down": kind == "down"}
    jres = jadm.ResBlock(32, cell_index=cell, dtype=jnp.float32, **kw)
    tres = tadm.ResBlock(16, 24, 32, cell_index=cell, **kw)
    gap = _block_case(jres, tres, x, torch.from_numpy(emb),
                      torch.from_numpy(arch),
                      jargs=(jnp.asarray(emb), jnp.asarray(arch), False))
    print(f"ResBlock {kind}: {gap:.2e}")
    assert gap <= FWD


@pytest.fixture(scope="module")
def small():
    """The small nets on bridged weights and the JAX loss's jitted
    ``value_and_grad`` (its aux the net's output)."""
    jnet, params, arch, tnet = small_nets()

    def jloss(p, a, xx, t, ctx, target):
        y = jnet.apply({"params": p}, xx, t, a, context=ctx)
        return jnp.mean((y - target) ** 2), y

    vg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))
    return jnet, params, arch, tnet, vg


def test_adm_unet_forward_and_gradients(small):
    jnet, params, arch, tnet, vg = small
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    ctx = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    target = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    t = np.array([3, 17])
    (_, jy), (gp, ga, gx) = vg(params, arch, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(ctx), jnp.asarray(target))
    # float64 first: the leaves whose gradient is 0 in exact arithmetic
    # (biases that only GroupNorms of one channel a group read, through 1x1
    # convs and residual sums) are rounding noise in f32 in both packages
    # and are held against the net's largest gradient
    net64 = copy.deepcopy(tnet).double()
    y64 = net64(nchw(x).double(), torch.from_numpy(t),
                torch.from_numpy(np.array(arch)).double(), nchw(ctx).double())
    ((y64 - nchw(target).double()) ** 2).mean().backward()
    g64, _ = state_dict_to_flax(
        net64, {k: p.grad for k, p in net64.named_parameters()})
    flat64 = dict(jax.tree_util.tree_flatten_with_path(g64)[0])
    top64 = max(float(np.max(np.abs(v))) for v in flat64.values())
    zero = {k for k, v in flat64.items()
            if float(np.max(np.abs(v))) <= 1e-9 * top64}
    ta = torch.from_numpy(np.array(arch)).requires_grad_(True)
    tx = nchw(x).requires_grad_(True)
    ty = tnet(tx, torch.from_numpy(t), ta, nchw(ctx))
    ((ty - nchw(target)) ** 2).mean().backward()
    fwd = _gap(nhwc(ty), jy)
    assert float(np.abs(np.asarray(jy)).max()) > 0.1   # not a zero net
    assert fwd <= FWD, fwd
    # the cells assembled once: the same forward bit for bit
    with torch.no_grad():
        kernels = tnet.assemble(ta)
        again = tnet(nchw(x), torch.from_numpy(t), None, nchw(ctx), kernels)
    assert torch.equal(again, ty.detach())
    grads, _ = state_dict_to_flax(
        tnet, {k: p.grad for k, p in tnet.named_parameters()})
    worst = noise = 0.0
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(gp)[0])
    assert flat_t.keys() == flat_j.keys()
    top = max(float(np.max(np.abs(np.asarray(v)))) for v in flat_j.values())
    assert zero and all("bias" in jax.tree_util.keystr(k) for k in zero)
    for k, ref in flat_j.items():
        name = jax.tree_util.keystr(k)
        if k in zero:
            gap = float(np.max(np.abs(flat_t[k] - np.asarray(ref)))) / top
            assert gap <= GRAD, (name, gap)
            noise = max(noise, gap)
            continue
        gap = _gap(flat_t[k], ref)
        assert gap <= GRAD, (name, gap)
        worst = max(worst, gap)
    g_arch, g_x = _gap(ta.grad.numpy(), ga), _gap(nhwc(tx.grad), gx)
    assert g_arch <= GRAD and g_x <= GRAD
    print(f"ADMUNet: forward {fwd:.2e}, parameter gradients {worst:.2e}, "
          f"zero-gradient biases {noise:.2e} of the largest, arch "
          f"{g_arch:.2e}, input {g_x:.2e}")


def test_p_sample_loop_on_the_denoiser(small):
    """A 5-step ``p_sample_loop`` (T = 20) around the small denoiser, the
    cells assembled once, with the JAX per-step noises (``normal(fold_in(
    rng, i))``) injected, against the JAX loop's scan body (bbdm.py:172-
    178) jitted once and run step by step: each step from the
    JAX state within 1e-5 of the largest magnitude (one net forward's
    bound), the whole loop within 5e-5 (five chained steps, each feeding
    the next its rounding; measured 1.5e-5 to 2.1e-5)."""
    jnet, params, arch, tnet, _ = small
    y = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 1)).astype(
        np.float32)
    sched = dict(num_timesteps=20, sample_step=5)
    jb = jbbdm.BrownianBridge(
        lambda p, x, t, c, r, train: jnet.apply({"params": p}, x, t, arch,
                                                context=c),
        jbbdm.BridgeSchedule(**sched))
    tb = tbbdm.BrownianBridge(tbbdm.BridgeSchedule(**sched))
    rng = jax.random.key(5)
    # the scan's body, jitted once with a traced step index
    step = jax.jit(lambda img, i: jb.p_sample_step(
        params, img, jnp.asarray(y), jnp.asarray(y), i,
        jax.random.fold_in(rng, i)))
    noises = [nchw(jax.random.normal(jax.random.fold_in(rng, i), y.shape,
                                     jnp.float32)) for i in range(5)]
    kernels = tnet.assemble(torch.from_numpy(np.array(arch)))

    def den(x, t, c, train):
        return tnet(x, t, None, c, kernels)
    img, one_step = jnp.asarray(y), 0.0
    for i in range(5):
        got, _ = tb.p_sample_step(den, nchw(img), nchw(y), nchw(y), i,
                                  noises[i])
        img, _ = step(img, jnp.int32(i))
        one_step = max(one_step, float(np.max(np.abs(nhwc(got) - img))
                                       / np.max(np.abs(img))))
    loop = nhwc(tb.p_sample_loop(den, nchw(y), noises))
    gap = float(np.max(np.abs(loop - img)) / np.max(np.abs(img)))
    print(f"5-step sampler: one step from the JAX state {one_step:.2e}, "
          f"the whole loop {gap:.2e} of the largest")
    assert one_step <= 1e-5 and gap <= 5e-5


def test_parameter_count_at_full_width():
    jnet = jadm.ADMUNet(out_channels=1)
    x = jnp.zeros((1, 32, 32, 1))
    shapes = jax.eval_shape(
        lambda: jnet.init({"params": jax.random.key(0)}, x,
                          jnp.zeros((1,), jnp.int32), jnp.zeros((21, 3)),
                          context=x))
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tnet = tadm.ADMUNet(2, 1)
    n_port = sum(p.numel() for p in tnet.parameters())
    assert n_port == n_jax == 1_211_895_425
    assert tnet.n_cells == jadm.ADMUNet.num_cells() == 21
