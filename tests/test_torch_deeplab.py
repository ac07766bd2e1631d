"""The port's DeepLabV3 and DeepLabV2 (``models/deeplab.py``) against the
JAX package's, f32, on bridged weights: V3 at layers 1-1-1-1 on 32^2 (a
4x4 map at output stride 8, so ASPP's rates 12-36 reach mostly padding),
V2 at layers 1-1-1 on 48^2 (output stride 16: 3x3), for 1 input channel
and 1 class and for 3 and 3.

- equal parameter counts, and the bridge's round trip (strict load);
- eval forward within 1e-5 of the largest |logit|;
- a train-mode forward (V3 with the JAX ASPP dropout mask injected)
  and the BN running statistics after it, within 5e-5 (f32),
  and the gradients within 5e-5 of the largest (float64 on both sides;
  see the test);
- the full-depth parameter counts (V3: ResNet-50 at 3-4-6-3, V2:
  ResNet-101 at 3-4-23);
- the init laws: per-layer moments of the port's init against the JAX
  package's.

The largest gaps are printed (``-s``)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models import deeplab as jdl
from semantic_segmentation_torch.models import deeplab as tdl
from tests.test_torch_sivae_nets import random_variables
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax,
                                                      state_dict_to_flax)

CASES = {"v3_1ch_1cls": ("v3", 1, 1), "v3_3ch_3cls": ("v3", 3, 3),
         "v2_1ch_1cls": ("v2", 1, 1), "v2_3ch_3cls": ("v2", 3, 3)}
SIZE = {"v3": 32, "v2": 48}
TOL = {"eval": 1e-5, "train": 5e-5}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nets(kind, c, k, layers=None):
    gen = torch.Generator().manual_seed(0)
    if kind == "v3":
        layers = layers or (1, 1, 1, 1)
        return (jdl.DeepLabV3(c, k, layers=layers, dtype=jnp.float32),
                tdl.DeepLabV3(c, k, layers=layers, generator=gen))
    layers = layers or (1, 1, 1)
    return (jdl.DeepLabV2(c, k, layers=layers, dtype=jnp.float32),
            tdl.DeepLabV2(c, k, layers=layers, generator=gen))


def _within(port, ref, what, tol):
    scale = max(float(np.max(np.abs(ref))), 1e-12)
    err = float(np.max(np.abs(np.asarray(port) - np.asarray(ref))))
    assert err <= tol * scale, (what, err, scale)
    return err / scale


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kind, c, k = CASES[request.param]
    jnet, tnet = _nets(kind, c, k)
    s = SIZE[kind]
    x = np.random.default_rng(0).normal(size=(2, s, s, c)).astype(np.float32)
    # values drawn from the init's shapes (no flax init is compiled)
    v = random_variables(jnet, jnp.asarray(x), train=False)
    load_flax(tnet, v["params"], v["batch_stats"])
    return request.param, kind, jnet, v, tnet, x


def test_parameter_count_and_bridge_round_trip(case):
    _, _, _, v, tnet, _ = case
    n_j = sum(np.size(a) for a in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in tnet.parameters()) == n_j
    params, stats = state_dict_to_flax(tnet, tnet.state_dict())
    for tree, ref in ((params, v["params"]), (stats, v["batch_stats"])):
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(ref))
        for a, b in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_eval_forward(case):
    name, _, jnet, v, tnet, x = case
    ref = np.asarray(jax.jit(lambda a: jnet.apply(v, a, train=False))(
        jnp.asarray(x)))
    tnet.eval()
    with torch.no_grad():
        out = tnet(_nchw(x)).permute(0, 2, 3, 1).numpy()
    print(f"{name} eval forward gap / max: "
          f"{_within(out, ref, 'eval', TOL['eval']):.2e}")


def aspp_mask_capture(jnet):
    """The jitted JAX train-mode apply that also returns the ASPP dropout's
    keep-mask (NHWC bool): the Dropout, fed ones in place of its input,
    gives 2 where it keeps; the values it returns are the plain ones."""
    def track(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout):
            return next_fun(*args, **kwargs)
        scaled = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
        context.module.sow("intermediates", "keep", scaled != 0)
        return args[0] * scaled

    def apply(variables, x, key):
        with fnn.intercept_methods(track):
            y, mut = jnet.apply(variables, x, train=True,
                                rngs={"dropout": key},
                                mutable=["batch_stats", "intermediates"])
        keep = mut.get("intermediates", {}).get("aspp", {}).get(
            "Dropout_0", {}).get("keep")
        return y, mut["batch_stats"], None if keep is None else keep[0]

    return apply


def _jax_train(kind, c, k, v, x, w, key, dtype):
    """The JAX net's train-mode logits, BN statistics, ASPP keep-mask and
    the gradient of sum(logits * w), computed in ``dtype``."""
    jnet = (jdl.DeepLabV3(c, k, layers=(1, 1, 1, 1), dtype=dtype)
            if kind == "v3" else jdl.DeepLabV2(c, k, layers=(1, 1, 1),
                                              dtype=dtype))
    v = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)
    apply = aspp_mask_capture(jnet)

    def jloss(p):
        y, stats, keep = apply({"params": p,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x, dtype), key)
        return jnp.sum(y * jnp.asarray(w, dtype)), (y, stats, keep)

    (_, (y, stats, keep)), g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    return jax.device_get((y, stats, keep, g))


def test_train_forward_gradients_and_statistics(case):
    """f32: the train-mode forward within 5e-5 of the largest |logit|, and
    each BN statistic it leaves within 5e-5 of that statistic's largest. The gradients are held in
    float64 on both sides (the JAX net at ``dtype=float64`` under
    ``jax.enable_x64``, the port's in double), within 5e-5 of the largest
    gradient magnitude over all parameters: in f32 the two packages'
    gradients part by up to 1.2e-2 of it at these shapes, and the JAX
    package's own f32 gradients are as far from the float64 ones, while
    the port's stay within 1.8e-4 (the pooled ASPP branch's BN normalizes
    two values a channel at batch 2, which amplifies rounding; V2's f32 gap
    is 4.5e-5 of each parameter's largest)."""
    name, kind, _, v, tnet, x = case
    c, k = tnet.n_channels, tnet.n_classes
    w = np.random.default_rng(2).normal(size=x.shape[:3] + (k,))
    key = jax.random.key(7)
    yj, sj, keep, _ = _jax_train(kind, c, k, v, x, w.astype(np.float32),
                                 key, jnp.float32)

    def run(net, dtype, keep):
        net.train()
        net.zero_grad(set_to_none=True)
        xt = _nchw(x).to(dtype)
        y = (net(xt, {"aspp": _nchw(np.asarray(keep))}) if kind == "v3"
             else net(xt))
        (y * _nchw(w).to(dtype)).sum().backward()
        return y.detach().permute(0, 2, 3, 1).numpy()

    if kind == "v3":
        assert 0.3 < float(np.mean(keep)) < 0.7
    gaps = {"forward": _within(run(tnet, torch.float32, keep), yj,
                               "train forward", TOL["train"])}
    want = flax_to_state_dict(tnet, {}, sj)
    own = tnet.state_dict()
    gaps["bn stats"] = max(_within(own[n].numpy(), r.numpy(), n,
                                   TOL["train"])
                           for n, r in want.items())
    with jax.enable_x64():
        _, _, keep64, gj = _jax_train(kind, c, k, v, x, w, key, jnp.float64)
    load_flax(tnet, v["params"], v["batch_stats"])
    net = tnet.double()
    try:
        run(net, torch.float64, keep64)
        gt, _ = state_dict_to_flax(
            net, {n: p.grad for n, p in net.named_parameters()})
    finally:
        tnet.float()
    flat_t = dict(jax.tree_util.tree_flatten_with_path(gt)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(gj)[0])
    assert flat_t.keys() == flat_j.keys()
    scale = max(float(np.max(np.abs(g))) for g in flat_j.values())
    err = max(float(np.max(np.abs(flat_t[n] - g))) for n, g in flat_j.items())
    assert err <= TOL["train"] * scale, (err, scale)
    gaps["grads (f64)"] = err / scale
    print(f"{name} train-mode gaps / max:",
          {n: f"{g:.2e}" for n, g in gaps.items()})
    load_flax(tnet, v["params"], v["batch_stats"])


@pytest.mark.parametrize("kind", ["v3", "v2"])
def test_full_depth_parameter_count(kind):
    jnet, tnet = _nets(kind, 1, 1, (3, 4, 6, 3) if kind == "v3"
                       else (3, 4, 23))
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 1)), train=False))
    n_j = sum(int(np.prod(a.shape)) for a in
              jax.tree_util.tree_leaves(shapes["params"]))
    n_t = sum(p.numel() for p in tnet.parameters())
    assert n_t == n_j, (n_t, n_j)
    print(f"{kind} full depth: {n_t} parameters")


def _moments(a):
    a = np.asarray(a, np.float64).ravel()
    z = a / a.std()
    return a.mean(), a.std(), float(np.abs(z).max())


@pytest.mark.parametrize("kind", ["v3", "v2"])
def test_init_laws_match_jax(kind):
    """Per-layer kernel moments of the port's init against the JAX
    package's (kernels of 2000 values or more): the standard deviation
    within 6%, the mean within 0.1 std, and the tail: no value beyond 2.4
    std where the JAX package truncates (lecun-normal at two of its
    pre-truncation std, 2.27 of the truncated one's), some beyond 3 where
    it does not (DeepLabV2's stem and classifier); biases zero, BN scales
    one."""
    jnet, tnet = _nets(kind, 3, 2, (2, 1, 1, 1) if kind == "v3"
                       else (2, 1, 1))
    v = jax.device_get(jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3))))
    port, _ = state_dict_to_flax(tnet, tnet.state_dict())
    flat_j = dict(jax.tree_util.tree_flatten_with_path(v["params"])[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert flat_t.keys() == flat_j.keys()
    checked = 0
    for path, ref in flat_j.items():
        got, leaf = np.asarray(flat_t[path]), path[-1].key
        if leaf in ("bias",):
            assert not got.any() and not np.asarray(ref).any(), path
            continue
        if leaf == "scale":
            assert (got == 1).all() and (np.asarray(ref) == 1).all(), path
            continue
        if ref.size < 2000:
            continue
        mj, sj, zmax_j = _moments(ref)
        mt, st, zmax_t = _moments(got)
        assert abs(st / sj - 1) < 0.06, (path, st, sj)
        assert abs(mt - mj) < 0.1 * sj, (path, mt, mj)
        if zmax_j < 2.4:        # truncated at 2 / 0.8796 = 2.27 std
            assert zmax_t < 2.4, (path, zmax_t)
        else:
            assert zmax_t > 3.0, (path, zmax_t)
        checked += 1
    assert checked >= 10
