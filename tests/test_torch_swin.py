"""The port's Swin-UNet (``models/swin_unet.py``) against the JAX package's
at img 64, patch 4, window 4, embed 12, depths (2, 2, 2, 2), heads
(1, 2, 2, 4), f32, on bridged weights. At 64^2 the stages run at 16, 8, 4
and 2 tokens a side, so shifted windows and their mask run in two stages.

- equal parameter counts, and the bridge's round trip;
- eval forward within 1e-5 of the largest |logit|;
- ``drop_path`` and the ``_dpr`` table;
- a train-mode forward with the JAX drop-path masks injected, and the
  gradient of every parameter, each within 1e-5 of its largest magnitude.
  The masks are captured by wrapping ``swin_unet.drop_path`` of the JAX
  package inside the test (the wrapper records each mask under the block
  that draws it);
- ``use_checkpoint``: the same gradients as the plain run, with the masks
  drawn from one generator before the recomputed blocks.

The largest gaps are printed (``-s``)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models import swin_unet as jswin
from semantic_segmentation_torch.models import swin_unet as tswin
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)

KW = dict(img_size=64, patch_size=4, embed_dim=12, depths=(2, 2, 2, 2),
          num_heads=(1, 2, 2, 4), window_size=4, drop_path_rate=0.2)
TOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _gen():
    """An explicit generator for the port's init (overwritten by the
    bridged weights): the global one stays untouched."""
    return torch.Generator().manual_seed(0)


def _within(port: np.ndarray, ref: np.ndarray, what: str) -> float:
    scale = max(float(np.max(np.abs(ref))), 1e-12)
    err = float(np.max(np.abs(port - ref)))
    assert err <= TOL * scale, (what, err, scale)
    return err / scale


@pytest.fixture(scope="module")
def nets():
    jnet = jswin.SwinUnet(n_channels=1, n_classes=1, dtype=jnp.float32, **KW)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    params = jax.device_get(jax.jit(lambda k, v: jnet.init(
        k, v, train=False))(jax.random.key(0), jnp.asarray(x))["params"])
    tnet = tswin.SwinUnet(1, 1, generator=_gen(), **KW)
    load_flax(tnet, params)
    return jnet, params, tnet, x


def _capture_masks(jnet, params, x, key, monkeypatch):
    """{block name: (2, B) bool} keep-masks of one JAX train forward."""
    masks, current = {}, [None]
    plain = jswin.drop_path

    def recording_drop_path(v, rate, rng):
        mask = jax.random.bernoulli(rng, 1.0 - rate, (v.shape[0],))
        masks.setdefault(current[0], []).append(np.asarray(mask))
        return plain(v, rate, rng)

    def track(next_fun, args, kwargs, context):
        if isinstance(context.module, jswin.SwinBlock):
            current[0] = context.module.name
        return next_fun(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(jswin, "drop_path", recording_drop_path)
        with fnn.intercept_methods(track):
            jnet.apply({"params": params}, jnp.asarray(x), train=True,
                       rngs={"dropout": key})
    return {k: torch.from_numpy(np.stack(v)) for k, v in masks.items()}


def test_parameter_count_and_bridge_round_trip(nets):
    _, params, tnet, _ = nets
    n_j = sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tnet.parameters()) == n_j
    back, stats = state_dict_to_flax(tnet, tnet.state_dict())
    assert stats == {}
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_lite_config_parameter_count():
    # the reference's lite config at 224 (the end2end_isic224 segmenter)
    jnet = jswin.SwinUnet(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 1)), train=False))
    n_j = sum(np.prod(v.shape) for v in
              jax.tree_util.tree_leaves(shapes["params"]))
    net = tswin.SwinUnet(generator=_gen())
    assert sum(p.numel() for p in net.parameters()) == n_j


def test_eval_forward(nets):
    jnet, params, tnet, x = nets
    ref = np.asarray(jax.jit(lambda p, v: jnet.apply(
        {"params": p}, v, train=False))(params, jnp.asarray(x)))
    tnet.eval()
    with torch.no_grad():
        out = tnet(_nchw(x)).permute(0, 2, 3, 1).numpy()
    print(f"swin eval forward gap / max: {_within(out, ref, 'eval'):.2e}")


def test_drop_path_and_dpr_table(nets):
    jnet, _, tnet, _ = nets
    for s, depth in enumerate(KW["depths"]):
        for b in range(depth):
            assert tnet._dpr(s, b) == jnet._dpr(s, b)
    names = tnet.stochastic_blocks()
    # rate 0 at encoder block 0 and the decoder block that reads it
    assert "enc0_blk0" not in names and "dec2_blk0" not in names
    assert len(names) == 11
    v = np.random.default_rng(1).normal(size=(5, 7, 3)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jswin.drop_path(jnp.asarray(v), 0.3, key))
    mask = torch.from_numpy(np.array(
        jax.random.bernoulli(key, 0.7, (5,))))
    got = tswin.drop_path(torch.from_numpy(v), mask, 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_train_forward_and_gradients_with_jax_masks(nets, monkeypatch):
    jnet, params, tnet, x = nets
    key = jax.random.key(7)
    masks = _capture_masks(jnet, params, x, key, monkeypatch)
    assert set(masks) == set(tnet.stochastic_blocks())
    assert all(m.shape == (2, 2) for m in masks.values())
    w = np.random.default_rng(2).normal(size=(2, 64, 64, 1)).astype(
        np.float32)

    def jloss(p):
        y = jnet.apply({"params": p}, jnp.asarray(x), train=True,
                       rngs={"dropout": key})
        return jnp.sum(y * w), y

    (_, yj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tnet.train()
    tnet.zero_grad(set_to_none=True)
    yt = tnet(_nchw(x), masks)
    gaps = {"train forward": _within(yt.detach().permute(0, 2, 3, 1).numpy(),
                                     np.asarray(yj), "train forward")}
    (yt * _nchw(w)).sum().backward()
    gt, _ = state_dict_to_flax(
        tnet, {k: p.grad for k, p in tnet.named_parameters()})
    flat_t = dict(jax.tree_util.tree_flatten_with_path(gt)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.device_get(gj))[0])
    assert flat_t.keys() == flat_j.keys()
    gaps["grads"] = max(_within(np.asarray(flat_t[k]), np.asarray(r),
                                jax.tree_util.keystr(k))
                        for k, r in flat_j.items())
    print("swin train-mode gaps / max:",
          {k: f"{v:.2e}" for k, v in gaps.items()})


def test_use_checkpoint_gives_the_plain_gradients(nets):
    _, params, _, x = nets
    grads = []
    for ckpt in (False, True):
        net = tswin.SwinUnet(1, 1, use_checkpoint=ckpt, generator=_gen(),
                             **KW)
        load_flax(net, params)
        net.train()
        y = net(_nchw(x), generator=torch.Generator().manual_seed(5))
        y.square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k
