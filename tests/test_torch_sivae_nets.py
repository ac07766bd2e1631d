"""The port's soft-intro VAE nets and losses against the JAX package's
(``models/vae/sivae.py``) on bridged weights, f32, NCHW against NHWC:

- ``calc_reconstruction_loss`` under mse, l1 and bce, each reduction
  ('none': per-sample sums), ``calc_kl`` and ``reparameterize`` with the
  JAX draw injected: within 1e-6 relative;
- ``ResNet18Encoder`` at 64^2, batch 2: the eval- and train-mode forwards
  and the BN running statistics after one train forward within 1e-5 of
  the largest magnitude; the gradients of a fixed linear read-out of
  (mu, logvar) in train mode, every parameter leaf and the arch table,
  within 5e-5 of each leaf's largest; and against ``TorchSIVAEEncoder``
  (``tests/torch_oracles.py``, its BN in eval mode) within 1e-5;
- the encoder once at the presets' 256^2, batch 1, eval-mode forward
  within 1e-5: its pooled map is 2x2, so the fc heads read a flatten
  order (at 64^2 and 128^2 the map is 1x1 and no order shows);
- ``GUnetAddInput`` (nd 5, 32^2, ngf 8) under instance and batch norm:
  train-mode forward within 1e-5, gradients within 5e-5 of each leaf's
  largest (the biases of the convs a norm follows, whose gradient is 0 in
  exact arithmetic, within 5e-5 of the net's largest gradient in each
  package), and the instance-norm net against ``TorchGUnetAddInput``
  within 1e-5;
- ``DNLayersMulti`` at two scales (ndf 8): each logit map within 1e-5;
- ``SoftIntroVAE``'s depth pairing and ``utils/bridge.load_sivae_flax``.

The JAX variables are drawn with numpy from ``jax.eval_shape``'s shapes
(``random_variables``) and the JAX programs are jitted. The largest gaps
are printed (``-s``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.vae import sivae as J
from semantic_segmentation_torch.models.vae import sivae as T
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      load_sivae_flax,
                                                      state_dict_to_flax)
from tests.torch_oracles import TorchGUnetAddInput, TorchSIVAEEncoder

FWD, GRAD = 1e-5, 5e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(x), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaf_gaps(port_tree, jax_tree):
    """{leaf path: gap over the JAX leaf's largest magnitude}."""
    fp = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    fj = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    assert fp.keys() == fj.keys()
    return {jax.tree_util.keystr(k): _gap(fp[k], fj[k]) for k in fj}


def random_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """Variables of the flax ``module`` for ``module.init(key, *args,
    **kwargs)``, drawn with numpy from their shapes (``jax.eval_shape``:
    no init is compiled, which for the feature nets takes most of a JAX
    test's time): conv and dense kernels N(0, 1 / fan_in), biases and BN
    shifts N(0, 0.1), BN scales 1 + N(0, 0.1), running means N(0, 0.1),
    running variances 0.5 + |N(0, 1)|; other leaves (the arch table)
    1e-3 N(0, 1)."""
    return random_tree(jax.eval_shape(lambda: module.init(
        jax.random.key(0), *args, **kwargs)), seed)


def random_tree(shapes, seed: int = 0) -> dict:
    """``random_variables``' draw on a tree of shapes."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.startswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(size=s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "var":
            v = 0.5 + np.abs(rng.normal(size=s.shape))
        elif name in ("bias", "mean") or name.startswith("bias"):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = 1e-3 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _grads_to_flax(net):
    grads = {n: p.grad for n, p in net.named_parameters()}
    return state_dict_to_flax(net, grads)[0]


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("loss_type", ["mse", "l1", "bce"])
def test_reconstruction_loss_matches_jax(loss_type, reduction):
    rng = np.random.default_rng(0)
    x = rng.random((3, 8, 8, 2)).astype(np.float32)
    r = rng.random((3, 8, 8, 2)).astype(np.float32)
    want = np.asarray(J.calc_reconstruction_loss(
        jnp.asarray(x), jnp.asarray(r), loss_type, reduction))
    got = T.calc_reconstruction_loss(_nchw(x), _nchw(r), loss_type,
                                     reduction).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("reduce", ["sum", "mean", "none"])
def test_kl_and_reparameterize_match_jax(reduce):
    rng = np.random.default_rng(1)
    mu = rng.normal(size=(4, 8)).astype(np.float32)
    lv = rng.normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        T.calc_kl(torch.from_numpy(lv), torch.from_numpy(mu), reduce),
        np.asarray(J.calc_kl(jnp.asarray(lv), jnp.asarray(mu), reduce)),
        rtol=1e-6)
    key = jax.random.key(3)
    want = J.reparameterize(key, jnp.asarray(mu), jnp.asarray(lv))
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, mu.shape)))
    np.testing.assert_allclose(
        T.reparameterize(torch.from_numpy(mu), torch.from_numpy(lv), eps),
        np.asarray(want), rtol=1e-6, atol=1e-7)


# -- the encoder ---------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder64():
    """(JAX encoder, variables, arch, x, readout) at 64^2, batch 2."""
    enc = J.ResNet18Encoder(latent_dim=8, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    arch = (0.5 * rng.normal(size=(10, 3))).astype(np.float32)
    variables = random_variables(enc, jnp.asarray(x), arch, train=False)
    readout = rng.normal(size=(2, 16)).astype(np.float32)
    return enc, variables, arch, x, readout


def _port_encoder(variables, size=64):
    net = T.ResNet18Encoder(8, size)
    load_flax(net, variables["params"], variables["batch_stats"])
    return net


def test_encoder_matches_jax(encoder64):
    """Eval and train forwards, BN statistics, and the gradients of the
    parameters and of the arch table (train mode)."""
    enc, variables, arch, x, readout = encoder64

    def loss(params, a):
        (mu, lv), mut = enc.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), a, train=True,
                                  mutable=["batch_stats"])
        out = jnp.concatenate([mu, lv], -1)
        return jnp.sum(out * readout), (out, mut["batch_stats"])

    (_, (out_j, stats_j)), (g_params, g_arch) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(arch))
    eval_j = jax.jit(lambda v: jnp.concatenate(
        enc.apply(v, jnp.asarray(x), jnp.asarray(arch), train=False), -1))(
        variables)

    net = _port_encoder(variables).eval()
    a = torch.from_numpy(arch)
    with torch.no_grad():
        eval_t = torch.cat(net(_nchw(x), a), -1)
    net.train()
    a.requires_grad_(True)
    out_t = torch.cat(net(_nchw(x), a), -1)
    (out_t * torch.from_numpy(readout)).sum().backward()
    gaps = {"eval": _gap(eval_t.numpy(), eval_j),
            "train": _gap(out_t.detach().numpy(), out_j)}
    assert max(gaps.values()) <= FWD, gaps
    stats_t = state_dict_to_flax(net, {k: v for k, v in
                                       net.state_dict().items()
                                       if "running" in k})[1]
    stat_gaps = _leaf_gaps(stats_t, jax.device_get(stats_j))
    assert max(stat_gaps.values()) <= FWD, stat_gaps
    grad_gaps = _leaf_gaps(_grads_to_flax(net), jax.device_get(g_params))
    grad_gaps["arch"] = _gap(a.grad.numpy(), g_arch)
    assert max(grad_gaps.values()) <= GRAD, sorted(
        grad_gaps.items(), key=lambda kv: -kv[1])[:5]
    assert float(np.abs(g_arch).max()) > 0
    print("encoder 64^2:", gaps, "stats",
          f"{max(stat_gaps.values()):.2e}", "grads",
          f"{max(grad_gaps.values()):.2e}", "arch",
          f"{grad_gaps['arch']:.2e}")


def test_encoder_matches_torch_oracle(encoder64):
    _, variables, arch, x, _ = encoder64
    oracle = TorchSIVAEEncoder(8).eval()
    oracle.load_flax(variables["params"], variables["batch_stats"])
    net = _port_encoder(variables).eval()
    a = torch.from_numpy(arch)
    with torch.no_grad():
        want = torch.cat(oracle(_nchw(x), a), -1).numpy()
        got = torch.cat(net(_nchw(x), a), -1).numpy()
    assert _gap(got, want) <= FWD


def test_encoder_at_256_reads_the_fc_in_nhwc_order():
    """At 256^2 the pooled map is 2x2x256: the fc heads take 1,024 inputs
    in the JAX package's (h, w, c) order."""
    enc = J.ResNet18Encoder(latent_dim=8, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 256, 256, 3)).astype(np.float32)
    arch = (0.5 * rng.normal(size=(10, 3))).astype(np.float32)

    variables = random_variables(enc, jnp.asarray(x), arch, train=False,
                                 seed=5)
    want = np.asarray(jax.jit(lambda v: jnp.concatenate(enc.apply(
        v, jnp.asarray(x), arch, train=False), -1))(variables))
    assert variables["params"]["fc_mu"]["kernel"].shape == (1024, 8)
    net = _port_encoder(variables, 256).eval()
    with torch.no_grad():
        got = torch.cat(net(_nchw(x), torch.from_numpy(arch)), -1).numpy()
    gap = _gap(got, want)
    print(f"encoder 256^2 eval forward: {gap:.2e} of the largest")
    assert gap <= FWD


# -- the decoder ---------------------------------------------------------------

@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_decoder_matches_jax(norm):
    dec = J.GUnetAddInput(output_nc=3, nz=8, num_downs=5, ngf=8, norm=norm,
                          dtype=jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(2, 8)).astype(np.float32)
    readout = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = random_variables(dec, jnp.asarray(x), jnp.asarray(z),
                                 train=False, seed=7)
    stats = variables.get("batch_stats", {})

    def loss(params):
        y, mut = dec.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), jnp.asarray(z), train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y * readout), y

    (_, y_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    net = T.GUnetAddInput(3, 3, 8, 5, 8, norm=norm).train()
    load_flax(net, variables["params"], stats)
    y_t = net(_nchw(x), torch.from_numpy(z))
    (y_t * _nchw(readout)).sum().backward()
    fwd = _gap(_nhwc(y_t), y_j)
    g_t, g_j = _grads_to_flax(net), jax.device_get(g_j)
    # a conv that a norm follows: its bias's gradient is 0 in exact
    # arithmetic, so each package's is rounding noise, held within GRAD
    # of the net's largest gradient
    normed = {f"down{d}" for d in range(1, 4)} | {f"up{d}"
                                                 for d in range(1, 5)}
    top = max(float(np.abs(v).max()) for v in jax.tree.leaves(g_j))
    noise = 0.0
    for name in normed:
        for tree in (g_t, g_j):
            noise = max(noise, float(np.abs(tree[name]["bias"]).max()) / top)
        del g_t[name]["bias"], g_j[name]["bias"]
    grads = _leaf_gaps(g_t, g_j)
    print(f"decoder ({norm}): forward {fwd:.2e}, gradients "
          f"{max(grads.values()):.2e}, normed biases {noise:.2e}")
    assert fwd <= FWD
    assert noise <= GRAD
    assert max(grads.values()) <= GRAD, sorted(
        grads.items(), key=lambda kv: -kv[1])[:5]
    if norm == "instance":
        oracle = TorchGUnetAddInput(3, 3, 8, 5, 8, norm)
        oracle.load_flax(variables["params"], stats)
        with torch.no_grad():
            want = oracle(_nchw(x), torch.from_numpy(z)).numpy()
        assert _gap(y_t.detach().numpy(), want) <= FWD


def test_multiscale_discriminator_matches_jax():
    d = J.DNLayersMulti(ndf=8, n_layers=2, num_D=2, dtype=jnp.float32)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 33, 33, 3)).astype(np.float32)

    variables = random_variables(d, jnp.asarray(x), train=False, seed=9)
    outs, _ = jax.device_get(jax.jit(lambda v: d.apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"]))(variables))
    net = T.DNLayersMulti(3, 8, 2, 2).train()
    load_flax(net, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = net(_nchw(x))
    assert len(got) == len(outs) == 2
    for g, w in zip(got, outs):
        assert _nhwc(g).shape == w.shape
        assert _gap(_nhwc(g), w) <= FWD


def test_soft_intro_vae_container_and_bridge():
    """The decoder depth is log2 of netG's size (at least 3), and the JAX
    ``SoftIntroVAE``'s variables load into the port's whole."""
    jm = J.SoftIntroVAE(latent_dim=4, output_nc=3, ngf=4, netG="unet_32",
                        dtype=jnp.float32)
    v = random_tree(jax.eval_shape(lambda: jm.init(jax.random.key(0), 32)))
    vae = T.SoftIntroVAE(4, 3, 4, "unet_32")
    assert vae.decoder.nd == jm.decoder.num_downs == 5
    assert T.SoftIntroVAE(4, 3, 4, "unet_4").decoder.nd == 3
    load_sivae_flax(vae, v)
    np.testing.assert_array_equal(vae.arch.numpy(), v["arch"])
    rng = np.random.default_rng(10)
    a = rng.random((2, 32, 32, 3)).astype(np.float32)
    zs = rng.normal(size=(2, 4)).astype(np.float32)
    want = jax.jit(jm.decoder.apply)(v["dec"], jnp.asarray(a),
                                     jnp.asarray(zs))
    with torch.no_grad():
        got = vae.eval().decoder(_nchw(a), torch.from_numpy(zs))
    assert _gap(_nhwc(got), want) <= FWD
