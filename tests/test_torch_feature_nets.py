"""The port's feature nets and generative metrics against the JAX
package's (``models/vgg.py``, ``models/extractors.py``,
``ops/gen_metrics.py``) and the torch oracles of ``tests/torch_oracles.py``,
on random weights (the real VGG16, AlexNet, LPIPS and Inception weights
are not in the repository), f32, NCHW nets against NHWC:

- ``VGG16Features``' five taps at 32^2 within 1e-5 of each tap's largest
  magnitude, ``vgg_lpips`` and ``vgg_perceptual_loss`` within 1e-5
  relative;
- ``AlexNetFeatures``' taps and ``lpips_alex`` at 64^2 within 1e-5 (and
  ``lpips_alex`` against ``TorchAlexLPIPS`` on its own weights, mapped by
  ``port_alexnet_lpips``);
- each Inception block, A to E (E with its 'avg' and 'max' pools), at
  9^2 with 32 input channels and random BN statistics, within 1e-5 of the
  largest output (and InceptionA against ``TorchInceptionA``, mapped by
  ``port_inception_v3``);
- the 299^2 resize from 256^2 (upsampling) and from 320^2 (downsampling,
  where ``jax.image.resize`` antialiases): JAX's weight matrices bit for
  bit, the output within 1e-6 of their exact contraction and within 2e-5
  of ``jax.image.resize`` (whose float32 contraction is 1.2e-5 from
  exact);
- ``InceptionV3Pool3`` whole, once at batch 1 from 64^2, within 1e-5 of
  the largest feature;
- the ``port_*`` key maps on state dicts written from torch modules;
- ``frechet_distance`` against the JAX package's, 0 for identical sets;
- FID and LPIPS through ``train_bbdm.evaluate_samples``: LPIPS within
  1e-5 relative of the JAX package's ``evaluate_samples``, the FID's
  inputs the port's own pool3 features.

The JAX variables are drawn from ``jax.eval_shape``'s shapes
(``tests/test_torch_sivae_nets.random_variables``: flax's init of the
Inception net compiles for 19 s on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from semantic_segmentation_tpu.models import extractors as JX
from semantic_segmentation_tpu.models import vgg as JV
from semantic_segmentation_tpu.ops import gen_metrics as jgm
from semantic_segmentation_torch.models import extractors as TX
from semantic_segmentation_torch.models import vgg as TV
from semantic_segmentation_torch.ops import gen_metrics as tgm
from semantic_segmentation_torch.train.train_bbdm import evaluate_samples
from semantic_segmentation_torch.utils import torch_port
from semantic_segmentation_torch.utils.bridge import load_flax
from tests.test_torch_sivae_nets import _gap, _nchw, random_variables
from tests.torch_oracles import TorchAlexLPIPS, TorchInceptionA

FWD = 1e-5


def _port(net, variables):
    load_flax(net, variables["params"], variables.get("batch_stats", {}))
    return net.eval()


def _lins(widths, seed=0):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(w,))).astype(np.float32)
            for w in widths]


# -- VGG16 ---------------------------------------------------------------------

def test_vgg16_taps_lpips_and_perceptual_loss_match_jax():
    rng = np.random.default_rng(0)
    x = (2 * rng.random((2, 32, 32, 3)) - 1).astype(np.float32)
    y = (2 * rng.random((2, 32, 32, 3)) - 1).astype(np.float32)
    jnet = JV.VGG16Features(dtype=jnp.float32)
    v = random_variables(jnet, jnp.asarray(x))
    lins = _lins((64, 128, 256, 512, 512))
    taps_j, lp_j, pl_j = jax.device_get(jax.jit(lambda v: (
        jnet.apply(v, x), JV.vgg_lpips(v["params"], lins, x, y),
        JV.vgg_perceptual_loss(jnet.apply(v, x), jnet.apply(v, y))))(v))
    net = _port(TV.VGG16Features(), v)
    with torch.no_grad():
        taps_t = net(_nchw(x))
        lp_t = TV.vgg_lpips(net, lins, torch.from_numpy(x),
                            torch.from_numpy(y))
        pl_t = TV.vgg_perceptual_loss(taps_t, net(_nchw(y)))
    assert len(taps_t) == 5
    for a, b in zip(taps_t, taps_j):
        assert _gap(np.moveaxis(a.numpy(), 1, -1), b) <= FWD
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=FWD)
    np.testing.assert_allclose(float(pl_t), float(pl_j), rtol=FWD)
    assert float(TV.vgg_perceptual_loss(taps_t, taps_t)) == 0.0


def test_port_vgg16_features_and_lins():
    """torchvision's ``vgg16().features`` layout (``features.N`` and bare
    ``N`` keys) maps onto ``VGG16Features``, the taps equal the torch
    Sequential's relu outputs, and the lpips lins map to vectors."""
    torch.manual_seed(0)
    layers, c_in = [], 3
    for c in TV.CFG:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c_in, c, 3, padding=1), nn.ReLU()]
            c_in = c
    seq = nn.Sequential(*layers).eval()
    x = torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        taps, h, relus = [], x, 0
        for layer in seq:
            h = layer(h)
            relus += isinstance(layer, nn.ReLU)
            if isinstance(layer, nn.ReLU) and relus in TV.TAPS:
                taps.append(h)
        for prefix in ("features.", ""):
            sd = {prefix + k: v for k, v in seq.state_dict().items()}
            net = torch_port.overlay(TV.VGG16Features(),
                                     torch_port.port_vgg16_features(sd))
            for a, b in zip(net(x), taps):
                assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    lins = _lins((64, 128, 256, 512, 512))
    for key in ("lin{}.model.1.weight", "lins.{}.model.1.weight"):
        got = torch_port.port_vgg_lpips({key.format(i): torch.from_numpy(
            w.reshape(1, -1, 1, 1)) for i, w in enumerate(lins)})
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, lins))


# -- AlexNet / LPIPS ---------------------------------------------------------------

def test_alexnet_and_lpips_alex_match_jax():
    rng = np.random.default_rng(1)
    a = rng.random((2, 64, 64, 3)).astype(np.float32)
    b = rng.random((2, 64, 64, 3)).astype(np.float32)
    jnet = JX.AlexNetFeatures()
    v = random_variables(jnet, jnp.asarray(a), seed=1)
    lins = _lins(TX.ALEX_WIDTHS, 1)
    feats_j, lp_j = jax.device_get(jax.jit(lambda v: (
        jnet.apply(v, a), JX.lpips_alex(v["params"], lins, a, b)))(v))
    net = _port(TX.AlexNetFeatures(), v)
    with torch.no_grad():
        feats_t = net(_nchw(a))
        lp_t = TX.lpips_alex(net, lins, torch.from_numpy(a),
                             torch.from_numpy(b))
    for f_t, f_j in zip(feats_t, feats_j):
        assert _gap(np.moveaxis(f_t.numpy(), 1, -1), f_j) <= FWD
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=FWD)


def test_port_alexnet_lpips_against_the_torch_oracle():
    torch.manual_seed(1)
    oracle = TorchAlexLPIPS().eval()
    lins = _lins(TX.ALEX_WIDTHS, 2)
    ported, lins_t = torch_port.port_alexnet_lpips(
        oracle.state_dict(), {f"lin{i}.model.1.weight": torch.from_numpy(
            w.reshape(1, -1, 1, 1)) for i, w in enumerate(lins)})
    net = torch_port.overlay(TX.AlexNetFeatures(), ported)
    rng = np.random.default_rng(2)
    a = rng.random((2, 64, 64, 3)).astype(np.float32)
    b = rng.random((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = oracle.lpips(_nchw(a), _nchw(b), lins).numpy()
        got = tgm.lpips(net, lins_t, a, b, batch_size=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    _, uniform = torch_port.port_alexnet_lpips(oracle.state_dict())
    np.testing.assert_allclose([float(u[0]) for u in uniform],
                               [1.0 / w for w in TX.ALEX_WIDTHS], rtol=1e-7)


# -- Inception ---------------------------------------------------------------------

BLOCKS = {"A": (lambda c: JX.InceptionA(16), lambda c: TX.InceptionA(c, 16)),
          "B": (lambda c: JX.InceptionB(), TX.InceptionB),
          "C": (lambda c: JX.InceptionC(16), lambda c: TX.InceptionC(c, 16)),
          "D": (lambda c: JX.InceptionD(), TX.InceptionD),
          "E_avg": (lambda c: JX.InceptionE("avg"),
                    lambda c: TX.InceptionE(c, "avg")),
          "E_max": (lambda c: JX.InceptionE("max"),
                    lambda c: TX.InceptionE(c, "max"))}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_inception_block_matches_jax(block):
    """At 9^2 (odd: the valid-count pools' border counts, the stride-2
    branches' floor) with random BN statistics."""
    make_j, make_t = BLOCKS[block]
    x = np.random.default_rng(3).random((2, 9, 9, 32)).astype(np.float32)
    jnet = make_j(32)
    v = random_variables(jnet, jnp.asarray(x), seed=3)
    want = np.asarray(jax.jit(jnet.apply)(v, jnp.asarray(x)))
    net = _port(make_t(32), v)
    with torch.no_grad():
        got = np.moveaxis(net(_nchw(x)).numpy(), 1, -1)
    assert got.shape == want.shape
    assert _gap(got, want) <= FWD


def test_port_inception_v3_against_the_torch_oracle():
    """``TorchInceptionA`` as Mixed_5b (192 -> 256 channels): its
    torchvision-layout keys map onto ``InceptionV3Pool3`` by name,
    ``num_batches_tracked``, ``fc`` and ``AuxLogits`` dropped."""
    torch.manual_seed(4)
    oracle = TorchInceptionA(192, 32).eval()
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = {f"Mixed_5b.{k}": v for k, v in oracle.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(1, 1, 1, 1)
    ported = torch_port.port_inception_v3(sd)
    assert not any("num_batches" in k or k.startswith(("fc", "Aux"))
                   for k in ported)
    net = torch_port.overlay(TX.InceptionV3Pool3(), ported).eval()
    x = torch.rand(2, 192, 9, 9)
    with torch.no_grad():
        np.testing.assert_allclose(net.Mixed_5b(x).numpy(),
                                   oracle(x).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [256, 320])
def test_resize_to_299_matches_jax(size):
    """Up from 256 and down from 320, where ``jax.image.resize``
    antialiases (a plain bilinear ``F.interpolate`` is 0.13 off there, and
    its float32 antialiased one 1.2e-5). The port builds JAX's float32
    weight matrices (equal to ``compute_weight_mat``'s bit for bit) and
    contracts in float64: within 1e-6 of the float64 contraction of JAX's
    weights, and within 2e-5 of ``jax.image.resize``'s output, whose own
    float32 contraction on XLA:CPU lies 1.2e-5 from that exact
    one."""
    from jax._src.image.scale import (_fill_triangle_kernel,
                                      compute_weight_mat)
    x = np.random.default_rng(size).random((1, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v: jax.image.resize(
        v, (1, 299, 299, 3), "bilinear"))(x))
    w_j = np.asarray(compute_weight_mat(size, 299, 299 / size, 0.0,
                                        _fill_triangle_kernel, True))
    np.testing.assert_array_equal(TX.resize_weights(size, 299).numpy(), w_j)
    exact = np.einsum("nhwc,hy,wx->nyxc", x.astype(np.float64), w_j, w_j,
                      optimize=True)
    got = np.moveaxis(TX.resize_299(_nchw(x)).numpy(), 1, -1)
    gaps = (_gap(got, exact), _gap(got, want))
    print(f"resize {size} -> 299: {gaps[0]:.2e} of the largest from the "
          f"exact contraction, {gaps[1]:.2e} from jax.image.resize")
    assert gaps[0] <= 1e-6 and gaps[1] <= 2e-5


@pytest.fixture(scope="module")
def inception():
    """(JAX net, its variables, the port's net on them)."""
    jnet = JX.InceptionV3Pool3()
    v = random_variables(jnet, jnp.zeros((1, 64, 64, 3)), seed=5)
    return jnet, v, _port(TX.InceptionV3Pool3(), v)


def test_inception_v3_pool3_matches_jax(inception):
    jnet, v, net = inception
    x = np.random.default_rng(5).random((1, 64, 64, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2048)
    gap = _gap(got, want)
    print(f"InceptionV3Pool3 (64^2 -> 299^2): {gap:.2e} of the largest")
    assert gap <= FWD


# -- the metrics ---------------------------------------------------------------------

def test_frechet_distance_matches_jax_and_is_zero_on_identical_sets():
    rng = np.random.default_rng(6)
    fa = rng.normal(size=(16, 8))
    fb = rng.normal(size=(16, 8)) + 0.3
    assert abs(tgm.fid_from_features(fa, fa)) < 1e-6
    assert tgm.fid_from_features(fa, fb) == jgm.fid_from_features(fa, fb)
    feats = [rng.random((2, 4, 4, 6)) for _ in range(2)]
    np.testing.assert_array_equal(
        tgm.lpips_distance(feats[:1], feats[1:]),
        jgm.lpips_distance(feats[:1], feats[1:]))


def test_fid_and_lpips_through_evaluate_samples(inception, monkeypatch):
    """``evaluate_samples``' LPIPS is the JAX package's on the same
    weights; its FID is ``fid_from_features`` of the port's pool3
    features of the first samples and of the reals. That Frechet distance
    takes a 2048 x 2048 ``sqrtm`` (21 s on the CPU), so here the
    features handed to it are recorded and checked, and it returns their
    mean term; its math is held against the JAX package's above."""
    from semantic_segmentation_tpu.train.train_bbdm import \
        evaluate_samples as jevaluate
    _, _, inc = inception
    rng = np.random.default_rng(7)
    samples = rng.random((3, 2, 64, 64, 1)).astype(np.float32)
    reals = rng.random((3, 64, 64, 1)).astype(np.float32)
    jalex = JX.AlexNetFeatures()
    va = random_variables(jalex, jnp.zeros((1, 64, 64, 3)), seed=7)
    lins = _lins(TX.ALEX_WIDTHS, 7)
    alex = (_port(TX.AlexNetFeatures(), va), lins)
    handed = []

    def recorded(fa, fb):
        handed.append((fa, fb))
        return float(np.sum((fa.mean(0) - fb.mean(0)) ** 2))

    monkeypatch.setattr(tgm, "fid_from_features", recorded)
    got = evaluate_samples(samples, reals, inception=inc, alex=alex)
    want = jevaluate(samples, reals, alex=(va["params"], lins))
    assert got["diversity"] == want["diversity"]
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=FWD)
    assert len(handed) == 1 and got["fid"] == recorded(*handed[0]) > 0
    for fed, images in zip(handed[0], (samples[:, 0], reals)):
        assert fed.shape == (3, 2048)
        np.testing.assert_array_equal(
            fed, tgm.inception_features(inc, images, batch_size=2))
    assert evaluate_samples(samples, samples[:, 0], alex=alex)["lpips"] == 0
