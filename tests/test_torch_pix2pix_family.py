"""The rest of the pix2pix family in the port against the JAX package, on
the CPU in float32:

- wgangp: ``gan_loss`` within 1e-6 relative; ``gradient_penalty`` of the
  kinds real, fake and mixed (JAX's ``alpha`` draws injected) on a 3-layer
  PatchGAN at ndf 4 within 1e-5 relative, and the mixed penalty's gradient
  with respect to D's weights within 1e-5 of each leaf's largest;
- the image pool: the same answers as the JAX ``ImagePool`` from the same
  seed, bit for bit;
- ``utils/serialization``: what flax's ``to_bytes`` writes (float32,
  bfloat16, int32, uint8, numpy scalars, numbers, strings, nesting, and
  the chunked form of an array over the chunk size) read back exactly;
  ``save_pytree``'s bytes equal to ``to_bytes``' and read back by flax,
  bf16 included;
- the stage-1 checkpoints: the port's ``.msgpack`` pair (``save_pytree``
  over ``state_dict_to_flax``) loads into the JAX ``load_model`` and the
  JAX ``save_model`` pair into the port's ``load_model``, every leaf
  exact; the reference's ``.pkl`` pair
  (``tests/test_pix2pix_port.py``'s naming-exact generator) through the
  port's ``load_model`` gives G's output within 1e-5 of the JAX
  ``_load_torch_pkl``'s and of the reference module's;
- colorization: the preset's fields and the ``pix2pix_colorization``
  dataset's arrays equal to the JAX package's, bit for bit;
- the stage-1 sample grids (mask / fake / real, and the L / real RGB /
  fake RGB of colorization) and the report rows of ``test_pix2pix``, from
  the same arrays, bit for bit against the JAX package's construction;
  a colorization ``train`` writes ``samples/step<n>.png``;
- the flagship's validation panel with JAX's affine draws: the fake mask
  identical, the fake image within 1e-5;
- ``test_pix2pix.run`` on the setup of
  ``tests/test_colorization_pix2pix.py:56-77`` from a JAX ``.msgpack``
  checkpoint: the same ``index.html`` and image files as the JAX run, the
  input and target images bit for bit, the fakes within one level of 255.

The JAX weights are drawn from ``jax.eval_shape``'s shapes (no flax init
compiled). The worst gaps are printed (``-s``)."""
import contextlib
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semantic_segmentation_tpu.core.config import \
    parse_config as jparse_config
from semantic_segmentation_tpu.data import make_dataset as jmake_dataset
from semantic_segmentation_tpu.data import stack_dataset as jstack
from semantic_segmentation_tpu.data.extra import lab_to_rgb as jlab_to_rgb
from semantic_segmentation_tpu.models.pix2pix.model import Pix2Pix as JPix2Pix
from semantic_segmentation_tpu.models.pix2pix.networks import \
    NLayerDiscriminator as JD
from semantic_segmentation_tpu.ops import augment as jaug
from semantic_segmentation_tpu.ops import losses as jlosses
from semantic_segmentation_tpu.train import test_pix2pix as jtest_pix2pix
from semantic_segmentation_tpu.train import train_end2end as jtrain_end2end
from semantic_segmentation_tpu.train import train_pix2pix as jtrain_pix2pix
from semantic_segmentation_tpu.utils import visuals as jvisuals
from semantic_segmentation_tpu.utils.image_pool import ImagePool as JPool
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.folder import make_dataset
from semantic_segmentation_torch.data.pipeline import (batch_iterator,
                                                       stack_dataset)
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.models.pix2pix.networks import \
    NLayerDiscriminator
from semantic_segmentation_torch.ops import losses
from semantic_segmentation_torch.train import test_pix2pix, train_pix2pix
from semantic_segmentation_torch.train.train_end2end import (
    panel_fakes, save_validation_panels)
from semantic_segmentation_torch.utils import serialization as ser
from semantic_segmentation_torch.utils.bridge import (arch_to_flax,
                                                      load_flax,
                                                      state_dict_to_flax)
from semantic_segmentation_torch.utils.image_pool import ImagePool
from semantic_segmentation_torch.utils.visuals import save_image_grid
from tests.test_pix2pix_port import RefUnetG, _randomize
from tests.test_torch_sivae_nets import random_tree
from tests.test_torch_vqgan import gap, nchw, nhwc


# -- wgangp -------------------------------------------------------------------

@pytest.mark.parametrize("real", [True, False])
def test_wgangp_gan_loss(real):
    pred = np.random.default_rng(0).normal(size=(2, 3, 3, 1)).astype(
        np.float32)
    j = float(jlosses.gan_loss(jnp.asarray(pred), real, "wgangp"))
    t = float(losses.gan_loss(torch.from_numpy(pred), real, "wgangp"))
    assert abs(t - j) <= 1e-6 * abs(j)
    assert (t < 0) == (real == (pred.mean() > 0))


@pytest.fixture(scope="module")
def patchgan():
    jd = JD(ndf=4, n_layers=3, dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 2))
    v = random_tree(jax.eval_shape(lambda: jd.init(jax.random.key(0), x)),
                    seed=3)
    td = NLayerDiscriminator(2, 4, 3).eval()
    load_flax(td, v["params"], v["batch_stats"])
    rng = np.random.default_rng(1)
    real, fake = (rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.key(4)

    def jgp(params, kind):
        return jlosses.gradient_penalty(
            lambda x: jd.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, x),
            jnp.asarray(real), jnp.asarray(fake), key, kind)

    # the three kinds and the mixed one's D gradient in one JAX program
    want = jax.device_get(jax.jit(lambda p: (
        {k: jgp(p, k) for k in ("real", "fake", "mixed")},
        jax.grad(jgp)(p, "mixed")))(v["params"]))
    return key, want, td, real, fake


@pytest.mark.parametrize("kind", ["real", "fake", "mixed"])
def test_gradient_penalty(patchgan, kind):
    key, (values, jg), td, real, fake = patchgan
    want = float(values[kind])
    alpha = torch.from_numpy(np.asarray(jax.random.uniform(
        key, (2, 1, 1, 1)))) if kind == "mixed" else None
    td.zero_grad()
    got = losses.gradient_penalty(td, nchw(real), nchw(fake), kind,
                                  alpha=alpha)
    rel = abs(float(got.detach()) - want) / abs(want)
    print(f"gradient_penalty({kind}) gap {rel:.2e}")
    assert rel <= 1e-5
    if kind == "mixed":
        got.backward()
        # None: a BN shift, which moves no input gradient in eval mode
        tg, _ = state_dict_to_flax(td, {
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in td.named_parameters()})
        worst = max(jax.tree.leaves(jax.tree.map(gap, tg, jg)))
        print(f"gradient_penalty's D gradient gap {worst:.2e}")
        assert worst <= 1e-5


# -- the image pool -----------------------------------------------------------

@pytest.mark.parametrize("size", [0, 3])
def test_image_pool(size):
    rng = np.random.default_rng(2)
    jp, tp = JPool(size, seed=5), ImagePool(size, seed=5)
    for _ in range(5):
        batch = rng.random((2, 4, 4, 1)).astype(np.float32)
        np.testing.assert_array_equal(tp.query(batch), jp.query(batch))
    assert len(tp.images) == len(jp.images) == size


# -- serialization ------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(3)
    return {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4))
                                .astype(np.float32),
                                "bias": np.asarray(jnp.asarray(
                                    rng.normal(size=(4,)), jnp.bfloat16))},
                       "ids": rng.integers(-5, 5, (2, 2)).astype(np.int32),
                       "u8": rng.integers(0, 255, (7,)).astype(np.uint8)},
            "step": np.int32(12), "lr": np.float32(2e-4), "count": 300,
            "neg": -70000, "ratio": 0.25, "name": "x" * 40, "flag": True,
            "empty": {}}


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        assert tuple(got.shape) == w.shape
        if w.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), w)
            assert got.numpy().dtype == w.dtype
    else:
        assert got == want and type(got) is type(want)


def test_msgpack_reads_flax(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(fser.to_bytes(tree))
    _same(ser.load_pytree(path), tree)


def test_msgpack_writes_flax(tmp_path):
    tree = _tree()
    assert ser.dumps(tree) == fser.to_bytes(tree)
    # tensors, bf16 among them, read back by flax
    t = {"w": torch.randn(3, 5), "b": torch.randn(4).bfloat16(),
         "n": {"i": torch.arange(6, dtype=torch.int64).reshape(2, 3)}}
    path = str(tmp_path / "t.msgpack")
    ser.save_pytree(t, path)
    with open(path, "rb") as f:
        back = fser.msgpack_restore(f.read())
    np.testing.assert_array_equal(back["w"], t["w"].numpy())
    assert back["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(back["b"].view(np.int16),
                                  t["b"].view(torch.int16).numpy())
    np.testing.assert_array_equal(back["n"]["i"], t["n"]["i"].numpy())


def test_msgpack_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "bf": np.asarray(jnp.arange(70, dtype=jnp.bfloat16)),
            "small": np.ones(3, np.float32)}
    data = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _same(ser.loads(data), tree)
    assert ser.dumps(tree) == data
    back = fser.msgpack_restore(ser.dumps(tree))
    np.testing.assert_array_equal(back["big"], tree["big"])


# -- stage-1 checkpoints ------------------------------------------------------

def jax_state(jm, size: int = 32, seed: int = 0):
    """A JAX Pix2Pix state of random weights from ``eval_shape``'s
    shapes (zero optimizer states)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), size))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rng = np.random.default_rng(seed)
    return zeros.replace(
        g_params=random_tree(shapes.g_params, seed + 1),
        g_stats=random_tree(shapes.g_stats, seed + 2),
        d_params=random_tree(shapes.d_params, seed + 3),
        d_stats=random_tree(shapes.d_stats, seed + 4),
        arch={k: (0.5 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in shapes.arch.items()})


def port_of(jm_kwargs: dict, state) -> Pix2Pix:
    tm = Pix2Pix(jm_kwargs.get("input_nc", 1), jm_kwargs.get("output_nc", 1),
                 8, 8, "unet_32", use_dropout=False)
    load_flax(tm.G, state.g_params, state.g_stats)
    load_flax(tm.D, state.d_params, state.d_stats)
    with torch.no_grad():
        for k, v in tm.arch.items():
            v.copy_(torch.from_numpy(np.asarray(state.arch[k])))
    return tm


JKW = dict(input_nc=1, output_nc=1, ngf=8, ndf=8, netG="unet_32",
           use_dropout=False, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def p2p():
    jm = JPix2Pix(**JKW)
    state = jax_state(jm)
    return jm, state, port_of(JKW, state)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def write_jax_pair(model, save_dir):
    """The JAX package's ``save_model`` files of ``model``, written by the
    port: ``pix2pix_generator.msgpack`` ({'g_params', 'g_stats', 'arch'})
    and ``pix2pix_discriminator.msgpack`` ({'d_params', 'd_stats'})."""
    save_dir.mkdir(parents=True)
    g_params, g_stats = state_dict_to_flax(model.G, model.G.state_dict())
    d_params, d_stats = state_dict_to_flax(model.D, model.D.state_dict())
    ser.save_pytree({"g_params": g_params, "g_stats": g_stats,
                     "arch": arch_to_flax(model.arch)},
                    str(save_dir / train_pix2pix.JAX_FILES[0]))
    ser.save_pytree({"d_params": d_params, "d_stats": d_stats},
                    str(save_dir / train_pix2pix.JAX_FILES[1]))


def test_msgpack_checkpoints_both_ways(p2p, tmp_path):
    jm, state, tm = p2p
    # the port's pair into the JAX load_model
    write_jax_pair(tm, tmp_path / "port")
    got = jtrain_pix2pix.load_model(jax.tree.map(np.zeros_like, state),
                                    str(tmp_path / "port"))
    for field in ("g_params", "g_stats", "d_params", "d_stats", "arch"):
        for a, b in zip(_leaves(getattr(got, field)),
                        _leaves(getattr(state, field))):
            np.testing.assert_array_equal(a, b)
    # the JAX pair into the port's load_model (no .pt beside it)
    jtrain_pix2pix.save_model(state, str(tmp_path / "jax"))
    fresh = Pix2Pix(1, 1, 8, 8, "unet_32", use_dropout=False)
    train_pix2pix.load_model(fresh, str(tmp_path / "jax"))
    for net in ("G", "D"):
        want = getattr(tm, net).state_dict()
        for k, v in getattr(fresh, net).state_dict().items():
            assert torch.equal(v, want[k]), (net, k)
    for k, v in fresh.arch.items():
        assert torch.equal(v, tm.arch[k])


def _ref_d(ndf=8, n_layers=3):
    import torch.nn as nn
    seq = [nn.Conv2d(2, ndf, 4, 2, 1), nn.LeakyReLU(0.2, True)]
    nf_prev = 1
    for n in range(1, n_layers):
        nf = min(2 ** n, 8)
        seq += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 2, 1, bias=False),
                nn.BatchNorm2d(ndf * nf), nn.LeakyReLU(0.2, True)]
        nf_prev = nf
    nf = min(2 ** n_layers, 8)
    seq += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 1, 1, bias=False),
            nn.BatchNorm2d(ndf * nf), nn.LeakyReLU(0.2, True),
            nn.Conv2d(ndf * nf, 1, 4, 1, 1)]
    return nn.Sequential(*seq)


def test_reference_pkl(p2p, tmp_path):
    jm, state, _ = p2p
    arch = torch.from_numpy(np.asarray(state.arch["upconv"]))
    ref_g = RefUnetG(1, 1, 5, 8, arch)
    _randomize(ref_g, 21)
    ref_g.eval()
    torch.save({"module." + k: v for k, v in ref_g.state_dict().items()},
               str(tmp_path / "pix2pix_generator.pkl"))
    ref_d = _ref_d()
    _randomize(ref_d, 22)
    ref_d.eval()
    torch.save({"module.model." + k: v for k, v in
                ref_d.state_dict().items()},
               str(tmp_path / "pix2pix_discriminator.pkl"))
    jstate = jtrain_pix2pix.load_model(state, str(tmp_path))
    tm = Pix2Pix(1, 1, 8, 8, "unet_32", use_dropout=False)
    before = {k: v.clone() for k, v in tm.arch.items()}
    train_pix2pix.load_model(tm, str(tmp_path))
    for k, v in tm.arch.items():          # not in the reference's files
        assert torch.equal(v, before[k])
    with torch.no_grad():
        tm.arch["upconv"].copy_(arch)
    mask = np.random.default_rng(9).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jm.generate(jstate, jnp.asarray(mask)))
    got = tm.generate(torch.from_numpy(mask)).numpy()
    with torch.no_grad():
        ref = nhwc(ref_g(nchw(mask)))
        ref_logits = ref_d(torch.cat([nchw(mask), nchw(mask)], 1))
        tm.D.eval()
        logits = tm.D(torch.cat([nchw(mask), nchw(mask)], 1))
    g_jax, g_ref = gap(got, want), gap(got, ref)
    print(f".pkl load: G against the JAX package {g_jax:.2e}, against the "
          f"reference module {g_ref:.2e}")
    assert g_jax <= 1e-5 and g_ref <= 1e-5
    assert gap(logits.numpy(), ref_logits.numpy()) <= 1e-5


# -- colorization -------------------------------------------------------------

@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "Images"
    d.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8),
                        "RGB").save(d / f"img{i}.png")
    return tmp_path


def test_colorization_preset_and_dataset(image_dir):
    j = jparse_config([], preset="pix2pix_colorization")
    t = parse_config([], preset="pix2pix_colorization")
    for path in ("data.dataset", "model.input_nc", "model.output_nc",
                 "optim.lr", "run.name"):
        sec, leaf = path.split(".")
        assert getattr(getattr(t, sec), leaf) == \
            getattr(getattr(j, sec), leaf), path
    jds = jmake_dataset("pix2pix_colorization", str(image_dir),
                        image_size=32)
    tds = make_dataset("pix2pix_colorization", str(image_dir),
                       image_size=32)
    assert len(tds) == len(jds) == 4
    a, b = jstack(jds), stack_dataset(tds)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype
        np.testing.assert_array_equal(b[k], a[k])
    assert b["mask_pix2pix"].shape == (4, 32, 32, 1)
    assert b["image_pix2pix"].shape == (4, 32, 32, 2)


def _jax_panel(mask, fake, image, output_nc):
    """The JAX trainer's inline panel (train/train_pix2pix.py:77-90)."""
    if output_nc == 2:
        L = mask.astype(np.float32)
        real_rgb = jlab_to_rgb(np.concatenate([L, image], axis=-1))
        fake_rgb = jlab_to_rgb(np.concatenate(
            [L, np.clip(np.asarray(fake, np.float32), 0, 1)], axis=-1))
        return [np.repeat(L, 3, axis=-1), real_rgb.astype(np.float32),
                fake_rgb.astype(np.float32)]
    return [mask.astype(np.float32), np.asarray(fake), image]


def _png(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("output_nc", [1, 2])
def test_sample_grid_and_report_row(output_nc, tmp_path):
    rng = np.random.default_rng(output_nc)
    mask = rng.random((16, 16, 1)).astype(np.float32)
    fake = (rng.random((16, 16, output_nc)) * 2.2 - 1.1).astype(np.float32)
    image = rng.random((16, 16, output_nc)).astype(np.float32)
    save_image_grid(train_pix2pix.sample_panel(mask, fake, image,
                                               output_nc),
                    str(tmp_path / "t.png"), cols=3)
    jvisuals.save_image_grid(_jax_panel(mask, fake, image, output_nc),
                             str(tmp_path / "j.png"), cols=3)
    np.testing.assert_array_equal(_png(tmp_path / "t.png"),
                                  _png(tmp_path / "j.png"))
    # the report row of test_pix2pix (JAX train/test_pix2pix.py:45-58)
    row = test_pix2pix.report_row(mask, fake, image, output_nc)
    want = {"real": mask, "fake": fake}
    target = image
    if output_nc == 2:
        want["fake"] = jlab_to_rgb(np.concatenate(
            [mask, np.clip(fake, 0.0, 1.0)], axis=-1)).astype(np.float32)
        target = jlab_to_rgb(np.concatenate([mask, image], axis=-1)
                             ).astype(np.float32)
    want["target"] = target
    assert list(row) == list(want)
    for k in want:
        np.testing.assert_array_equal(row[k], want[k])


def test_colorization_train_writes_grids(image_dir, tmp_path):
    argv = [f"--data.dataroot={image_dir}", "--data.image_size=32",
            "--data.n_train=2", "--data.n_val=1", "--data.n_test=1",
            "--data.batch_size=1", "--model.netG=unet_32", "--model.ngf=8",
            "--model.ndf=8", "--model.compute_dtype=float32",
            f"--run.save_dir={tmp_path / 'ckpt'}", "--run.log_every=1",
            "--run.device=cpu"]
    cfg = parse_config(argv, preset="pix2pix_colorization")
    model, results = train_pix2pix.train(cfg, train_iters=2)
    save_dir = tmp_path / "ckpt" / cfg.run.name
    assert results["steps"] == 2
    grid = _png(save_dir / "samples" / "step1.png")
    assert grid.shape == (32, 96, 3)
    # the L and real-RGB panels of the first logged batch, as the JAX
    # trainer draws and renders it
    from semantic_segmentation_torch.train.common import load_splits
    first = next(batch_iterator(load_splits(cfg)["train"], 1,
                                np.random.default_rng((cfg.run.seed, 0))))
    panel = _jax_panel(first["mask_pix2pix"][0],
                       np.zeros((32, 32, 2), np.float32),
                       first["image_pix2pix"][0], 2)
    jvisuals.save_image_grid(panel, str(tmp_path / "j.png"), cols=3)
    np.testing.assert_array_equal(grid[:, :64], _png(tmp_path / "j.png")
                                  [:, :64])
    assert (save_dir / "samples" / "step2.png").exists()
    assert (save_dir / train_pix2pix.GENERATOR_FILE).exists()


# -- the flagship's validation panel ------------------------------------------

class _Log:
    def __init__(self):
        self.images = []

    def log_images(self, images, step=None):
        self.images.append((step, sorted(images)))


def test_validation_panel_with_jax_draws(p2p, tmp_path):
    jm, state, tm = p2p
    rng = np.random.default_rng(11)
    masks = (rng.random((1, 32, 32, 1)) > 0.6).astype(np.float32)
    key = jax.random.key(13)
    jmask, jimage = jtrain_end2end._panel_fakes(
        jm, state.g_params, state.g_stats, state.arch["upconv"],
        jnp.asarray(masks), key)
    mats = torch.from_numpy(np.asarray(jaug.sample_affine_batch(
        key, 1, 32, 32)))
    tmask, timage = panel_fakes(tm, torch.from_numpy(masks),
                                contextlib.nullcontext, mats)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    g = gap(timage.numpy(), jimage)
    print(f"panel fake image gap {g:.2e}")
    assert g <= 1e-5
    log = _Log()
    val = {"image": torch.from_numpy(rng.random((2, 32, 32, 1)).astype(
        np.float32)), "mask": torch.from_numpy(masks.repeat(2, 0))}
    panels = save_validation_panels(tm, val, 9, str(tmp_path), log,
                                    contextlib.nullcontext, mats)
    assert log.images == [(9, sorted(panels))]
    np.testing.assert_array_equal(panels["show_fake_mask"], tmask[0].numpy())
    assert _png(tmp_path / "panels" / "it9.png").shape == (32, 128)


# -- test_pix2pix -------------------------------------------------------------

def test_test_pix2pix_report_from_a_jax_checkpoint(image_dir, tmp_path,
                                                   monkeypatch):
    ckpt = str(tmp_path / "jax_ckpt")
    argv = [f"--data.dataroot={image_dir}", "--data.image_size=32",
            "--data.n_train=2", "--data.n_val=1", "--data.n_test=1",
            "--data.batch_size=1", "--model.netG=unet_32", "--model.ngf=8",
            "--model.ndf=8", "--model.compute_dtype=float32",
            f"--run.pretrained_pix2pix={ckpt}", "--run.log_every=1"]
    jcfg = jparse_config(argv + [f"--run.save_dir={tmp_path / 'j'}"],
                         preset="pix2pix_colorization")
    jm = jtrain_pix2pix.build_pix2pix(jcfg)
    jtrain_pix2pix.save_model(jax_state(jm, seed=5), ckpt)
    # the JAX run's fresh init is replaced whole by the checkpoint: zeros
    # of its shapes stand in for it (no flax init compiled)
    init = JPix2Pix.init
    monkeypatch.setattr(JPix2Pix, "init", lambda self, rng, size: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: init(self, rng, size))))
    jout = jtest_pix2pix.run(jcfg, limit=3)
    tcfg = parse_config(argv + [f"--run.save_dir={tmp_path / 't'}",
                                "--run.device=cpu"],
                        preset="pix2pix_colorization")
    tout = test_pix2pix.run(tcfg, limit=3)
    with open(os.path.join(jout, "index.html")) as f:
        jhtml = f.read()
    with open(os.path.join(tout, "index.html")) as f:
        assert f.read() == jhtml
    names = sorted(os.listdir(os.path.join(jout, "images")))
    assert names == sorted(os.listdir(os.path.join(tout, "images")))
    assert len(names) == 9
    worst = 0
    for n in names:
        a = _png(os.path.join(tout, "images", n)).astype(int)
        b = _png(os.path.join(jout, "images", n)).astype(int)
        if n.endswith("_fake.png"):
            worst = max(worst, int(np.abs(a - b).max()))
        else:
            np.testing.assert_array_equal(a, b)
    print(f"test_pix2pix fakes: at most {worst} level(s) apart")
    assert worst <= 1
