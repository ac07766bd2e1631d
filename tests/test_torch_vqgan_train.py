"""The port's ``VQGANTrainer`` (``models/diffusion/vqgan_train.py``) against
the JAX package's, on the CPU in float32:

- ``adopt_weight`` equal; the hinge and vanilla D losses within 1e-6
  relative on the same logits;
- two alternating steps (the autoencoder step, then the D step) from the
  same state: the JAX state's VQ, D and BN statistics drawn from
  ``jax.eval_shape``'s shapes and bridged into the port, with the
  VGG-LPIPS perceptual term on random VGG16 weights and lins, and
  ``disc_start`` 1 so that the first step runs with the adversarial terms
  off and the second with them on: every loss, ``d_weight`` and
  ``disc_factor`` within 1e-5 relative; D's BN running statistics after
  each D step within 1e-6 of their largest; the VQ and D weights after the
  two steps within 1e-5 of each leaf's largest, but for at most 1% of
  the elements, each within 4 lr: where Adam's first steps normalize a
  gradient that is 0 in exact arithmetic (a bias that a one-channel-group
  GroupNorm follows, the attention's key bias) or within rounding of it,
  and rounding picks the sign;
- LPIPS(vgg) of an image with itself is 0.

The net is the tiny VQ of ``tests/test_vqgan_train.py`` (ch 8, ch_mult
(1, 2), one res block, z 3, embed 3, 16 codes, one channel) and D the
3-layer PatchGAN at ndf 8, at 32^2, batch 2. The worst gaps are printed
(``-s``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.diffusion import vqgan_train as JT
from semantic_segmentation_tpu.models.diffusion.vqgan import \
    VQModel as JVQModel
from semantic_segmentation_torch.models import vgg as TV
from semantic_segmentation_torch.models.diffusion import vqgan_train as TT
from semantic_segmentation_torch.models.diffusion.vqgan import VQModel
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      load_vqgan_flax,
                                                      state_dict_to_flax,
                                                      vqgan_state_dict_to_flax)
from tests.test_torch_sivae_nets import random_tree
from tests.test_torch_vqgan import nchw

CFG = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
           embed_dim=3, n_embed=16, out_channels=1)
LR, SIZE, TOL = 1e-3, 32, 1e-5
METRICS = ("aeloss", "d_weight", "disc_factor", "nll_loss", "g_loss",
           "qloss", "discloss")


def test_adopt_weight_and_d_losses():
    for step in (0, 4, 5, 9):
        assert TT.adopt_weight(1.0, step, 5) == float(
            JT.adopt_weight(1.0, jnp.asarray(step), 5))
    rng = np.random.default_rng(4)
    lr_, lf = (rng.normal(size=(2, 5, 5, 1)).astype(np.float32)
               for _ in range(2))
    for jf, tf in ((JT.hinge_d_loss, TT.hinge_d_loss),
                   (JT.vanilla_d_loss, TT.vanilla_d_loss)):
        j = float(jf(lr_, lf))
        t = float(tf(torch.from_numpy(lr_), torch.from_numpy(lf)))
        assert abs(t - j) <= 1e-6 * abs(j), (jf.__name__, t, j)


def _setup():
    """The JAX trainer and a state of random weights, and the port's
    trainer on the same weights."""
    rng = np.random.default_rng(7)
    # VGG16's conv shapes from its config (an eval_shape of its flax init
    # traces for a second)
    widths = [c for c in TV.CFG if c != "M"]
    vgg_params = random_tree({f"conv{i}": {
        "kernel": jax.ShapeDtypeStruct((3, 3, c_in, c), jnp.float32),
        "bias": jax.ShapeDtypeStruct((c,), jnp.float32)}
        for i, (c_in, c) in enumerate(zip([3] + widths[:-1], widths))},
        seed=3)
    lins = [rng.random(w).astype(np.float32) / w
            for w in (64, 128, 256, 512, 512)]
    jvq = JVQModel(dtype=jnp.float32, **CFG)
    jt = JT.VQGANTrainer(jvq, lr=LR, disc_start=1, disc_ndf=8,
                         perceptual=(vgg_params, lins))
    x0 = jnp.zeros((1, SIZE, SIZE, 1))
    vq_params = random_tree(jax.eval_shape(lambda: jvq.init(
        jax.random.key(0), x0)), seed=1)["params"]
    vq_params["quantize"]["embedding"] = 0.5 * rng.normal(
        size=(16, 3)).astype(np.float32)
    dv = random_tree(jax.eval_shape(lambda: jt.disc.init(
        jax.random.key(0), x0, train=False)), seed=2)
    # Adam's initial state is zeros (its count too): drawn from the
    # shapes, no optax init compiled
    zeros = lambda tree: jax.tree.map(  # noqa: E731
        lambda s: jnp.zeros(s.shape, s.dtype), tree)
    state = JT.VQGANTrainState(
        vq_params=vq_params, d_params=dv["params"],
        d_stats=dv["batch_stats"],
        opt_ae=zeros(jax.eval_shape(jt.tx_ae.init, vq_params)),
        opt_disc=zeros(jax.eval_shape(jt.tx_disc.init, dv["params"])),
        step=jnp.zeros((), jnp.int32))

    vgg = TV.VGG16Features()
    load_flax(vgg, vgg_params)
    tvq = load_vqgan_flax(VQModel(**CFG), vq_params)
    tt = TT.VQGANTrainer(tvq, lr=LR, disc_start=1, disc_ndf=8,
                         perceptual=(vgg, [torch.from_numpy(w)
                                           for w in lins]))
    load_flax(tt.disc, dv["params"], dv["batch_stats"])
    return jt, state, tt


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _leaf_gaps(got: dict, want: dict, noise: float) -> tuple:
    """(the largest gap of the elements within 1e-5 of their leaf's
    largest magnitude, over it; the share of the elements beyond, each
    within ``noise`` absolute)."""
    worst, n_out, n_all = 0.0, 0, 0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        scale = max(np.abs(b).max(), 1e-12)
        out = d > TOL * scale
        assert (d[out] <= noise).all()
        n_out, n_all = n_out + int(out.sum()), n_all + d.size
        if (~out).any():
            worst = max(worst, float(d[~out].max() / scale))
    return worst, n_out / n_all


def test_two_alternating_steps_match_jax():
    jt, state, tt = _setup()
    x = np.random.default_rng(5).random((2, SIZE, SIZE, 1)).astype(
        np.float32) * 2 - 1
    worst = {}
    for step in range(2):
        state, jm = jt.train_step(state, jnp.asarray(x))
        tm = tt.train_step(torch.from_numpy(x))
        for k in METRICS:
            worst[k] = max(worst.get(k, 0.0), _rel(tm[k], jm[k]))
        assert (float(jm["disc_factor"]) > 0) == (step == 1)
        _, tstats = state_dict_to_flax(tt.disc, tt.disc.state_dict())
        worst["d_stats"] = max(worst.get("d_stats", 0.0), max(
            float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(jax.tree.leaves(tstats),
                            jax.tree.leaves(jax.device_get(state.d_stats)))))
    print("vqgan trainer gaps:", worst)
    for k in METRICS:
        assert worst[k] <= TOL, (k, worst)
    assert worst["d_stats"] <= 1e-6
    assert float(jm["g_loss"]) != 0.0 and float(jm["discloss"]) > 0.0
    assert tt.step == int(state.step) == 2
    tparams = vqgan_state_dict_to_flax(
        jax.device_get(state.vq_params),
        dict(tt.vq.named_parameters()))
    vq_gap, vq_noise = _leaf_gaps(tparams, jax.device_get(state.vq_params),
                                  4 * LR)
    dparams, _ = state_dict_to_flax(tt.disc, tt.disc.state_dict())
    d_gap, d_noise = _leaf_gaps(dparams, jax.device_get(state.d_params),
                                4 * LR)
    print(f"after two steps: VQ weights {vq_gap:.2e} ({vq_noise:.2%} Adam "
          f"noise), D weights {d_gap:.2e} ({d_noise:.2%})")
    assert vq_noise <= 0.01 and d_noise <= 0.01


def test_lpips_of_an_image_with_itself_is_zero():
    net = TV.VGG16Features()
    lins = [torch.full((w,), 1.0 / w) for w in (64, 128, 256, 512, 512)]
    a = torch.from_numpy(np.random.default_rng(6).random(
        (2, SIZE, SIZE, 1)).astype(np.float32))
    with torch.no_grad():
        d = TV.vgg_lpips(net, lins, a, a)
    assert d.shape == (2,) and float(d.abs().max()) <= 1e-8
    assert nchw(a.numpy()).shape == (2, 1, SIZE, SIZE)


@pytest.mark.parametrize("disc_loss", ["hinge", "vanilla"])
def test_d_step_objective(disc_loss):
    # the D step's loss is the chosen objective on D's logits of the real
    # images and of the reconstructions
    torch.manual_seed(0)
    vq = VQModel(**CFG, generator=torch.Generator().manual_seed(0))
    tt = TT.VQGANTrainer(vq, disc_start=0, disc_ndf=8, disc_loss=disc_loss,
                         generator=torch.Generator().manual_seed(1))
    x = torch.rand(2, SIZE, SIZE, 1) * 2 - 1
    want_fn = TT.hinge_d_loss if disc_loss == "hinge" else TT.vanilla_d_loss
    with torch.no_grad():
        recon, _, _ = vq(nchw(x.numpy()))
        tt.disc.train()
        scratch = {k: b.clone() for k, b in tt.disc.named_buffers()}
        want = want_fn(torch.func.functional_call(tt.disc, scratch,
                                                  (nchw(x.numpy()),)),
                       torch.func.functional_call(tt.disc, scratch,
                                                  (recon,)))
    got = tt.train_step_disc(x)["discloss"]
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
