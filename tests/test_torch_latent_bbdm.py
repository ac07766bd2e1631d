"""The port's latent BBDM (``models/diffusion/latent_bbdm.py`` and the
latent hook of ``train/train_bbdm.BBDMModel``) against the JAX package's,
on the CPU in float32, through the tiny VQ of ``tests/test_torch_vqgan.py``
(bridged, 16^2 -> 8^2 x 2):

- ``SpatialRescaler`` (two bilinear halvings, and with a 1x1 channel map)
  within 1e-6 of the largest magnitude: the JAX-rule antialiased weights,
  not ``F.interpolate``'s;
- ``estimate_latent_stats`` within 1e-6 relative;
- ``p_losses`` under ``normalize_latent`` with JAX's draws (t and the
  noise) injected: the loss within 1e-5 relative, ``x0_recon`` within
  1e-5 of its largest;
- the 4-step sampler (T = 10) with JAX's per-step noises (``fold_in(key,
  i)``), decoded to pixels: within 1e-5 of the largest magnitude;
- ``BBDMModel(vqgan=...)``: the ADM denoiser (model_channels 8, one level,
  one res block) built at the latent's channels, its loss against the JAX
  ``BBDMModel``'s on the same bridged weights and draws within 1e-5
  relative; one train step moves the denoiser and not the frozen VQ; its
  sampler decodes to the pixel shape;
- ``train_bbdm.train(cfg, model=...)`` with the latent hook writes and
  serializes its checkpoints, and ``sample_eval`` restores the latest into
  a fresh latent model bit for bit.

The toy denoiser is the JAX test's ``w * x_t`` (w = 0.1). The worst gaps
are printed (``-s``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.diffusion.bbdm import \
    BridgeSchedule as JSchedule
from semantic_segmentation_tpu.models.diffusion.latent_bbdm import (
    LatentBrownianBridge as JLatent, SpatialRescaler as JRescaler)
from semantic_segmentation_tpu.train.train_bbdm import BBDMModel as JModel
from semantic_segmentation_torch.models.diffusion.bbdm import BridgeSchedule
from semantic_segmentation_torch.models.diffusion.latent_bbdm import (
    LatentBrownianBridge, SpatialRescaler)
from semantic_segmentation_torch.train.train_bbdm import BBDMModel
from semantic_segmentation_torch.utils.bridge import load_flax
from tests.test_torch_bbdm_bridge import jax_loss_draws
from tests.test_torch_sivae_nets import random_tree
from tests.test_torch_vqgan import gap, nchw, nhwc, tiny_pair

SCHED = dict(num_timesteps=10, sample_step=4)
W = 0.1


def _toy(x_t, t, context, train):
    return W * x_t


@pytest.fixture(scope="module")
def latent():
    jvq, params, tvq = tiny_pair(seed=3)
    vq_vars = {"params": params}
    rng = np.random.default_rng(2)
    imgs = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    conds = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    jl = JLatent(lambda p, x_t, t, c, r, tr: p["w"] * x_t, jvq,
                 JSchedule(**SCHED), normalize_latent=True)
    tl = LatentBrownianBridge(tvq, BridgeSchedule(**SCHED),
                              normalize_latent=True)
    return jvq, vq_vars, tvq, jl, tl, imgs, conds


@pytest.mark.parametrize("out_channels", [None, 4])
def test_spatial_rescaler(out_channels):
    x = np.random.default_rng(0).normal(size=(2, 32, 30, 3)).astype(
        np.float32)
    jr = JRescaler(n_stages=2, out_channels=out_channels, dtype=jnp.float32)
    tr = SpatialRescaler(2, 3, out_channels)
    v = {}
    if out_channels:
        v = random_tree(jax.eval_shape(lambda: jr.init(
            jax.random.key(0), jnp.asarray(x))), seed=1)
        with torch.no_grad():
            tr.remap.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))))
    want = np.asarray(jr.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tr(nchw(x)))
    assert got.shape == want.shape == (2, 8, 7, out_channels or 3)
    g = gap(got, want)
    print(f"SpatialRescaler({out_channels}) gap {g:.2e}")
    assert g <= 1e-6


def test_latent_stats(latent):
    jvq, vq_vars, tvq, jl, tl, imgs, _ = latent
    js = jax.jit(jl.estimate_latent_stats)(vq_vars, jnp.asarray(imgs))
    ts = tl.estimate_latent_stats(nchw(imgs))
    for k in ("mean", "std"):
        assert abs(float(ts[k]) - float(js[k])) <= 1e-6 * abs(float(js[k]))


def test_p_losses_with_jax_draws(latent):
    jvq, vq_vars, tvq, jl, tl, imgs, conds = latent
    stats = jax.jit(jl.estimate_latent_stats)(vq_vars, jnp.asarray(imgs))
    key = jax.random.key(5)
    jloss, jaux = jax.jit(lambda x, y: jl.p_losses(
        {"w": jnp.float32(W)}, vq_vars, x, y, key, stats))(
        jnp.asarray(imgs), jnp.asarray(conds))
    tstats = {k: torch.tensor(float(v)) for k, v in stats.items()}
    tloss, taux = tl.p_losses(_toy, nchw(imgs), nchw(conds),
                              jax_loss_draws(key, (2, 8, 8, 2), 10),
                              stats=tstats)
    rel = abs(float(tloss) - float(jloss)) / abs(float(jloss))
    g = gap(nhwc(taux["x0_recon"]), jaux["x0_recon"])
    print(f"latent p_losses: loss {rel:.2e}, x0_recon {g:.2e}")
    assert rel <= 1e-5 and g <= 1e-5


def test_four_step_sample_with_jax_noises(latent):
    jvq, vq_vars, tvq, jl, tl, imgs, conds = latent
    stats = jax.jit(jl.estimate_latent_stats)(vq_vars, jnp.asarray(imgs))
    key = jax.random.key(6)
    want = jax.jit(lambda y: jl.sample({"w": jnp.float32(W)}, vq_vars, y,
                                       key, stats))(jnp.asarray(conds))
    assert len(tl.bridge.sched.steps) == 4
    noises = [nchw(jax.random.normal(jax.random.fold_in(key, i),
                                     (2, 8, 8, 2), jnp.float32))
              for i in range(4)]
    got = tl.sample(_toy, nchw(conds), noises,
                    stats={k: torch.tensor(float(v))
                           for k, v in stats.items()})
    g = gap(nhwc(got), want)
    print(f"latent 4-step sample gap {g:.2e}")
    assert got.shape == (2, 1, 16, 16) and g <= 1e-5


def test_bbdm_model_latent_hook(latent):
    jvq, vq_vars, tvq, *_ = latent
    net = dict(model_channels=8, channel_mult=(1,), num_res_blocks=1)
    jm = JModel(channels=2, schedule=JSchedule(**SCHED), vqgan=jvq,
                vqgan_vars=vq_vars, compute_dtype=jnp.float32, **net)
    z = jnp.zeros((1, 8, 8, 2))
    arch = jnp.asarray(0.5 * np.random.default_rng(4).normal(
        size=(jm.n_cells, 3)), jnp.float32)
    params = random_tree(jax.eval_shape(lambda: jm.unet.init(
        {"params": jax.random.key(0)}, z, jnp.zeros((1,), jnp.int32), arch,
        context=z)), seed=5)["params"]
    tm = BBDMModel(2, schedule=BridgeSchedule(**SCHED),
                   compute_dtype="float32", vqgan=tvq,
                   generator=torch.Generator().manual_seed(0), **net)
    assert tm.unet.in0.in_channels == 4
    load_flax(tm.unet, params)
    with torch.no_grad():
        tm.arch.copy_(torch.from_numpy(np.asarray(arch)))
    rng = np.random.default_rng(8)
    batch = {"image_pix2pix": rng.random((2, 16, 16, 1)).astype(np.float32),
             "mask_pix2pix": rng.random((2, 16, 16, 1)).astype(np.float32)}
    key = jax.random.key(9)
    jloss, _ = jax.jit(lambda p, b: jm.loss_fn(p, arch, b, key))(
        params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = jax_loss_draws(key, (2, 8, 8, 2), 10)
    tloss, _ = tm.loss_fn(tb, draws)
    rel = abs(float(tloss) - float(jloss)) / abs(float(jloss))
    print(f"BBDMModel latent loss gap {rel:.2e}")
    assert rel <= 1e-5
    vq_before = {k: v.clone() for k, v in tvq.state_dict().items()}
    unet_before = {k: v.clone() for k, v in tm.unet.state_dict().items()}
    tm.train_step(tb, draws)
    assert all(torch.equal(v, vq_before[k])
               for k, v in tvq.state_dict().items())
    assert any(not torch.equal(v, unet_before[k])
               for k, v in tm.unet.state_dict().items())
    out = tm.sample(tb["mask_pix2pix"], use_ema=False,
                    generator=torch.Generator().manual_seed(1))
    assert out.shape == (2, 16, 16, 1) and torch.isfinite(out).all()


def test_latent_train_writes_and_restores_checkpoints(latent, tmp_path):
    """``train_bbdm.train(cfg, model=...)`` with the latent hook serializes
    its checkpoints (``bbdm_best.pt``, ``bbdm_latest.pt``, the top-k and
    the latest trainer state), and ``sample_eval`` restores the latest
    into a fresh latent model."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train import train_bbdm
    tvq = latent[2]
    net = dict(model_channels=8, channel_mult=(1,), num_res_blocks=1)

    def model(seed):
        return BBDMModel(2, schedule=BridgeSchedule(**SCHED),
                         compute_dtype="float32", vqgan=tvq,
                         normalize_latent=True,
                         generator=torch.Generator().manual_seed(seed), **net)

    argv = ["--preset=bbdm", "--data.synthetic=true", "--data.image_size=16",
            "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
            "--data.batch_size=2", "--model.compute_dtype=float32",
            "--engine.valid_step=2", "--run.device=cpu",
            "--run.topk_checkpoints=2", f"--run.save_dir={tmp_path}"]
    trained, res = train_bbdm.train(parse_config(argv), 4, model(0))
    run = tmp_path / "bbdm"
    assert len(res["log"]) == 2 and len(list((run / "ckpt_top").iterdir())) \
        == 2
    latest = torch.load(run / "bbdm_latest.pt", weights_only=False)
    assert (run / "bbdm_best.pt").is_file()
    assert all(torch.equal(v, trained.unet.state_dict()[k])
               for k, v in latest["params"].items())
    fresh = model(1)
    samples, _ = train_bbdm.sample_eval(
        parse_config(argv + ["--run.sample_only=true"]), fresh)
    assert all(torch.equal(v, trained.unet.state_dict()[k])
               for k, v in fresh.unet.state_dict().items())
    assert torch.equal(fresh.arch, trained.arch)
    assert samples.shape[-3:] == (16, 16, 1) and np.isfinite(samples).all()
