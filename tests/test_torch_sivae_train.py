"""The port's ``train_vae`` steps against the JAX package's
``SIVAETrainer`` (``train/train_vae.py``), f32, 32^2, batch 2, latent 8,
decoder ngf 4 (nd 5; the encoder is the full-width trunk), from bridged
weights, every Gaussian draw of the JAX step injected (``vae_step``: the
reparameterization noise of ``rng``; ``soft_intro_step``: ``noise``,
``eps``, ``eps_fake``, ``eps_rec`` from ``jax.random.split(rng, 4)``):

- three ``vae_step`` and three ``soft_intro_step`` steps, each from the
  JAX trainer's state (weights, BN statistics, both Adams' moments), under
  ``mse`` and under ``vgg`` (random VGG16 weights, bridged; the scalar
  perceptual loss broadcasts into the exp terms): every metric of every
  step within 1e-5 relative; after each step the encoder's BN running
  statistics within 1e-5 of each leaf's largest, and every parameter
  within 1e-5 of its net's largest magnitude, but for at most 1 in 10^4
  elements (or 8, in the 49,407 of the decoder) within 2 lr (Adam's first steps move every element by lr in
  the sign of its gradient, which rounding decides where the gradient is
  noise); the biases of the decoder's convs that an instance norm
  follows, whose gradient is 0 in exact arithmetic, within 2 lr. Free-running, the two trajectories part by 5e-4 relative in
  the third step (Adam's noise on the full-width encoder), as in the
  engine tests;
- the epoch MultiStepLR (milestones 25 and 38, gamma 0.1) and its use by
  ``train``;
- ``train`` at smoke size through both phases, its checkpoint loading
  back, and the entry refusing to run without CUDA unless asked for the
  CPU.

The JAX variables are drawn from ``jax.eval_shape``'s shapes; each JAX
step compiles once per loss type (a module fixture)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_segmentation_tpu.models.vae.sivae import \
    SoftIntroVAE as JSoftIntroVAE
from semantic_segmentation_tpu.models.vgg import VGG16Features as JVGG
from semantic_segmentation_tpu.train import train_vae as jtv
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.vae.sivae import SoftIntroVAE
from semantic_segmentation_torch.models.vgg import VGG16Features
from semantic_segmentation_torch.train import train_vae as ttv
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax,
                                                      load_sivae_flax,
                                                      state_dict_to_flax)
from tests.test_torch_engine_modes import _set_optimizer_state
from tests.test_torch_sivae_nets import _nchw, random_tree, random_variables

SIZE, NGF, LATENT, STEPS = 32, 4, 8, 3
LR = 2e-4
NOISE_LR = 2           # one Adam step of lr, either sign
# the decoder's conv biases that an instance norm follows (nd 5)
NORMED_BIASES = {f"['{m}']['bias']" for m in
                 ("down1", "down2", "down3", "up1", "up2", "up3", "up4")}


def jax_start(loss_type: str):
    """(JAX trainer, its state, the VGG variables or None) from random
    variables of the right shapes."""
    model = JSoftIntroVAE(latent_dim=LATENT, output_nc=3, ngf=NGF,
                          netG=f"unet_{SIZE}", dtype=jnp.float32)
    vgg = None
    if loss_type == "vgg":
        vgg = random_variables(JVGG(dtype=None),
                               jnp.zeros((1, SIZE, SIZE, 3)), seed=3)
    trainer = jtv.SIVAETrainer(model, jtv.SIVAEParams(
        recon_loss_type=loss_type, num_vae=STEPS), SIZE,
        vgg_params=None if vgg is None else vgg["params"])
    v = random_tree(jax.eval_shape(lambda: model.init(jax.random.key(0),
                                                      SIZE)), seed=1)
    state = jtv.SIVAEState(
        enc_params=v["enc"]["params"], enc_stats=v["enc"]["batch_stats"],
        dec_params=v["dec"]["params"], dec_stats={},
        arch=0.5 * v["arch"] * 1e3, opt_e=trainer.tx_e.init(
            v["enc"]["params"]),
        opt_d=trainer.tx_d.init(v["dec"]["params"]),
        step=jnp.zeros((), jnp.int32))
    return trainer, state, vgg


def port_start(state, loss_type: str, vgg):
    vae = SoftIntroVAE(LATENT, 3, NGF, f"unet_{SIZE}", device="cpu")
    load_sivae_flax(vae, {
        "enc": {"params": state.enc_params, "batch_stats": state.enc_stats},
        "dec": {"params": state.dec_params}, "arch": state.arch})
    tvgg = None
    if vgg is not None:
        tvgg = VGG16Features()
        load_flax(tvgg, vgg["params"])
    return ttv.SIVAETrainer(vae, ttv.SIVAEParams(recon_loss_type=loss_type,
                                                 num_vae=STEPS), SIZE, tvgg)


def jax_draws(rng, phase: str, n: int) -> dict:
    """The port's draws of one JAX step's ``rng``."""
    shape = (n, LATENT)
    if phase == "vae":
        keys = {"eps": rng}
    else:
        kz, ke, kd1, kd2 = jax.random.split(rng, 4)
        keys = {"noise": kz, "eps": ke, "eps_fake": kd1, "eps_rec": kd2}
    return {k: torch.from_numpy(np.array(jax.random.normal(key, shape)))
            for k, key in keys.items()}


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    a = (rng.random((2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    a = np.repeat(a, 3, -1)
    b = (2 * rng.random((2, SIZE, SIZE, 3)) - 1).astype(np.float32)
    return a, b


def sync_port(port, state):
    """The port trainer's weights, BN statistics, arch table and both
    Adams' moments from the JAX ``SIVAEState`` (numpy)."""
    vae = port.m
    load_sivae_flax(vae, {
        "enc": {"params": state.enc_params, "batch_stats": state.enc_stats},
        "dec": {"params": state.dec_params}, "arch": state.arch})
    for opt, net, o in ((port.opt_e, vae.encoder, state.opt_e),
                        (port.opt_d, vae.decoder, state.opt_d)):
        adam = o.inner_state[0]
        moments = {k: flax_to_state_dict(net, t) for k, t in
                   (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
        _set_optimizer_state(opt, dict(net.named_parameters()), moments,
                             int(adam.count))


def state_gaps(port, state) -> dict:
    """The port's state after a step against the JAX step's: the largest
    BN statistic gap over its leaf's largest magnitude, and per net the
    largest parameter gap over the net's largest magnitude among the
    elements within 1e-5 of it, the others' count and largest gap in
    learning rates (Adam's first-step noise: an element whose gradient
    is rounding noise moves by lr in a direction rounding decides)."""
    vae = port.m
    _, stats = state_dict_to_flax(vae.encoder, vae.encoder.state_dict())
    out = {"stats": max(
        float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(
            jax.tree_util.tree_leaves(stats),
            jax.tree_util.tree_leaves(state.enc_stats)))}
    for name, net, params in (("encoder", vae.encoder, state.enc_params),
                              ("decoder", vae.decoder, state.dec_params)):
        got, _ = state_dict_to_flax(net, dict(net.named_parameters()))
        pairs = [(jax.tree_util.keystr(p), g, w) for (p, g), w in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_leaves(params))]
        top = max(float(np.abs(w).max()) for _, _, w in pairs)
        near = far_lr = 0.0
        n_far = n_all = 0
        for key, g, w in pairs:
            err = np.abs(g - w)
            if name == "decoder" and key in NORMED_BIASES:
                # its gradient is 0 in exact arithmetic (a norm follows)
                far_lr = max(far_lr, float(err.max()) / LR)
                continue
            far = err > 1e-5 * top
            n_far, n_all = n_far + int(far.sum()), n_all + err.size
            if far.any():
                far_lr = max(far_lr, float(err[far].max()) / LR)
            if (~far).any():
                near = max(near, float(err[~far].max()) / top)
        out[name] = (near, n_far, n_all, far_lr)
    return out


@pytest.fixture(scope="module", params=["mse", "vgg"])
def steps(request):
    """Six steps (three of each phase) under one loss type, each from the
    JAX trainer's state: (loss type, JAX metrics, port metrics, the
    port's state gaps after each step)."""
    loss_type = request.param
    trainer, state, vgg = jax_start(loss_type)
    port = port_start(jax.device_get(state), loss_type, vgg)
    jm, tm, gaps = [], [], []
    for i in range(2 * STEPS):
        phase = "vae" if i < STEPS else "soft_intro"
        a, b = _batch(i)
        rng = jax.random.key(100 + i)
        sync_port(port, jax.device_get(state))
        step = trainer.vae_step if phase == "vae" else \
            trainer.soft_intro_step
        state, m = step(state, jnp.asarray(a), jnp.asarray(b), rng)
        jm.append({k: float(v) for k, v in m.items()})
        tstep = port.vae_step if phase == "vae" else port.soft_intro_step
        tm.append({k: float(v) for k, v in tstep(
            _nchw(a), _nchw(b), jax_draws(rng, phase, 2)).items()})
        gaps.append(state_gaps(port, jax.device_get(state)))
    return loss_type, jm, tm, gaps


def test_step_losses_match_jax(steps):
    loss_type, jm, tm, _ = steps
    worst = 0.0
    for i, (a, b) in enumerate(zip(tm, jm)):
        assert a.keys() == b.keys(), (i, sorted(a), sorted(b))
        for k in b:
            rel = abs(a[k] - b[k]) / abs(b[k])
            assert rel <= 1e-5, (loss_type, i, k, a[k], b[k])
            worst = max(worst, rel)
    print(f"train_vae ({loss_type}): six steps, losses within {worst:.2e}")


def test_state_after_each_step_matches_jax(steps):
    loss_type, _, _, gaps = steps
    for i, g in enumerate(gaps):
        assert g["stats"] <= 1e-5, (loss_type, i, g)
        for name in ("encoder", "decoder"):
            near, n_far, n_all, far_lr = g[name]
            assert near <= 1e-5 and far_lr <= NOISE_LR, (loss_type, i, g)
            assert n_far <= max(1e-4 * n_all, 8), (loss_type, i, name, g)
    print(f"train_vae ({loss_type}) state gaps per step:", gaps)


def test_multistep_lr_matches_the_schedule():
    base = 2e-4
    for epoch, want in ((0, base), (24, base), (25, base * 0.1),
                        (37, base * 0.1), (38, base * 0.01),
                        (100, base * 0.01)):
        assert ttv.multistep_lr(base, epoch) == pytest.approx(want,
                                                              rel=1e-12)
    # the JAX trainer's schedule (defined in its train loop) on optax's
    # injected learning rate, against the port's Adam after set_epoch
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=base)
    opt = tx.init({"w": jnp.zeros(1)})
    port = port_start(jax.device_get(jax_start("mse")[1]), "mse", None)
    for epoch in (0, 25, 38):
        opt.hyperparams["learning_rate"] = jnp.asarray(
            ttv.multistep_lr(base, epoch), jnp.float32)
        port.set_epoch(epoch)
        for o in (port.opt_e, port.opt_d):
            assert o.param_groups[0]["lr"] == pytest.approx(
                float(opt.hyperparams["learning_rate"]), rel=1e-7)


def test_train_vae_both_phases_and_checkpoint(tmp_path):
    """``train`` at smoke size: the plain-VAE phase, then soft-intro, one
    epoch each; ``sivae.pt`` loads back into a fresh model."""
    argv = ["--preset=sivae", "--data.synthetic=true", "--run.device=cpu",
            f"--data.image_size={SIZE}", "--data.n_train=2",
            "--data.n_val=2", "--data.n_test=0", "--model.ngf=4",
            "--model.compute_dtype=float32", "--run.log_every=1",
            f"--run.save_dir={tmp_path}"]
    cfg = parse_config(argv)
    trainer, results = ttv.train(cfg, 2, ttv.SIVAEParams(num_vae=1))
    assert results["phases"]["vae"]["steps"] == 1
    assert results["phases"]["soft_intro"]["steps"] == 1
    assert set(results["metrics"]) == {"lossE", "lossD", "loss_rec",
                                       "loss_kl"}
    assert all(np.isfinite(v) for v in results["metrics"].values())
    fresh = ttv.load_checkpoint(ttv.build_model(cfg, "cpu"),
                                results["checkpoint"]["path"])
    for a, b in zip(fresh.state_dict().values(),
                    trainer.m.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(fresh.arch, trainer.m.arch)

@pytest.mark.parametrize("entry", ["train_vae", "train_end2end_vae",
                                   "inference_vae"])
def test_entries_need_cuda_or_cpu(entry, tmp_path, monkeypatch):
    import importlib
    module = importlib.import_module(
        f"semantic_segmentation_torch.train.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--data.synthetic=true", f"--run.save_dir={tmp_path}"])
