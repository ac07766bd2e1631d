"""``end2end_sivae`` engine iterations of the port against the JAX
package's ``train_end2end_vae`` engine: f32, 32^2, batch 2, decoder ngf 4
(nd 5), U-Net base 8, the preset's splits cut to 4/2/2 synthetic images,
each iteration from the JAX engine's state (weights, BN statistics, every
optimizer's moments, the arch table and its Adam), the batch indices from
the JAX loop's streams, and every draw of the JAX iteration injected,
re-derived from its key chain (bilevel.py:249 ``rng_r`` -> :152 split K ->
:120 fold_in(problem) -> train_end2end_vae.py:87 split 3):

- the ELBO problems' reparameterization noise (netG, netD);
- the U-Net problem's augment affines, fake latents and photometric coins
  and saturation factor (batch-level).

Cases:

- three ``decay_only`` iterations (the preset): every loss within 1e-5
  relative, but ``loss_unet``, whose fake passes a uint8 quantisation
  (a level can move, as in ``tests/test_torch_isic.py``), within 5e-5;
  after the three iterations the arch table within 1e-6, and the
  hypergradient exactly 0 in both;
- ``darts`` (the reference's mode) in
  ``tests/test_torch_sivae_engine_darts.py``: the hypergradient norm
  exactly 0 in both packages, and the port's ``darts`` iteration equal to
  its ``decay_only`` one bit for bit.

The JAX start state is drawn from ``jax.eval_shape``'s shapes
(``tests/test_torch_sivae_nets.random_tree``) with the optimizers'
real initial states. The largest gaps are printed (``-s``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.ops.augment import sample_affine_batch
from semantic_segmentation_tpu.train import train_end2end_vae as jte
from semantic_segmentation_tpu.train.common import load_splits as jload
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train import train_end2end_vae as tte
from semantic_segmentation_torch.train.common import load_splits
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax)
from tests.test_torch_engine_modes import _set_optimizer_state
from tests.test_torch_photometric import _jax_draws
from tests.test_torch_sivae_nets import random_tree

PROBLEMS = tte.PROBLEMS
ARGV = ["--preset=end2end_sivae", "--data.synthetic=true",
        "--data.image_size=32", "--data.n_train=4", "--data.n_val=2",
        "--data.n_test=2", "--model.compute_dtype=float32", "--model.ngf=4",
        "--model.base_features=8"]
RTOL = {"loss_unet": 5e-5, "replay_loss_unet": 5e-5}


def jax_start(jcfg):
    """(JAX engine, its start state) with random weights and statistics
    and the optimizers' initial states."""
    model, seg, engine, (tx_dec, tx_enc) = jte.build(jcfg)
    size = jcfg.data.image_size
    v = random_tree(jax.eval_shape(lambda: model.init(jax.random.key(0),
                                                      size)), seed=11)
    s = jax.eval_shape(lambda: seg.init(jax.random.key(1), size))
    s_params = random_tree(s.params, seed=12)
    s_stats = random_tree(s.stats, seed=13)
    arch = 0.5 * np.random.default_rng(14).normal(size=(10, 3))
    state = engine.init(
        params={"netG": v["dec"]["params"], "netD": v["enc"]["params"],
                "unet": s_params},
        stats={"netG": {}, "netD": v["enc"]["batch_stats"],
               "unet": s_stats},
        opts={"netG": tx_dec.init(v["dec"]["params"]),
              "netD": tx_enc.init(v["enc"]["params"]),
              "unet": seg.tx.init(s_params)},
        arch={"conv": jnp.asarray(arch, jnp.float32)})
    return engine, state


def sync_port(engine, state):
    """The port's engine state from the JAX ``EngineState`` (numpy): the
    ELBO problems' Adams are optax's plain ``adam``, the U-Net's RMSprop
    chain and the arch Adam the flagship's (``test_torch_engine_modes.
    _sync_port``)."""
    for p in engine.problems:
        load_flax(p.module, state.params[p.name], state.stats[p.name])
        o = state.opts[p.name]
        if p.name == "unet":           # add_decayed_weights, rms, trace, lr
            trees = {"square_avg": o[1].nu, "momentum_buffer": o[2].trace}
            count = int(o[3].count)
        else:                          # adam: (ScaleByAdamState, lr)
            trees = {"exp_avg": o[0].mu, "exp_avg_sq": o[0].nu}
            count = int(o[0].count)
        moments = {k: flax_to_state_dict(p.module, t)
                   for k, t in trees.items()}
        _set_optimizer_state(p.optimizer, dict(p.module.named_parameters()),
                             moments, count)
    with torch.no_grad():
        engine.arch["conv"].copy_(torch.from_numpy(
            np.array(state.arch["conv"])))
    adam = state.opt_arch[1].inner_state         # add_decayed_weights first
    _set_optimizer_state(engine.arch_optimizer, engine.arch,
                         {"exp_avg": adam.mu, "exp_avg_sq": adam.nu},
                         int(adam.count))


def phase_draws(root, it: int, phase: str, batches: dict) -> dict:
    """{problem: draws} of the JAX iteration ``it`` (K = 1) in its
    ``phase``: 'unroll' (``rng_u``), 'hyper' (``rng_h``, netG's ELBO noise
    in the darts evaluations) or 'replay' (``rng_r``)."""
    keys = jax.random.split(jax.random.fold_in(root, jnp.int32(it)), 3)
    n, h, w, _ = batches["unet"]["mask"].shape

    def normal(key):
        return torch.from_numpy(np.array(jax.random.normal(key, (n, 8))))

    if phase == "hyper":
        return {"netG": {"eps": normal(keys[1])}}
    r = jax.random.split(keys[{"unroll": 0, "replay": 2}[phase]], 1)[0]
    out = {}
    for i, name in enumerate(PROBLEMS):
        rng_p = jax.random.fold_in(r, i)
        if name != "unet":
            out[name] = {"eps": normal(rng_p)}
            continue
        rng_a, rng_z, rng_ph = jax.random.split(rng_p, 3)
        out[name] = {"affine": torch.from_numpy(np.array(
                         sample_affine_batch(rng_a, n, h, w))),
                     "z": normal(rng_z),
                     "photometric": _jax_draws(rng_ph, n, False)}
    return out


def test_three_decay_only_iterations_match_jax():
    jcfg = jparse(ARGV)
    cfg = parse_config(ARGV + ["--run.device=cpu"])
    assert cfg.engine.hypergrad == jcfg.engine.hypergrad == "decay_only"
    engine_j, state = jax_start(jcfg)
    jsplits = jload(jcfg)
    splits = load_splits(cfg)
    for k in ("image", "mask"):
        np.testing.assert_array_equal(splits["train"][k], jsplits["train"][k])
    train_j = device_put_split(jsplits["train"])
    val_j = device_put_split(jsplits["val"])
    engine, _, _ = tte.build_engine(cfg, "cpu")
    train_t = to_device_split(splits["train"], "cpu")
    val_t = to_device_split(splits["val"], "cpu")
    bs = cfg.data.batch_size
    streams = {n: epoch_index_batches(4, bs, seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(2, bs, seed=cfg.run.seed + 99)
    root = jax.random.key(cfg.run.seed + 5)
    gaps = {}
    for it in range(3):
        idx = {n: next(s) for n, s in streams.items()}
        vidx = next(val_stream)
        sync_port(engine, jax.device_get(state))
        batches = {n: take_batch(train_t, idx[n]) for n in PROBLEMS}
        draws = {"replay": [phase_draws(root, it, "replay", batches)]}
        state, mj = engine_j.engine_step_sampled(
            state, train_j, val_j, {n: idx[n][None] for n in PROBLEMS},
            vidx, jnp.int32(it), root, PROBLEMS)
        mt = engine.engine_step([batches], take_batch(val_t, vidx), draws)
        assert set(mt) == set(mj), (sorted(mt), sorted(mj))
        for k in mj:
            a, b = float(mt[k]), float(mj[k])
            assert np.isfinite(a), (it, k)
            if k == "arch_grad_norm":
                assert a == b == 0.0
                continue
            gaps[k] = max(gaps.get(k, 0.0), abs(a - b) / abs(b))
            assert gaps[k] <= RTOL.get(k, 1e-5), (it, k, a, b)
    arch = float(np.abs(engine.arch["conv"].numpy()
                        - np.asarray(state.arch["conv"])).max())
    assert arch <= 1e-6
    print("end2end_sivae decay_only: largest relative gaps",
          {k: f"{v:.1e}" for k, v in gaps.items()}, f"arch {arch:.1e}")
