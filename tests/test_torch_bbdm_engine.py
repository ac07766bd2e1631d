"""Three ``end2end_bbdm`` engine iterations of the port against the JAX
package's ``BilevelEngine`` (the preset: ``decay_only``, K = 1,
roll-back), f32, 16^2, batch 2, synthetic data, from bridged non-zero
denoiser weights (the small one-level ADM net of
``tests/test_torch_bbdm_train.py``, T = 20 with 5 sample steps) and a U-Net
at base 4, each iteration from the JAX engine's state (weights, BN
statistics, optimizer states, arch table), the same batch indices, and
every random draw of the JAX iteration injected, re-derived from its key
chain (bilevel.py:249 ``rng_r`` -> :152 split K -> :120 fold_in(problem)):
netG's t and noise (bbdm.py:114-116), and for the unet at
``loss_lambda`` 1 the augment affines (warped through the JAX package's
plain CPU path, as its own tests run it) and the sampler's per-step
noises (train_end2end_bbdm.py:54, bbdm.py:176):

- at the preset's ``loss_lambda`` 0 (no fake) and at 1 (the fake branch:
  warp -> threshold -> 5-step sampling -> min-max -> segmenter): every
  loss within 1e-5 relative, and the arch table within 1e-7;
- ``darts`` (the reference's mode) at ``loss_lambda`` 1: its
  hypergradient exactly 0, and the port's iteration equal bit for bit to
  its ``decay_only`` iteration from the same state and draws (weights, BN
  statistics, arch).

The largest gaps are printed (``-s``)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.ops.augment import sample_affine_batch
from semantic_segmentation_tpu.train.common import load_splits as jload
from semantic_segmentation_tpu.train.train_end2end_bbdm import \
    build as jbuild
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train import train_end2end_bbdm as te2e
from semantic_segmentation_torch.train.common import load_splits
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      state_dict_to_flax)
from tests.test_torch_bbdm_nets import nchw
from tests.test_torch_bbdm_train import (SCHED, jax_model_and_state,
                                         port_model)
from tests.test_torch_engine_modes import _set_optimizer_state, _sync_port

PROBLEMS = te2e.PROBLEMS
SIZE = 16
ARGV = ["--data.synthetic=true", f"--data.image_size={SIZE}",
        "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
        "--model.compute_dtype=float32", "--model.base_features=4"]


_STARTS = {}


def _jax_start(loss_lambda: float):
    """The JAX config, engine and a fresh copy of a start state (the engine
    donates it): the denoiser's non-zero weights, the port's fresh U-Net
    (weights and BN statistics) in the JAX layout (a JAX init of the nets
    costs seconds of compile), fresh optimizer states. Built once per
    ``loss_lambda`` for the file: the darts test starts where the
    ``loss_lambda`` 1 iterations do."""
    if loss_lambda not in _STARTS:
        jcfg, engine, state = _build_jax_start(loss_lambda)
        _STARTS[loss_lambda] = (jcfg, engine, jax.device_get(state))
    jcfg, engine, host = _STARTS[loss_lambda]
    return jcfg, engine, jax.tree.map(jnp.array, host)


def _build_jax_start(loss_lambda: float):
    jcfg = jparse(ARGV + [f"--optim.loss_lambda={loss_lambda}"],
                  preset="end2end_bbdm")
    jm, bstate = jax_model_and_state()
    bbdm, seg, engine = jbuild(jcfg, jm)
    unet = _port_engine(loss_lambda).problems[1].module
    u_params, u_stats = state_dict_to_flax(unet, unet.state_dict())
    params = {"netG": bstate.params, "unet": u_params}
    init = jax.jit(lambda p, a: engine.init(
        params=p, stats={"netG": {}, "unet": u_stats},
        opts={"netG": jm.tx.init(p["netG"]), "unet": seg.tx.init(p["unet"])},
        arch=a))
    return jcfg, engine, init(params, {"conv": bstate.arch})


def _sync(engine, state):
    """The port's engine state from the JAX ``EngineState``: netG's
    weights and Adam (``inject_hyperparams(adam)``), and the U-Net's and
    the arch's as ``tests/test_torch_engine_modes.py`` syncs them."""
    netg = engine.problems[0]
    unet_only = copy.copy(engine)
    unet_only.problems = engine.problems[1:]
    _sync_port(unet_only, state)
    netg.module.load_state_dict(flax_to_state_dict(
        netg.module, state.params["netG"]))
    adam = state.opts["netG"].inner_state[0]
    _set_optimizer_state(
        netg.optimizer, dict(netg.module.named_parameters()),
        {k: flax_to_state_dict(netg.module, t)
         for k, t in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))},
        int(adam.count))


@jax.jit
def _jax_draws(root, it):
    """The replay's draws of JAX iteration ``it`` (K = 1), batch 2: netG's
    t and noise, the unet's affines and sampler noises (jitted: one
    compile for every iteration)."""
    keys = jax.random.split(jax.random.fold_in(root, it), 3)
    r = jax.random.split(keys[2], 1)[0]
    rng_g, rng_u = (jax.random.fold_in(r, i) for i in range(2))
    rng_t, rng_n, _ = jax.random.split(rng_g, 3)         # bbdm.py:114-116
    shape = (2, SIZE, SIZE, 1)
    rng_a, _, rng_s = jax.random.split(rng_u, 3)         # e2e_bbdm.py:54
    return {"t": jax.random.randint(rng_t, (2,), 0, SCHED["num_timesteps"]),
            "noise": jax.random.normal(rng_n, shape, jnp.float32),
            "affine": sample_affine_batch(rng_a, 2, SIZE, SIZE),
            "sampler": jnp.stack([
                jax.random.normal(jax.random.fold_in(rng_s, i), shape,
                                  jnp.float32)
                for i in range(SCHED["sample_step"])])}


def _draws(root, it: int, loss_lambda: float):
    """{problem: draws} of the replay of JAX iteration ``it``, as the port
    takes them."""
    d = jax.device_get(_jax_draws(root, jnp.int32(it)))
    out = {"netG": {"bridge": {"t": torch.from_numpy(np.array(d["t"])).long(),
                               "noise": nchw(d["noise"])}},
           "unet": {}}
    if loss_lambda:
        out["unet"] = {"affine": torch.from_numpy(np.array(d["affine"])),
                       "sampler": [nchw(n) for n in d["sampler"]]}
    return out


def _port_engine(loss_lambda: float, mode: str = "decay_only"):
    cfg = parse_config(ARGV + [f"--optim.loss_lambda={loss_lambda}",
                               f"--engine.hypergrad={mode}",
                               "--run.device=cpu"], preset="end2end_bbdm")
    return te2e.build_engine(cfg, "cpu", bbdm=port_model(ema=False))[0]


@pytest.mark.parametrize("loss_lambda", [0.0, 1.0])
def test_three_iterations_match_jax(loss_lambda):
    jcfg, engine_j, state = _jax_start(loss_lambda)
    jsplits = jload(jcfg)
    train_j, val_j = (device_put_split(jsplits[k]) for k in ("train", "val"))
    engine = _port_engine(loss_lambda)
    splits = load_splits(parse_config(ARGV))
    for k in ("image", "mask", "image_pix2pix", "mask_pix2pix"):
        np.testing.assert_array_equal(splits["train"][k],
                                      jsplits["train"][k])
    train_t, val_t = (to_device_split(splits[k], "cpu")
                      for k in ("train", "val"))
    streams = {n: epoch_index_batches(4, 2, seed=i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(2, 2, seed=99)
    root = jax.random.key(5)
    gaps = {}
    for it in range(3):
        idx = {n: next(s) for n, s in streams.items()}
        vidx = next(val_stream)
        host = jax.device_get(state)
        _sync(engine, host)
        batches = {n: take_batch(train_t, idx[n]) for n in PROBLEMS}
        draws = {"replay": [_draws(root, it, loss_lambda)]}
        state, mj = engine_j.engine_step_sampled(
            state, train_j, val_j, {n: idx[n][None] for n in PROBLEMS},
            vidx, jnp.int32(it), root, PROBLEMS)
        mt = engine.engine_step([batches], take_batch(val_t, vidx), draws)
        assert set(mt) == set(mj)
        for k in mj:
            a, b = float(mt[k]), float(mj[k])
            if k == "arch_grad_norm":
                assert a == b == 0.0
                continue
            gaps[k] = max(gaps.get(k, 0.0), abs(a - b) / abs(b))
            assert gaps[k] <= 1e-5, (it, k, a, b)
        arch = float(np.max(np.abs(engine.arch["conv"].numpy()
                                   - np.asarray(state.arch["conv"]))))
        assert arch <= 1e-7, arch
    print(f"end2end_bbdm, loss_lambda {loss_lambda}: largest relative gaps",
          {k: f"{v:.1e}" for k, v in gaps.items()})


def test_darts_hypergradient_is_zero_and_equals_decay_only():
    _, _, state = _jax_start(1.0)
    host = jax.device_get(state)
    splits = load_splits(parse_config(ARGV))
    train_t, val_t = (to_device_split(splits[k], "cpu")
                      for k in ("train", "val"))
    batches = {"netG": take_batch(train_t, [0, 1]),
               "unet": take_batch(train_t, [2, 3])}
    val = take_batch(val_t, [0, 1])
    root = jax.random.key(5)
    unroll = _draws(jax.random.fold_in(root, 1), 0, 1.0)
    replay = _draws(root, 0, 1.0)
    engines = {}
    for mode in ("darts", "decay_only"):
        engine = _port_engine(1.0, mode)
        _sync(engine, host)
        m = engine.engine_step([batches], val,
                               {"unroll": [unroll], "replay": [replay],
                                "hyper": [replay]})
        assert float(m["arch_grad_norm"]) == 0.0
        engines[mode] = engine
    for pa, pb in zip(engines["darts"].problems,
                      engines["decay_only"].problems):
        for (k, v), w in zip(pa.module.state_dict().items(),
                             pb.module.state_dict().values()):
            assert torch.equal(v, w), (pa.name, k)
    assert torch.equal(engines["darts"].arch["conv"],
                       engines["decay_only"].arch["conv"])
