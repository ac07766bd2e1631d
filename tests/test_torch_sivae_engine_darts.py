"""``end2end_sivae`` under the reference's ``darts``, in a file of its own
so that its JAX compile runs on another test worker (the setting is
``tests/test_torch_sivae_engine.py``'s):

- the JAX engine's own darts hypergradient (``_darts_hypergrad``, netG's
  ELBO noise from ``rng_h``) at the JAX start state, and the port's in one
  ``darts`` iteration from that state with every phase's JAX draws
  injected: both norms exactly 0 (the outer loss reads the U-Net only,
  the arch child is netG), printed with ``-s``;
- the port's ``darts`` iteration equals, bit for bit, its ``decay_only``
  iteration from the same state and replay draws: the losses, every
  weight and BN statistic, and the arch table (the structural zero that
  lets the preset run ``decay_only``).

The JAX side compiles the hypergradient alone, not a whole ``darts``
iteration (70 s on the CPU); ``tests/test_torch_sivae_engine.py`` holds
the iterations' losses against the JAX engine."""
import jax
import jax.numpy as jnp
import optax
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.train.common import load_splits as jload
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train import train_end2end_vae as tte
from semantic_segmentation_torch.train.common import load_splits
from tests.test_torch_sivae_engine import (ARGV, PROBLEMS, jax_start,
                                           phase_draws, sync_port)


def test_darts_hypergradient_is_zero_in_both():
    jcfg = jparse(ARGV + ["--engine.hypergrad=darts"])
    engine_j, state = jax_start(jcfg)
    host = jax.device_get(state)
    train_j = device_put_split(jload(jcfg)["train"])
    val_j = device_put_split(jload(jcfg)["val"])
    idx = {"netG": [0, 1], "netD": [2, 3], "unet": [1, 2]}
    vidx = [0, 1]
    root = jax.random.key(jcfg.run.seed + 5)
    rng_h = jax.random.split(jax.random.fold_in(root, jnp.int32(0)), 3)[1]
    stack = {n: jax.tree.map(lambda x: x[jnp.asarray(i)][None], train_j)
             for n, i in idx.items()}
    hg, _ = jax.jit(lambda st, bs, vb, r: engine_j._darts_hypergrad(
        st, st, bs, vb, r))(state, stack, jax.tree.map(
            lambda x: x[jnp.asarray(vidx)], val_j), rng_h)
    jax_norm = float(optax.global_norm(hg))

    splits = load_splits(parse_config(ARGV))
    train_t, val_t = (to_device_split(splits[k], "cpu")
                      for k in ("train", "val"))
    batches = {n: take_batch(train_t, i) for n, i in idx.items()}
    draws = {ph: [phase_draws(root, 0, ph, batches)]
             for ph in ("unroll", "hyper", "replay")}
    engines, metrics = {}, {}
    for mode in ("darts", "decay_only"):
        cfg = parse_config(ARGV + [f"--engine.hypergrad={mode}",
                                   "--run.device=cpu"])
        engine, _, _ = tte.build_engine(cfg, "cpu")
        sync_port(engine, host)
        metrics[mode] = engine.engine_step([batches], take_batch(val_t, vidx),
                                           draws)
        engines[mode] = engine
    port_norm = float(metrics["darts"]["arch_grad_norm"])
    print(f"end2end_sivae darts: hypergradient norm {port_norm} in the "
          f"port, {jax_norm} in the JAX package")
    assert port_norm == jax_norm == 0.0
    for k, v in metrics["decay_only"].items():
        if k.startswith("replay_"):
            assert float(v) == float(metrics["darts"][k]), k
    for p, q in zip(engines["darts"].problems,
                    engines["decay_only"].problems):
        a, b = p.module.state_dict(), q.module.state_dict()
        assert all(torch.equal(a[n], b[n]) for n in a), p.name
    assert torch.equal(engines["darts"].arch["conv"],
                       engines["decay_only"].arch["conv"])
    assert set(PROBLEMS) == set(idx)
