"""The ``darts`` hypergradient at its default ``darts_epsilon`` (0.01): is
the gap between the two packages the port's fault or f32 conditioning?

The case of ``tests/test_torch_engine_modes.py`` (a): ``darts`` with
``arch_children=netG,unet``, live fakes, ``minmax``, on the real nets at
32px, f32, from bridged state; here at ``darts_epsilon`` 0.01, two
iterations, each from the JAX engine's state before it. At every iteration
the port's darts term (``_darts_hypergrad`` at the JAX engine's unrolled
state) is taken three times: on the state as it is; with every weight
multiplied by (1 + 1e-7), about one f32 ulp, as
``scripts/drift_chaos_control.py`` perturbs it; and at ``darts_epsilon``
0.0101 (a finite-difference step 1% longer).

Measured (f32, on the CPU): against the JAX term 4.3e-3 and 7.0e-3
relative (the records' 2.9e-3 and 7.0e-3 came from the JAX package's
op-by-op init; this test jits it, which moves the initial weights by
rounding); one ulp moves the port's own term by 4.4e-3 and 7.1e-3 here
(from the op-by-op init, by 1e-6 only: where the state lies next to a
switch decides it), and a 1% longer step by 1.2e-3 and 1.2e-2. The arch gradient of the U-Net problem's loss is
piecewise smooth in the U-Net's weights (ReLU and max-pool switches): at
the shifted weights ``w + eps v`` it jumps by up to half a component
between steps 1% apart, in both packages alike, and where an evaluation
lies next to such a switch, rounding decides its side; the difference
``g+ - g-`` over ``2 eps`` carries the jump whole. So the gap is the
finite difference's conditioning at this step, not a fault of the port.
Held: the packages within 1e-2 at 0.01, and the largest move of the
port's term under the 1% step change at least the largest cross-package
gap. All gaps are printed."""
import jax
import jax.numpy as jnp
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.train.common import load_splits as jload_splits
from semantic_segmentation_tpu.train.train_end2end import (
    build_engine as jbuild_engine, init_engine_state)
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train.common import load_splits
from semantic_segmentation_torch.train.train_end2end import (PROBLEMS,
                                                             build_engine)
from tests.test_torch_engine_modes import (ARGV, CASES, _sync_port,
                                           _unet_affines)

ITERS = 2
EXTRA = [a for a in CASES["darts_live"][0]
         if not a.startswith("--engine.darts_epsilon")] + [
    "--engine.darts_epsilon=0.01"]


def _hg_norm(engine, batches, val_batch, draws):
    hg, _ = engine._darts_hypergrad(batches, val_batch, draws)
    return float(torch.sqrt(sum((v.double() ** 2).sum()
                                for v in hg.values())))


def test_darts_epsilon_001_gap_is_conditioning():
    jcfg = jparse(ARGV + EXTRA, preset="end2end_jsrt")
    cfg = parse_config(ARGV + EXTRA + ["--run.device=cpu"],
                       preset="end2end_jsrt")
    assert cfg.engine.darts_epsilon == jcfg.engine.darts_epsilon == 0.01
    engine_j, p2p_j, seg_j = jbuild_engine(jcfg)
    # one jitted init instead of flax's op-by-op one
    state = jax.jit(lambda key: init_engine_state(
        jcfg, engine_j, p2p_j, seg_j, key))(jax.random.key(0))
    jsplits = jload_splits(jcfg)
    train_j = device_put_split(jsplits["train"])
    val_j = device_put_split(jsplits["val"])
    engine, _, _ = build_engine(cfg, "cpu")
    splits = load_splits(cfg)
    train_t = to_device_split(splits["train"], "cpu")
    val_t = to_device_split(splits["val"], "cpu")
    bs = cfg.data.batch_size
    streams = {n: epoch_index_batches(4, bs, seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(2, bs, seed=cfg.run.seed + 99)
    root = jax.random.key(cfg.run.seed + 5)
    unroll_j = jax.jit(engine_j._unroll)
    cross, ulp, step = [], [], []
    for it in range(ITERS):
        idx = {n: next(s) for n, s in streams.items()}
        vidx = next(val_stream)
        rng_u = jax.random.split(jax.random.fold_in(root, jnp.int32(it)),
                                 3)[0]
        state_k, _ = unroll_j(state, state.arch,
                              {n: jax.tree.map(lambda x: x[idx[n]][None],
                                               train_j) for n in PROBLEMS},
                              rng_u)
        state_k = jax.device_get(state_k)
        state, mj = engine_j.engine_step_sampled(
            state, train_j, val_j, {n: idx[n][None] for n in PROBLEMS},
            vidx, jnp.int32(it), root, PROBLEMS)
        ref = float(mj["arch_grad_norm"])
        draws = [{"unet": {"affine": _unet_affines(root, it, "darts", bs,
                                                   32)}}]
        batches = [{n: take_batch(train_t, idx[n]) for n in PROBLEMS}]
        val_batch = take_batch(val_t, vidx)
        _sync_port(engine, state_k)
        port = _hg_norm(engine, batches, val_batch, draws)
        engine.darts_epsilon = 0.0101
        step.append(abs(_hg_norm(engine, batches, val_batch, draws) - port)
                    / abs(port))
        engine.darts_epsilon = 0.01
        with torch.no_grad():
            for p in engine.problems:
                for w in p.module.parameters():
                    w.mul_(1.0 + 1e-7)
        port_ulp = _hg_norm(engine, batches, val_batch, draws)
        cross.append(abs(port - ref) / abs(ref))
        ulp.append(abs(port_ulp - port) / abs(port))
    print("darts_epsilon 0.01, arch_grad_norm: port against JAX",
          [f"{g:.2e}" for g in cross], "| port against the port one ulp "
          "away", [f"{g:.2e}" for g in ulp], "| port at step 0.0101 against "
          "0.01", [f"{g:.2e}" for g in step])
    assert max(cross) < 1e-2
    assert max(step) >= max(cross), (cross, step)
