"""Three ``decay_only`` engine iterations of the port against the JAX
package's ``BilevelEngine`` at 32px, f32: the same initial weights (bridged),
the same index streams, and for the unet problem the augment affines the
JAX engine draws, re-derived from its key chain (train_end2end.py:339 ->
bilevel.py:331 -> :249,273 -> :152 -> :120 -> train_end2end.py:107). No
dropout layer is live in a unet_32 generator. Losses agree within rtol 1e-3
(the uint8 chain can move a quantisation level; the largest gap is printed)
and the arch tables within 1e-6. The first iteration also runs
data-parallel on two gloo ranks (one row each, the same state and draws)
and tensor-parallel on them (``tp_engine_step``, mesh (data 1, model 2)),
and each is held to the JAX engine's losses the same way, and to the
port's single process within 1e-4 relative, the tensor-parallel step's
gradients of G and D within 1e-5 per leaf (the unet's is printed: a
sharded conv's other order of sums moves a fake's uint8 level now and
then; ``tests/test_torch_engine_modes.py`` and ``_hypergrad.py`` hold it
with float fakes) (``tests/test_torch_engine_modes.dp_first_iteration``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.ops.augment import sample_affine_batch
from semantic_segmentation_tpu.train.common import load_splits as jload_splits
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train.common import load_splits
from semantic_segmentation_torch.train.train_end2end import (PROBLEMS,
                                                             build_engine)
from semantic_segmentation_torch.utils.bridge import load_flax
from semantic_segmentation_torch.parallel.data_parallel import to_cpu
from tests.test_torch_engine_modes import (  # noqa: F401
    dp_first_iteration, jit_build_engine_and_state, rank_pool)

ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=4",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.netG=unet_32", "--model.ngf=8", "--model.ndf=8",
        "--model.base_features=8"]


def _unet_affines(root, step: int, batch: int, size: int):
    """The matrices ``loss_unet`` samples at engine step ``step`` (K = 1,
    problem index 2)."""
    rng = jax.random.fold_in(root, jnp.int32(step))
    _, _, rng_r = jax.random.split(rng, 3)
    r = jax.random.split(rng_r, 1)[0]
    rng_aug = jax.random.split(jax.random.fold_in(r, 2), 3)[0]
    return np.array(sample_affine_batch(rng_aug, batch, size, size))


def test_three_decay_only_iterations_match_jax(rank_pool):
    jcfg = jparse(ARGV, preset="end2end_jsrt")
    cfg = parse_config(ARGV + ["--run.device=cpu"], preset="end2end_jsrt")
    assert cfg.engine.hypergrad == jcfg.engine.hypergrad == "decay_only"

    engine_j, state, _, _ = jit_build_engine_and_state(jcfg,
                                                       jax.random.key(0))
    jsplits = jload_splits(jcfg)
    splits = load_splits(cfg)
    for k in ("image", "mask", "image_pix2pix", "mask_pix2pix"):
        np.testing.assert_array_equal(splits["train"][k],
                                      jsplits["train"][k])
    train_j = device_put_split(jsplits["train"])
    val_j = device_put_split(jsplits["val"])

    engine, p2p, seg = build_engine(cfg, "cpu")
    load_flax(p2p.G, jax.device_get(state.params["netG"]),
              jax.device_get(state.stats["netG"]))
    load_flax(p2p.D, jax.device_get(state.params["netD"]),
              jax.device_get(state.stats["netD"]))
    load_flax(seg.net, jax.device_get(state.params["unet"]),
              jax.device_get(state.stats["unet"]))
    with torch.no_grad():
        for k, v in p2p.arch.items():
            v.copy_(torch.from_numpy(np.array(state.arch[k])))
    train_t = to_device_split(splits["train"], "cpu")

    n_train, bs = 4, cfg.data.batch_size
    streams = {n: epoch_index_batches(n_train, bs, seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(2, bs, seed=cfg.run.seed + 99)
    root = jax.random.key(cfg.run.seed + 5)

    worst = 0.0
    for it in range(3):
        idx = {n: next(s) for n, s in streams.items()}
        state, mj = engine_j.engine_step_sampled(
            state, train_j, val_j, {n: idx[n][None] for n in PROBLEMS},
            next(val_stream), jnp.int32(it), root, PROBLEMS)
        mats = torch.from_numpy(_unet_affines(root, it, bs, 32))
        batches = [{n: take_batch(train_t, idx[n]) for n in PROBLEMS}]
        draws = {"replay": [{"unet": {"affine": mats}}]}
        start = to_cpu(engine.state_dict()) if it == 0 else None
        mt = engine.engine_step(batches, None, draws)
        if start is not None:
            dp_gaps = dp_first_iteration(
                rank_pool, ARGV + ["--run.device=cpu"], "end2end_jsrt",
                start, (batches, None, draws), mj,
                {k: float(v) for k, v in mt.items()})
        for n in PROBLEMS:
            a, b = float(mt[f"loss_{n}"]), float(mj[f"loss_{n}"])
            assert np.isfinite(a)
            gap = abs(a - b) / abs(b)
            worst = max(worst, gap)
            assert gap < 1e-3, (it, n, a, b)
    print(f"largest relative loss gap over 3 iterations: {worst:.3e}; two "
          f"ranks: to JAX {dp_gaps['jax']:.3e}, to one process "
          f"{dp_gaps['single']:.3e}; tensor-parallel (1, 2): to JAX "
          f"{dp_gaps['tp_jax']:.3e}, to one process "
          f"{dp_gaps['tp_single']:.3e}, gradients per leaf "
          f"{dp_gaps['tp_grads']:.3e}; the unet's batches differ in "
          f"{dp_gaps.get('tp_fake_levels_moved', 0.0):.3e} of their elements "
          f"(fake uint8 levels), its gradient then "
          f"{dp_gaps.get('tp_unet_grads_uint8', 0.0):.3e} per leaf")
    for k, v in p2p.arch.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(state.arch[k]),
                                   rtol=0, atol=1e-6)
    assert engine.step == 3
