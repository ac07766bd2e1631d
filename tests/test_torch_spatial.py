"""The port's spatial parallelism (``parallel/spatial.py``, UNet3D on depth
slabs, ``train_unet3d --run.spatial_axis``) on the CPU against the JAX
package's.

On a pool of four gloo ranks (``parallel/launch.RankPool``, one thread
each; the meshes over its first ranks):

- one SGD step of ``tests/test_spatial.py``'s UNet3D (crop 16, widths
  (4, 8, 16), bottleneck 32, float32, lr 1e-2) on 2 ranks (every level
  splits into even slabs) and on 4 (the thin depths: the third level and
  the bottleneck run whole on every rank), against JAX's single-device
  step from the same weights: the loss within 1e-5 relative, the
  parameters and BN statistics within 1e-5 per leaf relative;
- the halo under ``torch.autograd.gradcheck`` in float64 on 2 ranks, with
  slabs of two slices and of one (both neighbours' halos land on it);
- ``train_unet3d`` at ``spatial_axis=2`` against 1 (it starts its ranks
  itself): the logged losses within 1e-5 relative; ``unet3d.pt`` loads
  into a plain net, whose one-process validation Dice equals the spatial
  run's ``best_val`` (RMSprop's first steps move the conv biases that BN
  cancels by 10 lr with the sign of their rounding, so the two runs'
  best nets, and their argmax Dice on an untrained net, part);
- ``spatial_mesh_from_config``: 0 resolves to the visible count, 1 is off,
  a size above the count raises.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_segmentation_tpu.models.unet3d import UNet3D as JUNet3D
from semantic_segmentation_tpu.train.train_end2end_3d import \
    seg3d_loss as jseg3d_loss
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.unet3d import UNet3D
from semantic_segmentation_torch.parallel import (collectives, harness, mesh,
                                                  spatial)
from semantic_segmentation_torch.train import train_unet3d
from semantic_segmentation_torch.train.train_end2end_3d import \
    load_volume_splits
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      state_dict_to_flax)
from tests.test_torch_tensor_parallel import BackgroundPool

CROP, WIDTHS, BOTTLENECK, LR = 16, (4, 8, 16), 32, 1e-2


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    pool = BackgroundPool(4, "cpu", timeout=120.0, threads=1,
                          workdir=str(tmp_path_factory.mktemp("pool")),
                          warm=[(harness.warm_up, (None, None, (
                              "semantic_segmentation_torch.train."
                              "train_end2end_3d",)))])
    try:
        yield pool
    finally:
        pool.pool.close()


@pytest.fixture(autouse=True)
def _join_in_time(monkeypatch):
    """A trainer that starts its own ranks waits at most 120 s for them."""
    from semantic_segmentation_torch.parallel import launch
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", 120.0)


@pytest.fixture(scope="module")
def jax_step():
    """``tests/test_spatial.py``'s single-device SGD step from the port's
    init (bridged), and its batch."""
    net = UNet3D(1, 2, WIDTHS, BOTTLENECK, torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    model = JUNet3D(in_channels=1, num_classes=2, level_channels=WIDTHS,
                    bottleneck_channel=BOTTLENECK, dtype=jnp.float32)
    params, stats = jax.tree.map(jnp.asarray, state_dict_to_flax(net, start))
    tx = optax.sgd(LR)

    @jax.jit
    def step(params, stats, batch):
        def lf(p):
            logits, mut = model.apply({"params": p, "batch_stats": stats},
                                      batch["B"], train=True,
                                      mutable=["batch_stats"])
            return jseg3d_loss(logits, batch["mask"]), mut

        (loss, mut), grads = jax.value_and_grad(lf, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), mut["batch_stats"], loss

    rng = np.random.default_rng(3)
    batch = {"B": rng.standard_normal((2, CROP, CROP, CROP, 1), np.float32),
             "mask": (rng.random((2, CROP, CROP, CROP)) > 0.5)
             .astype(np.float32)}
    p1, s1, loss = jax.device_get(step(params, stats, batch))
    return start, batch, float(loss), flax_to_state_dict(net, p1, s1)


@pytest.mark.parametrize("ranks", [2, 4])
def test_spatial_step_matches_jax(ranks, pool4, jax_step):
    start, batch, loss, want = jax_step
    got = pool4.run(harness.unet3d_sgd_step, WIDTHS, BOTTLENECK, start,
                    batch, LR, ranks)
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (got["loss"], loss)
    bn = [k for k in want if "running" in k]
    p_gap, bn_gap = (harness.leaf_gap(
        {k: got["state"][k] for k in keys}, {k: want[k] for k in keys})
        for keys in ([k for k in want if k not in bn], bn))
    assert p_gap <= 1e-5 and bn_gap <= 1e-5, (p_gap, bn_gap)
    print(f"spatial step on {ranks} ranks: loss {got['loss']!r} against "
          f"JAX's {loss!r}; relative per leaf: parameters {p_gap:.3e}, BN "
          f"{bn_gap:.3e}")


@pytest.mark.parametrize("slab", [2, 1])
def test_halo_gradcheck(slab, pool4):
    assert pool4.run(harness.halo_gradcheck, slab, ranks=2)


def test_train_unet3d_spatial_matches_one_process(tmp_path):
    argv = ["--data.synthetic=true", "--data.n_train=3", "--data.n_val=1",
            "--data.n_test=1", "--data.batch_size=1",
            "--model.base_features=4", "--model.compute_dtype=float32",
            "--engine.valid_step=2", "--run.device=cpu",
            f"--run.save_dir={tmp_path}"]
    runs = {}
    for axis in (1, 2):
        cfg = parse_config(argv + [f"--run.spatial_axis={axis}",
                                   f"--run.name=sp{axis}"])
        runs[axis] = train_unet3d.train(cfg, train_iters=4, crop=CROP)
    (_, one), (_, two) = runs[1], runs[2]
    assert [r["step"] for r in two["log"]] == [2, 4]
    for a, b in zip(two["log"], one["log"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
    # the spatial run's best net, saved by rank 0 in the one-process
    # layout, scores its best_val in one process
    cfg = parse_config(argv + ["--run.name=sp2"])
    net = train_unet3d.build_unet3d(cfg, "cpu")
    net.load_state_dict(torch.load(tmp_path / "sp2" /
                                   train_unet3d.MODEL_FILE))
    with collectives.replicated():
        val = train_unet3d.evaluate(net, load_volume_splits(cfg, CROP)["val"],
                                    1, contextlib.nullcontext)
    assert val == two["best_val"], (val, two["best_val"])
    assert np.isfinite(two["test_dice"])
    print(f"train_unet3d spatial 2 against 1: losses "
          f"{[r['loss'] for r in two['log']]} against "
          f"{[r['loss'] for r in one['log']]}; best_val {two['best_val']!r} "
          f"against {one['best_val']!r}")


def test_spatial_axis_resolves(monkeypatch):
    cfg = parse_config(["--run.device=cpu", "--run.spatial_axis=0"])
    monkeypatch.setattr(mesh, "visible_devices", lambda device_type: 3)
    monkeypatch.setattr(spatial, "visible_devices", lambda device_type: 3)
    got = spatial.spatial_mesh_from_config(cfg)
    assert (got.size, got.rank, got.group) == (3, 0, None)
    cfg.run.spatial_axis = 1
    assert spatial.spatial_mesh_from_config(cfg) is None
    cfg.run.spatial_axis = 4
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        spatial.spatial_mesh_from_config(cfg)
