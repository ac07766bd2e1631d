"""The port's tensor parallelism (``parallel/tensor_parallel.py``) on the CPU
against the JAX package's.

One pool of four gloo ranks for the file (``parallel/launch.RankPool``, one
thread each, torch and the port only), the meshes laid over its first
ranks (``make_dp_tp_mesh``: rank d * n_model + m):

- ``tp_seg_step`` (U-Net width 8, 32², 8 images, RMSprop at lr 1e-3:
  ``tests/test_parallel.py``'s set-up, from the port's init bridged to
  flax) at meshes (2, 2) and (1, 2), against JAX's ``tp_seg_step`` on the
  8-device mesh (2, 4): the loss within 1e-5 relative; the gradient
  within 1e-5 per leaf of ``jax.grad`` of the global loss in float64
  (``harness.leaf_gap``; JAX's float32 gradient is ill-conditioned at
  width 8, ``tests/test_torch_parallel.py``); the parameters within 1e-5
  of JAX's RMSprop step from that gradient, the BN statistics within 1e-5
  of JAX's; the gradient within 1e-5 of the port's one process; the
  shards real (rank 0 holds ``C / n_model`` output channels, the first
  ones) and the gathered state loadable by a plain net;
- the gradient of the generator's arch table (the NAS mixed up-convs take
  it through sharded kernels) at (1, 2) and (2, 2) against one process:
  within 1e-5 relative, the model group's sum;
- one ``decay_only`` engine iteration at (2, 2), its fakes min-max
  normalized (float), against the port's one process, run alone on rank
  0 in the ranks' own setting (metrics 1e-5,
  the step's gradients, parameters and BN statistics 1e-5 per leaf:
  ``tests/test_torch_parallel._hold_state``).
  ``tests/test_torch_engine.py``, ``_engine_modes.py`` and
  ``_hypergrad.py`` hold ``tp_engine_step`` at (1, 2) in ``decay_only``,
  ``darts`` and ``unroll`` to the JAX engine's iteration as well;
- the mesh's rank layout and its refusal of more ranks than the group.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.parallel import (collectives, harness,
                                                  tensor_parallel)
from semantic_segmentation_torch.parallel.data_parallel import to_cpu
from semantic_segmentation_torch.parallel.launch import RankPool
from tests.test_torch_parallel import (ENGINE_ARGV, _draws, _hold_state,
                                       engine_start)  # noqa: F401

SEG_ARGV = ("--model.base_features=8", "--model.compute_dtype=float32",
            "--optim.unet_lr=1e-3", "--run.device=cpu")
# float fakes: under the uint8 chain a sharded conv's other order of sums
# can move a fake's uint8 level, and the unet's gradient with it
ENGINE_MINMAX_ARGV = tuple(ENGINE_ARGV + ["--engine.fake_postprocess=minmax"])


class BackgroundPool:
    """A ``RankPool`` started in a thread, and ``warm`` ((function,
    arguments) to run on its ranks) run on it there, so that its ranks
    start while the module's JAX programs compile; ``run`` waits for
    it."""

    def __init__(self, *args, warm=(), **kwargs):
        self._box = {}
        self._thread = threading.Thread(target=self._start, args=(
            args, kwargs, warm))
        self._thread.start()

    def _start(self, args, kwargs, warm):
        try:
            self._box["pool"] = RankPool(*args, **kwargs)
            for fn, fn_args in warm:
                self._box["pool"].run(fn, *fn_args)
        except BaseException as e:     # raised again by ``pool``
            self._box["error"] = e

    @property
    def pool(self) -> RankPool:
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["pool"]

    def run(self, *args, **kwargs):
        return self.pool.run(*args, **kwargs)


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    pool = BackgroundPool(
        4, "cpu", timeout=120.0, threads=1,
        workdir=str(tmp_path_factory.mktemp("pool")),
        warm=[(harness.warm_up, (SEG_ARGV, ENGINE_MINMAX_ARGV))])
    try:
        yield pool
    finally:
        pool.pool.close()


@pytest.fixture(scope="module")
def jax_tp_seg():
    """JAX's ``tp_seg_step`` on the (2, 4) mesh from the port's init, the
    float64 gradient of the global loss, and the port's one process."""
    from semantic_segmentation_tpu.models.seg import SegProblem as JSeg
    from semantic_segmentation_tpu.models.seg import SegState
    from semantic_segmentation_tpu.parallel.tensor_parallel import (
        make_dp_tp_mesh, tp_seg_step)
    from semantic_segmentation_torch.data.pipeline import stack_dataset
    from semantic_segmentation_torch.data.synthetic import \
        SyntheticSegDataset
    from semantic_segmentation_torch.train.common import build_seg_problem
    from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                          state_dict_to_flax)
    seg = build_seg_problem(parse_config(list(SEG_ARGV)), "cpu")
    start = to_cpu(seg.net.state_dict())
    prob = JSeg("unet", 1, 1, lr=1e-3, compute_dtype=jnp.float32,
                base_features=8)
    params, stats = jax.tree.map(jnp.asarray,
                                 state_dict_to_flax(seg.net, start))
    state = SegState(params=params, stats=stats, opt=prob.tx.init(params),
                     step=jnp.zeros((), jnp.int32))
    data = stack_dataset(SyntheticSegDataset(n=8, size=32))
    batch = {k: np.asarray(v) for k, v in data.items()
             if k in ("image", "mask")}
    s_j, m_j = tp_seg_step(prob, make_dp_tp_mesh(2, 4), state, batch)
    with jax.enable_x64():
        prob64 = JSeg("unet", 1, 1, lr=1e-3, compute_dtype=jnp.float64,
                      base_features=8)
        p64, st64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 (params, stats))
        g64 = jax.device_get(jax.jit(jax.grad(lambda p: prob64.loss(
            p, st64, batch["image"].astype(np.float64),
            batch["mask"])[0]))(p64))
    with collectives.replicated():
        one = harness.seg_steps(SEG_ARGV, "cpu", start, [batch])

    def rmsprop_step(grads: dict) -> dict:
        """JAX's RMSprop step from the start on the state dict ``grads``,
        with the JAX step's BN statistics."""
        g = jax.tree.map(jnp.asarray, state_dict_to_flax(seg.net, grads)[0])
        updates, _ = prob.tx.update(g, state.opt, state.params)
        return flax_to_state_dict(seg.net, *jax.device_get((
            optax.apply_updates(state.params, updates), s_j.stats)))

    return {"start": start, "batch": batch, "loss": float(m_j["loss"]),
            "g64": flax_to_state_dict(seg.net, g64), "one": one,
            "step": rmsprop_step, "net": seg.net}


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)])
def test_tp_seg_step_matches_jax(mesh, pool4, jax_tp_seg):
    j = jax_tp_seg
    got = pool4.run(harness.seg_steps, SEG_ARGV, "cpu", j["start"],
                    [j["batch"]], mesh)
    loss = got["losses"][0]
    assert abs(loss - j["loss"]) <= 1e-5 * abs(j["loss"]), (loss, j["loss"])
    g_gap = harness.leaf_gap(got["grads"], j["g64"])
    one_gap = harness.leaf_gap(got["grads"], j["one"]["grads"])
    assert g_gap <= 1e-5 and one_gap <= 1e-5, (g_gap, one_gap)
    want = j["step"](got["grads"])
    bn = [k for k in want if "running" in k]
    p_gap, bn_gap = (harness.leaf_gap({k: got["state"][k] for k in keys},
                                      {k: want[k] for k in keys}, floor=0.0)
                     for keys in (got["grads"], bn))
    assert p_gap <= 1e-5 and bn_gap <= 1e-5, (p_gap, bn_gap)
    # the shards are real: model rank 0 holds the first C / n_model output
    # channels of every covered layer (and the head of 1 stays whole)
    n_model = mesh[1]
    assert got["model_rank"] == 0
    sh = got["sharded"]
    assert sh["inc.conv0.weight"].shape == (8 // n_model, 1, 3, 3)
    torch.testing.assert_close(sh["inc.conv0.weight"],
                               j["start"]["inc.conv0.weight"][:8 // n_model],
                               rtol=0, atol=0)
    assert sh["inc.bn0.running_var"].shape == (8 // n_model,)
    assert sh["outc.weight"].shape == j["start"]["outc.weight"].shape
    # gathered, the state is the one-process layout
    j["net"].load_state_dict(got["state"])
    print(f"tp_seg_step {mesh}: loss {loss!r} against JAX's {j['loss']!r}; "
          f"relative per leaf: gradients {g_gap:.3e} (one process "
          f"{one_gap:.3e}), parameters {p_gap:.3e}, BN {bn_gap:.3e}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_arch_gradient_is_the_model_groups_sum(mesh, pool4):
    x = np.random.default_rng(0).standard_normal((4, 1, 32, 32)).astype(
        np.float32)
    got = pool4.run(harness.generator_arch_grad, x, mesh)
    with collectives.replicated():
        one = harness.generator_arch_grad(x)
    scale = one.abs().max().item()
    assert scale > 0
    gap = (got - one).abs().max().item() / scale
    assert gap <= 1e-5, gap
    print(f"arch gradient {mesh}: {gap:.3e} of its largest from one process")


def test_tp_engine_step_2x2_matches_one_process(pool4, engine_start):
    start, batch_stack, val_batch = engine_start
    argv = ENGINE_MINMAX_ARGV
    step = (batch_stack, val_batch,
            _draws("decay_only", jax.random.key(
                parse_config(list(argv)).run.seed + 5)))
    got = pool4.run(harness.engine_iterations, argv, "end2end_jsrt", "cpu",
                    start, [step], mesh=(2, 2))
    # one process in the ranks' own setting (their thread count)
    one = pool4.run(harness.engine_iterations_alone, argv, "end2end_jsrt",
                    "cpu", start, [step])
    assert got["tp"]["calls"] > 0 and got["grad_allreduce"]["calls"] > 0
    sharded, whole = got["leaf_bytes"]
    assert sharded > 0 and whole > 0
    for k, v in one["metrics"][0].items():
        assert abs(got["metrics"][0][k] - v) <= 1e-5 * abs(v) or \
            got["metrics"][0][k] == v == 0.0, k
    worst = _hold_state(argv, "end2end_jsrt", start, got["state"],
                        one["state"])
    assert got["state"]["arch"].keys() == one["state"]["arch"].keys()
    for k, a in one["state"]["arch"].items():
        assert (got["state"]["arch"][k] - a).abs().max() <= 1e-6, k
    print(f"tp_engine_step (2, 2) decay_only: state gaps {worst}, model "
          f"group {got['tp']['calls']} all-reduces, {got['tp']['bytes']} "
          f"bytes")


def test_mesh_layout_and_size(pool4):
    got = pool4.run(harness.mesh_layout, (2, 2))
    assert got == {"rank": 0, "data_rank": 0, "model_rank": 0,
                   "data_group": [0, 2], "model_group": [0, 1]}
    with pytest.raises(ValueError, match="needs 16 devices, have 1"):
        tensor_parallel.make_dp_tp_mesh(4, 4, "cpu")
    one = tensor_parallel.make_dp_tp_mesh(1, 1, "cpu")
    assert (one.shape, one.data_mesh.size) == ({"data": 1, "model": 1}, 1)
