"""The port's data-parallel layer on the CPU against the JAX package's.

- The mesh helpers against ``semantic_segmentation_tpu/parallel/mesh.py``:
  ``host_shard_indices`` for each process index bit for bit,
  ``pad_to_multiple``, ``mesh_from_config``'s cases of
  ``tests/test_parallel.py:90-101`` and the single-process forms of
  ``:129-158``.
- On two gloo ranks (one ``RankPool`` for the file, joined through a file
  store under the test's temporary directory; each rank one thread, torch
  and the port only), from the port's init (bridged to the JAX package
  where JAX runs):
  - each collective the path uses, against its single-process value;
  - ``dp_seg_step`` (U-Net width 8, 32², f32, a global batch of 4 whose
    halves differ) against JAX's ``dp_seg_step`` on a 2-device mesh: the
    loss within 1e-5 relative; the averaged gradient within 1e-5 of
    ``jax.grad`` of the global loss in float64 (JAX's float32 gradient is
    ill-conditioned here); the parameters within 1e-5 of JAX's RMSprop
    step from that gradient, the BN statistics within 1e-5. Each relative
    per leaf (``harness.leaf_gap``: a gradient leaf against its own
    largest |value|, or 1e-2 of the net's largest where that is more);
  - ``dp_engine_step`` at smoke width (``unet_32``, ngf = ndf = 8, U-Net
    base 8, 32², f32, global batch 4), one iteration from the port's
    initial state with the JAX engine's affine draws (global, injected),
    in ``decay_only``, ``end2end_nas``'s ``unroll`` (``minmax`` fakes,
    whose min-max gradient crosses the ranks) and ``darts`` at ε 0.1 with
    the unet child live, against the port's single process: the losses
    and ``outer_loss`` within 1e-5 relative, ``arch_grad_norm`` within
    1e-3 (``unroll``) and 0.1 (``darts``: its term is a finite difference
    taken at the inner steps' end, which the two runs reach apart by
    rounding; the term itself, from one state, within 1e-4), the arch
    tables within 1e-6 (2 ``arch_lr`` under ``darts``); per problem, the
    averaged gradients of the last step within 1e-5, the parameters
    within 1e-5 of the optimizer's step on them, the BN statistics
    within 1e-5. The JAX engine's own DP step equals its single-device
    one (``tests/test_parallel.py``); ``tests/test_torch_engine*.py`` and
    ``tests/test_torch_hypergrad.py`` hold the two ranks' metrics to the
    JAX engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.parallel import harness, mesh
from semantic_segmentation_torch.parallel.data_parallel import to_cpu
from semantic_segmentation_torch.parallel.launch import RankPool

# tests/test_torch_engine_modes.py's configuration (global batch 2, one
# row a rank)
JAX_ARGV = ["--data.synthetic=true", "--data.image_size=32",
            "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
            "--model.compute_dtype=float32", "--model.netG=unet_32",
            "--model.ngf=8", "--model.ndf=8", "--model.base_features=8"]
ENGINE_ARGV = JAX_ARGV + ["--run.device=cpu"]
IDX = {"netG": np.array([0, 1]), "netD": np.array([3, 1]),
       "unet": np.array([2, 0])}
VIDX = np.array([1, 0])
MODES = {
    "decay_only": ([], "end2end_jsrt"),
    "unroll": ([], "end2end_nas"),
    "darts": (["--engine.hypergrad=darts", "--engine.arch_children=netG,unet",
               "--engine.detach_fakes=false",
               "--engine.fake_postprocess=minmax",
               "--engine.darts_epsilon=0.1"], "end2end_jsrt"),
}


@pytest.fixture(autouse=True)
def _join_in_time(monkeypatch):
    """A trainer that starts its own ranks waits at most 120 s for them."""
    from semantic_segmentation_torch.parallel import launch
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", 120.0)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(2, "cpu", timeout=120.0, threads=1,
                  workdir=str(tmp_path_factory.mktemp("pool"))) as p:
        yield p


# -- the mesh helpers --------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3])
def test_host_shard_indices_match_jax(world, monkeypatch):
    from semantic_segmentation_tpu.parallel import mesh as jmesh
    shards = []
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        monkeypatch.setattr(mesh, "process_count", lambda: world)
        got = mesh.host_shard_indices(11, seed=3, epoch=2)
        np.testing.assert_array_equal(got, jmesh.host_shard_indices(11, 3, 2))
        shards.append(got)
    assert sorted(np.concatenate(shards).tolist()) == list(range(11))


@pytest.mark.parametrize("n,multiple", [(8, 4), (7, 4), (5, 2), (1, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    from semantic_segmentation_tpu.parallel.mesh import pad_to_multiple
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, ref = mesh.pad_to_multiple(arr, multiple), pad_to_multiple(
        arr, multiple)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] == n


def test_mesh_from_config_validation():
    from semantic_segmentation_tpu.core.config import parse_config as jparse
    from semantic_segmentation_tpu.parallel.mesh import \
        mesh_from_config as jmesh_from_config
    cpu = ["--run.device=cpu"]
    argv = ["--run.data_axis=8", "--data.batch_size=8"]
    assert mesh.mesh_from_config(parse_config(argv + cpu)).devices.size == \
        jmesh_from_config(jparse(argv)).devices.size == 8
    assert mesh.mesh_from_config(parse_config(["--run.data_axis=1"])) is None
    assert jmesh_from_config(jparse(["--run.data_axis=1"])) is None
    bad = ["--run.data_axis=8", "--data.batch_size=2"]
    with pytest.raises(ValueError):
        jmesh_from_config(jparse(bad))
    with pytest.raises(ValueError, match="divide"):
        mesh.mesh_from_config(parse_config(bad + cpu))
    # more ranks than cards: this host has none (never the CPU instead)
    with pytest.raises(ValueError, match="devices"):
        mesh.mesh_from_config(parse_config(["--run.data_axis=2",
                                            "--data.batch_size=2"]))


def test_multihost_helpers_single_process():
    from semantic_segmentation_tpu.parallel.mesh import \
        host_shard_indices as jshard
    cfg = parse_config([])
    assert mesh.maybe_init_distributed(cfg) is False
    idx = mesh.host_shard_indices(10, seed=3, epoch=2)
    assert sorted(idx.tolist()) == list(range(10))
    np.testing.assert_array_equal(idx, jshard(10, seed=3, epoch=2))
    np.testing.assert_array_equal(idx, mesh.host_shard_indices(10, 3, 2))
    assert mesh.host_shard_indices(10, 3, 4).tolist() != idx.tolist()
    # one process is one rank: its local shard is the whole global batch
    m = mesh.make_data_mesh(1, "cpu")
    batch = {"image": np.arange(8 * 4, dtype=np.float32).reshape(8, 4)}
    np.testing.assert_array_equal(
        mesh.global_from_host_local(m, batch)["image"],
        mesh.shard_batch(m, batch)["image"])


def test_shard_batch_takes_each_ranks_rows():
    batch = {"image": torch.arange(12).reshape(6, 2), "k": [np.arange(6)]}
    rows = [mesh.shard_batch(mesh.DataMesh(3, r, "cpu"), batch)
            for r in range(3)]
    assert torch.equal(torch.cat([r["image"] for r in rows]), batch["image"])
    assert rows[1]["k"][0].tolist() == [2, 3]
    assert mesh.shard_batch(None, batch) is not batch
    assert mesh.replicate(mesh.DataMesh(3, 1, "cpu")) == slice(None)
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch(mesh.DataMesh(4, 0, "cpu"), batch)


# -- the collectives on two ranks ---------------------------------------------

def test_collectives_on_two_ranks(pool):
    got = pool.run(harness.collective_probe, "cpu", 3)
    x = torch.arange(6, dtype=torch.float32) + 1     # both ranks' rows
    assert got["world"] == 2
    assert not got["jax_loaded"]          # the ranks run torch and the port
    assert (got["lo"], got["hi"], got["sum"]) == (1.0, 6.0, 21.0)
    # rank 0 holds the minimum: d(hi - 2 lo)/dx is -2 there, 0 elsewhere
    np.testing.assert_array_equal(got["grad"].numpy(), [-2.0, 0.0, 0.0])
    var, mean = torch.var_mean(x, unbiased=False)
    np.testing.assert_allclose([got["mean"], got["var"]],
                               [float(mean), float(var)], rtol=1e-6)


# -- dp_seg_step --------------------------------------------------------------

def test_dp_seg_step_matches_jax(pool):
    from semantic_segmentation_tpu.models.seg import SegProblem as JSeg
    from semantic_segmentation_tpu.models.seg import SegState
    from semantic_segmentation_tpu.parallel.data_parallel import \
        dp_seg_step as jdp_seg_step
    from semantic_segmentation_tpu.parallel.mesh import make_data_mesh
    from semantic_segmentation_torch.data.pipeline import stack_dataset
    from semantic_segmentation_torch.data.synthetic import \
        SyntheticSegDataset
    from semantic_segmentation_torch.train.common import build_seg_problem
    from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                          state_dict_to_flax)
    argv = ("--model.base_features=8", "--model.compute_dtype=float32",
            "--run.device=cpu")
    cfg = parse_config(list(argv))
    seg = build_seg_problem(cfg, "cpu")
    start = to_cpu(seg.net.state_dict())
    # the JAX state from the port's init (flax's eager init traces for 10 s)
    prob = JSeg("unet", 1, 1, lr=cfg.optim.unet_lr, compute_dtype=jnp.float32,
                base_features=8)
    params, stats = jax.tree.map(jnp.asarray,
                                 state_dict_to_flax(seg.net, start))
    state = SegState(params=params, stats=stats, opt=prob.tx.init(params),
                     step=jnp.zeros((), jnp.int32))
    data = stack_dataset(SyntheticSegDataset(n=4, size=32, seed=7))
    batch = {k: np.asarray(v) for k, v in data.items()
             if k in ("image", "mask")}
    assert not np.array_equal(batch["image"][:2], batch["image"][2:])
    s_j, m_j = jdp_seg_step(prob, make_data_mesh(2), state, batch)

    # the global batch's gradient, which the sharded step takes, in
    # float64: JAX's float32 one is ill-conditioned here (flax's batch
    # norm takes E[x^2] - E[x]^2 over a few values a channel in the deep
    # layers), and so is the step its dp_seg_step takes from it
    with jax.enable_x64():
        prob64 = JSeg("unet", 1, 1, lr=cfg.optim.unet_lr,
                      compute_dtype=jnp.float64, base_features=8)
        p64, st64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 (params, stats))
        g64 = jax.device_get(jax.jit(jax.grad(lambda p: prob64.loss(
            p, st64, batch["image"].astype(np.float64),
            batch["mask"])[0]))(p64))
    g64 = flax_to_state_dict(seg.net, g64)

    got = pool.run(harness.seg_steps, argv, "cpu", start, [batch])
    ref = float(m_j["loss"])
    assert abs(got["losses"][0] - ref) <= 1e-5 * abs(ref), (got, ref)
    # the averaged gradient against the float64 one (``harness.leaf_gap``)
    g_gap = harness.leaf_gap(got["grads"], g64)
    assert g_gap <= 1e-5, g_gap
    # the parameters: JAX's RMSprop step (``prob.tx``) from that gradient
    grads = jax.tree.map(jnp.asarray,
                         state_dict_to_flax(seg.net, got["grads"])[0])
    updates, _ = prob.tx.update(grads, state.opt, state.params)
    want = flax_to_state_dict(seg.net, *jax.device_get((
        optax.apply_updates(state.params, updates), s_j.stats)))
    p_gap, bn_gap = (harness.leaf_gap(
        {k: got["state"][k] for k in keys}, {k: want[k] for k in keys},
        floor=0.0) for keys in (got["grads"], [k for k in want
                                               if "running" in k]))
    assert p_gap <= 1e-5 and bn_gap <= 1e-5, (p_gap, bn_gap)
    jax_step = flax_to_state_dict(seg.net, jax.device_get(s_j.params))
    print(f"dp_seg_step: loss {got['losses'][0]!r} against {ref!r}; "
          f"relative per leaf: gradients {g_gap:.3e}, parameters {p_gap:.3e} "
          f"(JAX's dp_seg_step's "
          f"{harness.leaf_gap(got['state'], jax_step, floor=0.0):.3e}), "
          f"BN statistics {bn_gap:.3e}")


# -- dp_engine_step ----------------------------------------------------------

@pytest.fixture(scope="module")
def engine_start():
    """The port's initial engine state and one iteration's global
    batches."""
    from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                           to_device_split)
    from semantic_segmentation_torch.train.common import load_splits
    from semantic_segmentation_torch.train.train_end2end import (PROBLEMS,
                                                                 build_engine)
    cfg = parse_config(ENGINE_ARGV, preset="end2end_jsrt")
    engine, _, _ = build_engine(cfg, "cpu")
    splits = load_splits(cfg)
    tr, va = (to_device_split(splits[s], "cpu") for s in ("train", "val"))
    batch_stack = [{n: take_batch(tr, IDX[n]) for n in PROBLEMS}]
    return (to_cpu(engine.state_dict()), batch_stack,
            take_batch(va, VIDX))


def _draws(mode: str, root):
    """The JAX engine's affine draws of its first iteration in every phase
    (``tests/test_torch_engine_modes.py``), for the global batch."""
    from tests.test_torch_engine_modes import _unet_affines
    phases = (("unroll", "unroll"), ("replay", "replay"),
              ("hyper", "darts" if mode == "darts" else "hyper"))
    return {ph: [{"unet": {"affine": _unet_affines(root, 0, key, 2, 32)}}]
            for ph, key in phases}


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_engine_step_matches_one_process(mode, pool, engine_start):
    """Two ranks against the port's single process, from one state with
    one set of (global) draws: the JAX engine's. ``tests/test_torch_engine.py``
    (``decay_only``), ``tests/test_torch_engine_modes.py`` (``darts``) and
    ``tests/test_torch_hypergrad.py`` (``unroll``) hold the two-rank
    iteration to the JAX engine's as well, beside the single process's
    (each JAX engine step traces for 20 to 60 s on this host, so they run
    once)."""
    start, batch_stack, val_batch = engine_start
    extra, preset = MODES[mode]
    argv = tuple(ENGINE_ARGV + extra)
    cfg = parse_config(list(argv), preset=preset)
    assert cfg.engine.hypergrad == mode
    step = (batch_stack, val_batch,
            _draws(mode, jax.random.key(cfg.run.seed + 5)))
    got = pool.run(harness.engine_iterations, argv, preset, "cpu", start,
                   [step])
    single = harness.engine_iterations(argv, preset, "cpu", start, [step])
    m_dp, s_dp = got["metrics"][0], got["state"]
    m_1, s_1 = single["metrics"][0], single["state"]
    assert got["world"] == 2 and single["world"] == 1
    assert got["grad_allreduce"]["calls"] > 0
    assert single["grad_allreduce"]["calls"] == 0
    assert set(m_dp) == set(m_1)
    gaps = {}
    for k, one in m_1.items():
        # darts takes its term at the unrolled state, which the inner steps
        # leave apart by rounding (RMSprop's steps on near-zero gradients);
        # the term is a finite difference of near-equal arch gradients
        # (ROADMAP.md section 3), which that moves by a few percent: the
        # term itself is held below, from one state
        tol = {("arch_grad_norm", "darts"): 0.1,
               ("arch_grad_norm", "unroll"): 1e-3}.get((k, mode), 1e-5)
        gaps[k] = abs(m_dp[k] - one) / max(abs(one), 1e-12)
        assert gaps[k] <= tol or m_dp[k] == one == 0.0, (k, m_dp[k], one)
    # the arch tables: within one Adam step with a flipped sign (2 arch_lr)
    # under darts, whose term carries that noise; else within 1e-6
    atol = 2 * cfg.optim.arch_lr if mode == "darts" else 1e-6
    for k, a in s_1["arch"].items():
        np.testing.assert_allclose(s_dp["arch"][k].numpy(), a.numpy(),
                                   rtol=0, atol=atol)
    worst = _hold_state(argv, preset, start, s_dp, s_1)
    if mode == "darts":
        hg2 = pool.run(harness.darts_term, argv, preset, "cpu", start, step)
        hg1 = harness.darts_term(argv, preset, "cpu", start, step)
        for k, h in hg1.items():
            scale = h.abs().max().item()
            assert (hg2[k] - h).abs().max().item() <= 1e-4 * max(scale,
                                                                 1e-12), k
        assert max(h.abs().max().item() for h in hg1.values()) > 0
    print(f"dp_engine_step {mode}: largest metric gap to one process "
          f"{max(gaps.values()):.3e} ({max(gaps, key=gaps.get)}), state "
          f"gaps (relative per leaf) "
          f"{ {k: f'{v:.3e}' for k, v in worst.items()} }")


def test_alone_and_on_ranks(pool, engine_start):
    """``harness.alone_and_on_ranks`` (``chip_smoke.py`` phase 7j (a)) on
    two CPU ranks, one ``decay_only`` iteration from fresh nets: rank 0's
    runs alone have the collectives off and give this process's plain
    run (metrics within 1e-6 relative: another thread count); the ranks'
    run all-reduces its gradients and lies within 1e-5 of rank 0's run
    alone (metrics; gradients and BN statistics per leaf; the arch tables
    equal); the runs one ulp away report their gaps."""
    _, batch_stack, val_batch = engine_start
    argv = tuple(ENGINE_ARGV + ["--run.seed=3"])      # nets built afresh
    steps = [(batch_stack, val_batch, None)]
    rec = pool.run(harness.alone_and_on_ranks, argv, "end2end_jsrt", "cpu",
                   steps)
    plain = harness.engine_iterations(argv, "end2end_jsrt", "cpu", None,
                                      steps)
    one, two = rec["one"], rec["runs"][0]
    assert (one["world"], two["world"]) == (1, 2)
    assert one["grad_allreduce"]["calls"] == 0 < two["grad_allreduce"][
        "calls"]
    for k, v in plain["metrics"][0].items():
        assert abs(one["metrics"][0][k] - v) <= 1e-6 * abs(v), k
        assert abs(two["metrics"][0][k] - v) <= 1e-5 * abs(v), k
    gap = two["gap"]
    assert gap["grads"] <= 1e-5 and gap["bn"] <= 1e-5, gap
    assert gap["arch"] == 0.0, gap
    assert [r["gap"]["params"] > 0 for r in rec["nudged"]] == [True, True]
    print(f"alone_and_on_ranks: the ranks' state gaps {gap}")


def _restepped(argv, preset, start, state: dict) -> dict:
    """Each problem's parameters after its optimizer's step from
    ``start`` on the gradients of ``state`` (a ``harness.nets_state``).
    An iteration from a fresh optimizer steps each problem once from
    ``start``'s parameters: the replay after the roll-back
    (``decay_only`` rolls back past the arch's decay step)."""
    engine = harness.build_engine(argv, preset, "cpu")
    engine.load_state_dict(start)
    out = {}
    for p in engine.problems:
        for k, q in p.module.named_parameters():
            q.grad = state["problems"][p.name]["grads"][k].clone()
        p.optimizer.step()
        out[p.name] = to_cpu(dict(p.module.named_parameters()))
    return out


def _hold_state(argv, preset, start, got: dict, want: dict) -> dict:
    """Two ranks' engine state ``got`` after one iteration from ``start``
    against one process's ``want``, per problem and relative per leaf
    (``harness.leaf_gap``): the averaged gradients of the step within
    1e-5; the parameters within 1e-5 of the step the problem's optimizer
    takes from ``start`` on those gradients (that step, from one
    process's gradients, gives one process's parameters); the BN
    statistics within 1e-5."""
    steps = {n: _restepped(argv, preset, start, s) for n, s in
             (("got", got), ("want", want))}
    gaps = {"grads": 0.0, "params": 0.0, "bn": 0.0}
    for name, prob in want["problems"].items():
        mine = got["problems"][name]
        bn = [k for k in prob["module"] if "running" in k]
        for k, gap in (
                ("grads", harness.leaf_gap(mine["grads"], prob["grads"])),
                ("params", harness.leaf_gap(mine["module"],
                                            steps["got"][name], floor=0.0)),
                ("bn", harness.leaf_gap({k: mine["module"][k] for k in bn},
                                        {k: prob["module"][k] for k in bn},
                                        floor=0.0))):
            assert gap <= 1e-5, (name, k, gap)
            gaps[k] = max(gaps[k], gap)
        assert harness.leaf_gap(prob["module"], steps["want"][name],
                                floor=0.0) <= 1e-6, name
    return gaps


# -- the three trainers at data_axis=2 ---------------------------------------

def _trainer_cfg(tmp_path, name: str, data_axis: int, *extra):
    """``tests/test_parallel.py``'s ``_dp_cfg`` (global batch 8 of 32² at
    width 8, validation every 2 steps) on the CPU."""
    return parse_config([
        "--data.synthetic=true", "--data.image_size=32", "--data.n_train=8",
        "--data.n_val=8", "--data.n_test=0", "--data.batch_size=8",
        "--model.compute_dtype=float32", "--model.netG=unet_32",
        "--model.ngf=8", "--model.ndf=8", "--model.base_features=8",
        "--engine.valid_step=2", "--run.device=cpu",
        f"--run.save_dir={tmp_path}", f"--run.name={name}",
        f"--run.data_axis={data_axis}", *extra])


def _close(a: float, b: float, what) -> float:
    gap = abs(a - b) / max(abs(b), 1e-12)
    assert gap <= 1e-4 or a == b, (what, a, b)
    return gap


def test_train_end2end_dp_matches_single(tmp_path, pool):
    """The chunked flagship trainer (its preset, ``decay_only``) at
    data_axis=2 (on the pool's two ranks) against data_axis=1: every
    chunk's losses and validation Dice, and best_val, within 1e-4 relative
    (``tests/test_parallel.py:71-78``, which runs the config's default
    ``darts``: its term carries the inner steps' rounding, which
    ``test_dp_engine_step_matches_one_process`` bounds); rank 0 alone wrote
    the metric stream."""
    from semantic_segmentation_torch.train import train_end2end
    jsrt = "--engine.hypergrad=decay_only"
    _, res1 = train_end2end.train(_trainer_cfg(tmp_path, "dp1", 1, jsrt),
                                  train_iters=4)
    res2 = pool.run(harness.run_trainer, "train_end2end",
                    _trainer_cfg(tmp_path, "dp2", 2, jsrt), 4)
    assert [c["it"] for c in res2["chunks"]] == [2, 4]
    gap = _close(res2["best_val"], res1["best_val"], "best_val")
    for c1, c2 in zip(res1["chunks"], res2["chunks"]):
        for k, v in c1.items():
            if k != "seconds":
                gap = max(gap, _close(c2[k], v, (c1["it"], k)))
    lines = (tmp_path / "dp2" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len((tmp_path / "dp1" / "metrics.jsonl")
                             .read_text().splitlines())
    print(f"train_end2end, data_axis 2 against 1: largest gap {gap:.3e}")


def test_train_unet_spawns_its_ranks(tmp_path):
    """train_unet at data_axis=2 in one process starts its two ranks itself
    (``parallel/launch.run_ranks``) and returns rank 0's net: the losses
    and validation Dice of every record within 1e-4 relative of
    data_axis=1 (``tests/test_parallel.py:81-87``), the nets' weights
    within 20 lr."""
    from semantic_segmentation_torch.train import train_unet
    seg1, res1 = train_unet.train(_trainer_cfg(tmp_path, "u1", 1),
                                  train_iters=4)
    seg2, res2 = train_unet.train(_trainer_cfg(tmp_path, "u2", 2),
                                  train_iters=4)
    gap = _close(res2["best_val"], res1["best_val"], "best_val")
    assert [r["step"] for r in res2["log"]] == [2, 4]
    for r1, r2 in zip(res1["log"], res2["log"]):
        for k in ("loss", "val_score", "best_val", "lr"):
            gap = max(gap, _close(r2[k], r1[k], (r1["step"], k)))
    w1, w2 = seg1.net.state_dict(), seg2.net.state_dict()
    lr = _trainer_cfg(tmp_path, "u", 1).optim.unet_lr
    assert max((w2[k] - v).abs().max().item() for k, v in w1.items()
               if "running" not in k) <= 20 * lr
    print(f"train_unet, data_axis 2 against 1: largest gap {gap:.3e}")


def test_train_bbdm_spawns_its_ranks(tmp_path):
    """train_bbdm (the reference's DDP program) at data_axis=2 in one
    process, a small denoiser passed in (each rank gets a copy): its
    validation loss and the final model's validation loss on the
    validation split within 1e-4 relative of data_axis=1
    (``tests/test_parallel.py:225-245``)."""
    from semantic_segmentation_torch.models.diffusion.bbdm import \
        BridgeSchedule
    from semantic_segmentation_torch.train.common import (fold_generator,
                                                          load_splits)
    from semantic_segmentation_torch.train.train_bbdm import (BBDMModel,
                                                              to_device,
                                                              train)

    def run(name, axis):
        cfg = _trainer_cfg(tmp_path, name, axis, "--engine.valid_step=4")
        model = BBDMModel(channels=1, model_channels=8, channel_mult=(1, 2),
                          num_res_blocks=1, compute_dtype="float32",
                          generator=torch.Generator().manual_seed(0),
                          schedule=BridgeSchedule(num_timesteps=20,
                                                  sample_step=5))
        return train(cfg, 4, model), cfg

    (m1, r1), cfg = run("b1", 1)
    (m2, r2), _ = run("b2", 2)
    gap = _close(r2["best_val"], r1["best_val"], "best_val")
    gap = max(gap, _close(r2["log"][-1]["loss"], r1["log"][-1]["loss"],
                          "loss"))
    data = to_device(load_splits(cfg)["val"], "cpu")
    l1, l2 = (float(m.val_loss(data, generator=fold_generator(5, 0, "cpu")))
              for m in (m1, m2))
    gap = max(gap, _close(l2, l1, "val_loss"))
    print(f"train_bbdm, data_axis 2 against 1: largest gap {gap:.3e}")
