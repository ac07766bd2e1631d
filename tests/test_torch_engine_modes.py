"""The port's ``darts`` and ``unroll`` engine iterations on the real nets
against the JAX package's ``BilevelEngine``, at 32px, unet_32, ngf = ndf =
8, U-Net base 8, f32, from bridged weights and the same index streams:

- (a) ``darts`` with ``arch_children=netG,unet``, ``detach_fakes=false`` and
  the ``minmax`` post-process: the unet child's finite difference is live,
  the netG child's is the structural zero;
- (b) ``end2end_nas``'s ``unroll`` (run from ``tests/test_torch_hypergrad.py``,
  so that the two cases' JAX compiles run on two test workers).

Three iterations each, every one from the JAX engine's state before it: the
port's weights, BN statistics, arch tables and the four optimizers' state
are set from it first. Run free, the two trajectories part in a few
elements from the first step on: RMSprop turns the near-zero gradients of
the U-Net BN biases that a following BN cancels into steps of about
10 lr whose sign is f32 noise, and the arch gradient, a difference of
near-equal terms of the three up-conv candidates, moves by 0.4% at the
second iteration under that noise (the losses and the arch tables stay
within their tolerances). The augment affines of every ``loss_unet`` call are
the JAX engine's, re-derived from its key chain per phase: the pre-arch
unroll (``rng_u``), the hypergradient (``rng_h``: the darts finite
difference reads it whole, the unroll surrogate as the unroll does) and
the replay (``rng_r``) (bilevel.py:249, :181-195, :225-233). No dropout
layer is live in a unet_32 generator. Losses, ``outer_loss`` and
``arch_grad_norm`` within rtol 1e-3, the arch tables within 1e-5; the
largest gaps are printed. The JAX engine and its initial state are built
once for the file.

The first iteration also runs data-parallel on two gloo ranks (one row of
the global batch each, the same state and draws, ``parallel/harness.py``)
and tensor-parallel on them (``tp_engine_step`` on the mesh (data 1,
model 2): the whole batch on each, every covered layer's channels split),
and each is held to the JAX engine's metrics the same way (the darts term
at the JAX engine's unrolled state), and to the port's single process
within 1e-4 relative (``arch_grad_norm`` 1e-3; ``darts``' is held as a
term), the tensor-parallel step's gradients within 1e-5 per leaf;
``tests/test_torch_parallel.py`` holds the data-parallel ranks to one
process in every mode, ``tests/test_torch_tensor_parallel.py`` a (2, 2)
mesh.

Also: ``decay_only`` and ``darts`` give bit-identical arch tables and U-Net
weights in the port under the reference wiring, and the config's
comma-split tuples and ``end2end_nas`` preset match the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.ops.augment import sample_affine_batch
from semantic_segmentation_tpu.train.common import load_splits as jload_splits
from semantic_segmentation_tpu.train.train_end2end import (
    build_engine as jbuild_engine, build_engine_and_state, init_engine_state)
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.parallel.data_parallel import to_cpu
from semantic_segmentation_torch.train.common import load_splits
from semantic_segmentation_torch.train.train_end2end import (PROBLEMS,
                                                             build_engine)
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax)

ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=4",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.netG=unet_32", "--model.ngf=8", "--model.ndf=8",
        "--model.base_features=8"]
CASES = {
    "darts_live": (["--engine.hypergrad=darts",
                    "--engine.arch_children=netG,unet",
                    "--engine.detach_fakes=false",
                    "--engine.fake_postprocess=minmax",
                    "--engine.darts_epsilon=0.1"], "end2end_jsrt"),
    "unroll_nas": ([], "end2end_nas"),
}
ITERS = 3


def _unet_affines(root, step: int, phase: str, batch: int, size: int):
    """The matrices ``loss_unet`` samples at engine step ``step`` (K = 1,
    problem index 2) in ``phase``: 'unroll', 'replay', 'hyper' (the unroll
    surrogate's) or 'darts' (the finite difference's, ``rng_h`` whole)."""
    rng = jax.random.fold_in(root, jnp.int32(step))
    rng_u, rng_h, rng_r = jax.random.split(rng, 3)
    if phase == "darts":
        rng_p = rng_h
    else:
        base = {"unroll": rng_u, "hyper": rng_h, "replay": rng_r}[phase]
        rng_p = jax.random.fold_in(jax.random.split(base, 1)[0], 2)
    rng_aug = jax.random.split(rng_p, 3)[0]
    return torch.from_numpy(np.array(sample_affine_batch(rng_aug, batch, size,
                                                         size)))


def jit_build_engine_and_state(jcfg, key):
    """The JAX package's ``build_engine_and_state`` with its init jitted:
    flax's eager init of the nets compiles hundreds of small programs, a
    minute or more on the CPU (the ISIC224 case's 72 s of 190). The jitted
    init rounds apart from the eager one; the cases of this file keep the
    eager start, since the live darts case's arch gradient moves by 1.2e-3
    relative with it (the finite difference's conditioning, ROADMAP.md
    section 3)."""
    engine, p2p, seg = jbuild_engine(jcfg)
    state = jax.jit(lambda k: init_engine_state(jcfg, engine, p2p, seg,
                                                k))(key)
    return engine, state, p2p, seg


@pytest.fixture(scope="module")
def jax_start():
    """The JAX initial state (one build for the file) and the splits."""
    jcfg = jparse(ARGV, preset="end2end_jsrt")
    _, state, _, _ = build_engine_and_state(jcfg, jax.random.key(0))
    jsplits = jload_splits(jcfg)
    return jax.device_get(state), jsplits


def _set_optimizer_state(opt, params, moments: dict, count: int):
    """``opt``'s per-parameter state from the JAX package's moment trees
    ({torch state key: {parameter name: array}}) after ``count`` steps."""
    opt.state.clear()
    if count == 0:
        return
    for name, p in params.items():
        st = {k: torch.from_numpy(np.array(m[name])) for k, m in
              moments.items()}
        st["step"] = torch.tensor(float(count))
        opt.state[p] = st


def _sync_port(engine, state):
    """The port's engine state from the JAX ``EngineState`` (numpy)."""
    for p in engine.problems:
        load_flax(p.module, state.params[p.name], state.stats[p.name])
        o = state.opts[p.name]
        if p.name == "unet":           # add_decayed_weights, rms, trace, lr
            trees = {"square_avg": o[1].nu, "momentum_buffer": o[2].trace}
            count = int(o[3].count)
        else:                          # adam, lr
            adam = o[0].inner_state
            trees = {"exp_avg": adam.mu, "exp_avg_sq": adam.nu}
            count = int(adam.count)
        moments = {k: flax_to_state_dict(p.module, t)
                   for k, t in trees.items()}
        _set_optimizer_state(p.optimizer, dict(p.module.named_parameters()),
                             moments, count)
    with torch.no_grad():
        for k, v in engine.arch.items():
            v.copy_(torch.from_numpy(np.array(state.arch[k])))
    adam = state.opt_arch[1].inner_state         # add_decayed_weights first
    _set_optimizer_state(engine.arch_optimizer, engine.arch,
                         {"exp_avg": adam.mu, "exp_avg_sq": adam.nu},
                         int(adam.count))


@pytest.fixture(scope="module")
def rank_pool(tmp_path_factory):
    """Two gloo ranks for the data-parallel first iteration."""
    from semantic_segmentation_torch.parallel.launch import RankPool
    with RankPool(2, "cpu", timeout=120.0, threads=1,
                  workdir=str(tmp_path_factory.mktemp("pool"))) as pool:
        yield pool


def fake_levels_moved(got: list, want: list) -> float:
    """The share of the elements of the batches the unet took (``got``
    against ``want``, in the same order) that differ by more than float
    rounding (half a uint8 level), after checking that each such element
    is on both sides a level of the uint8 chain's output (k / 255)."""
    n = moved = 0
    for a, b in zip(got, want, strict=True):
        diff = (a - b).abs() > 0.5 / 255.0
        if diff.any():
            levels = torch.stack([a[diff], b[diff]]).double() * 255.0
            assert (levels - levels.round()).abs().max() <= 1e-3, \
                "a differing element is not a uint8 level"
        n += a.numel()
        moved += int(diff.sum())
    return moved / n


def dp_first_iteration(pool, argv, preset, start, step, mj, single,
                       darts_state=None):
    """The iteration ``step`` ((batches, val_batch, draws), global) on the
    two ranks of ``pool`` from the port's ``start``, data-parallel and then
    tensor-parallel (``tp_engine_step`` on the mesh (data 1, model 2)),
    against the JAX engine's metrics ``mj`` (rtol 1e-3) and the port's
    single-process ones ``single`` (1e-4; ``arch_grad_norm`` 1e-3; with
    ``darts_state``, the port state at the JAX engine's unrolled state, the
    darts term there stands for ``arch_grad_norm``, as in the
    single-process check); under tensor parallelism also the last step's
    gradients against one process's, run alone on rank 0
    (``harness.engine_iterations_alone``), within 1e-5 per leaf (the
    unet's where the batches it took agree; where they do not, under the
    uint8 chain, they may differ only in a few fake pixels by one uint8
    level: ``fake_levels_moved``). Returns the largest relative gaps."""
    from semantic_segmentation_torch.parallel import harness
    float_fakes = parse_config(list(argv), preset=preset) \
        .engine.fake_postprocess == "minmax"
    gaps = {"jax": 0.0, "single": 0.0, "tp_jax": 0.0, "tp_single": 0.0,
            "tp_grads": 0.0}
    for mesh, tag in ((None, ""), ((1, 2), "tp_")):
        got = pool.run(harness.engine_iterations, tuple(argv), preset, "cpu",
                       start, [step], mesh is not None, mesh=mesh,
                       record_inputs="unet")
        assert got["world"] == 2 and got["grad_allreduce"]["calls"] > 0
        if mesh is not None:
            assert got["tp"]["calls"] > 0, got["tp"]
        m = dict(got["metrics"][0])
        if darts_state is not None:
            hg = pool.run(harness.darts_term, tuple(argv), preset, "cpu",
                          darts_state, step, mesh)
            m["arch_grad_norm"] = float(torch.sqrt(sum(
                (v ** 2).sum() for v in hg.values())))
        for k in mj:
            ref, one = float(mj[k]), single[k]
            if ref == 0.0:                    # decay_only's arch_grad_norm
                assert m[k] == one == 0.0, k
                continue
            gap = abs(m[k] - ref) / abs(ref)
            assert gap < 1e-3, (tag or "dp", "two ranks against JAX", k,
                                m[k], ref)
            gap1 = abs(m[k] - one) / max(abs(one), 1e-12)
            assert gap1 <= (1e-3 if k == "arch_grad_norm" else 1e-4), (
                tag or "dp", "two ranks against one process", k, m[k], one)
            gaps[tag + "jax"] = max(gaps[tag + "jax"], gap)
            gaps[tag + "single"] = max(gaps[tag + "single"], gap1)
        if mesh is not None:
            # one process in the ranks' own setting (their thread count)
            one = pool.run(harness.engine_iterations_alone, tuple(argv),
                           preset, "cpu", start, [step],
                           record_inputs="unet")
            moved = fake_levels_moved(got["inputs"], one["inputs"])
            for name, prob in one["state"]["problems"].items():
                g = harness.leaf_gap(got["state"]["problems"][name]["grads"],
                                     prob["grads"])
                if name == "unet" and moved:
                    # under the uint8 chain a sharded conv's other order of
                    # sums can move a fake's uint8 level, and the unet's
                    # gradient with it: held where the unet's batches agree
                    assert not float_fakes and moved <= 1e-3, moved
                    gaps["tp_unet_grads_uint8"] = g
                    gaps["tp_fake_levels_moved"] = moved
                    continue
                assert g <= 1e-5, ("tp gradients", name, g)
                gaps["tp_grads"] = max(gaps["tp_grads"], g)
    return gaps


def three_iterations_against_jax(case: str, state0, jsplits, pool=None):
    """Three engine iterations of ``CASES[case]``, each from the JAX
    engine's state, against the JAX engine (module docstring); the first
    also on the two ranks of ``pool``."""
    extra, preset = CASES[case]
    jcfg = jparse(ARGV + extra, preset=preset)
    cfg = parse_config(ARGV + extra + ["--run.device=cpu"], preset=preset)
    mode = cfg.engine.hypergrad
    assert mode == jcfg.engine.hypergrad in ("darts", "unroll")
    engine_j, _, _ = jbuild_engine(jcfg)
    state = jax.tree.map(jnp.array, state0)       # the engine donates it
    train_j = device_put_split(jsplits["train"])
    val_j = device_put_split(jsplits["val"])

    engine, p2p, _ = build_engine(cfg, "cpu")
    splits = load_splits(cfg)
    train_t = to_device_split(splits["train"], "cpu")
    val_t = to_device_split(splits["val"], "cpu")
    bs = cfg.data.batch_size
    streams = {n: epoch_index_batches(4, bs, seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(2, bs, seed=cfg.run.seed + 99)
    root = jax.random.key(cfg.run.seed + 5)

    unroll_j = jax.jit(engine_j._unroll)
    gaps = {}
    for it in range(ITERS):
        idx = {n: next(s) for n, s in streams.items()}
        vidx = next(val_stream)
        _sync_port(engine, jax.device_get(state))
        if mode == "darts":
            # the JAX engine's unrolled state, where its darts term is taken
            rng_u = jax.random.split(jax.random.fold_in(root, jnp.int32(it)),
                                     3)[0]
            state_k, _ = unroll_j(
                state, state.arch,
                {n: jax.tree.map(lambda x: x[idx[n]][None], train_j)
                 for n in PROBLEMS}, rng_u)
            state_k = jax.device_get(state_k)
        state, mj = engine_j.engine_step_sampled(
            state, train_j, val_j, {n: idx[n][None] for n in PROBLEMS},
            vidx, jnp.int32(it), root, PROBLEMS)
        draws = {phase: [{"unet": {"affine": _unet_affines(
                    root, it, key, bs, 32)}}]
                 for phase, key in (("unroll", "unroll"),
                                    ("replay", "replay"),
                                    ("hyper", "darts" if mode == "darts"
                                     else "hyper"))}
        batches = [{n: take_batch(train_t, idx[n]) for n in PROBLEMS}]
        val_batch = take_batch(val_t, vidx)
        start = (to_cpu(engine.state_dict()) if pool is not None
                 and it == 0 else None)
        mt = engine.engine_step(batches, val_batch, draws)
        assert set(mt) == set(mj), (sorted(mt), sorted(mj))
        got = {k: float(v) for k, v in mt.items()}
        if mode == "darts":
            # the port's darts term at the same unrolled state: the real
            # unroll's RMSprop step moves the two states apart (docstring)
            assert np.isfinite(got["arch_grad_norm"]) and \
                got["arch_grad_norm"] > 0
            _sync_port(engine, state_k)
            hg, _ = engine._darts_hypergrad(batches, val_batch,
                                            draws["hyper"])
            got["arch_grad_norm"] = float(torch.sqrt(sum(
                (v ** 2).sum() for v in hg.values())))
        if start is not None:
            dp_gaps = dp_first_iteration(
                pool, ARGV + extra + ["--run.device=cpu"], preset, start,
                (batches, val_batch, draws), mj, got,
                to_cpu(engine.state_dict()) if mode == "darts" else None)
        assert float(mj["arch_grad_norm"]) > 0
        for k in mj:
            a, b = got[k], float(mj[k])
            assert np.isfinite(a), (it, k)
            gap = abs(a - b) / abs(b)
            gaps[k] = max(gaps.get(k, 0.0), gap)
            assert gap < 1e-3, (it, k, a, b)
        arch_gap = max(arch_gap if it else 0.0, max(
            np.abs(v.numpy() - np.asarray(state.arch[k])).max()
            for k, v in p2p.arch.items()))
        assert arch_gap < 1e-5, (it, arch_gap)
    print(f"{case}: largest relative gaps over {ITERS} iterations "
          f"{ {k: f'{v:.2e}' for k, v in sorted(gaps.items())} }, arch "
          f"max |err| {arch_gap:.2e}")
    if pool is not None:
        print(f"{case}, two ranks: largest relative metric gap to JAX "
              f"{dp_gaps['jax']:.2e}, to one process {dp_gaps['single']:.2e};"
              f" tensor-parallel (1, 2): to JAX {dp_gaps['tp_jax']:.2e}, to "
              f"one process {dp_gaps['tp_single']:.2e}, gradients per leaf "
              f"{dp_gaps['tp_grads']:.2e}; the unet's batches differ in "
              f"{dp_gaps.get('tp_fake_levels_moved', 0.0):.2e} of their "
              f"elements (fake uint8 levels), its gradient then "
              f"{dp_gaps.get('tp_unet_grads_uint8', 0.0):.2e} per leaf")
    assert engine.step == ITERS


def test_three_darts_iterations_match_jax(jax_start, rank_pool):
    three_iterations_against_jax("darts_live", *jax_start, pool=rank_pool)


def test_decay_only_and_darts_identical_under_reference_wiring():
    def run(mode):
        cfg = parse_config(ARGV + ["--run.device=cpu",
                                   f"--engine.hypergrad={mode}"],
                           preset="end2end_jsrt")
        engine, p2p, seg = build_engine(cfg, "cpu")
        splits = load_splits(cfg)
        train_t = to_device_split(splits["train"], "cpu")
        val_t = to_device_split(splits["val"], "cpu")
        streams = {n: epoch_index_batches(4, 2, seed=i)
                   for i, n in enumerate(PROBLEMS)}
        val_stream = epoch_index_batches(2, 2, seed=99)
        for _ in range(ITERS):
            m = engine.engine_step([{n: take_batch(train_t, next(s))
                                     for n, s in streams.items()}],
                                   take_batch(val_t, next(val_stream)))
        return p2p.arch, seg.net.state_dict(), m

    arch_d, unet_d, m_d = run("darts")
    arch_f, unet_f, m_f = run("decay_only")
    assert m_d["arch_grad_norm"].item() == 0.0           # the structural zero
    for k in arch_d:
        assert torch.equal(arch_d[k], arch_f[k]), k
    for k in unet_d:
        assert torch.equal(unet_d[k], unet_f[k]), k
    for n in PROBLEMS:
        assert torch.equal(m_d[f"replay_loss_{n}"], m_f[f"loss_{n}"])


@pytest.mark.parametrize("argv", [
    ["--engine.arch_children=netG,unet"], ["--engine.arch_children=unet,"],
    ["--engine.darts_epsilon=0.05"], ["--preset=end2end_nas"]])
def test_config_matches_jax(argv):
    cfg, jcfg = parse_config(argv), jparse(argv)
    for f in ("hypergrad", "darts_epsilon", "detach_fakes",
              "fake_postprocess", "arch_children"):
        assert getattr(cfg.engine, f) == getattr(jcfg.engine, f), f
    assert cfg.run.name == jcfg.run.name
    assert isinstance(cfg.engine.arch_children, tuple)
