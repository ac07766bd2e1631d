"""The port's three GenSeg-3D trainers on the CPU:

- two ``train_pix2pix_3d`` steps (D then G, batch norm so the statistics
  thread through both problems) against the JAX package's step
  (``train_pix2pix_3d.py:53-75``, restated here on its own problems) from
  bridged weights: losses within 1e-5 relative;
- three ``train_unet3d`` steps against the JAX package's step
  (``train_unet3d.py:42-52``): losses within 1e-5 relative;
- the three CLI entries (``main``) at 64^3 with narrow nets: the metric
  stream, the checkpoints and the generation CSV;
- an ``end2end_3d`` run resumed after 2 iterations and run to 4 equals 4
  uninterrupted iterations bit for bit (engine state, best U-Net, test
  Dice)."""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import optax
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.core.optim import rmsprop_torch as jrmsprop
from semantic_segmentation_tpu.engine.bilevel import EngineState
from semantic_segmentation_tpu.models.unet3d import UNet3D as JUNet3D
from semantic_segmentation_tpu.train.train_end2end_3d import (
    GenSeg3D as JGenSeg3D, seg3d_loss as jseg3d_loss)
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.core.optim import rmsprop_torch
from semantic_segmentation_torch.data.pipeline import batch_iterator
from semantic_segmentation_torch.train import (train_end2end_3d,
                                               train_pix2pix_3d,
                                               train_unet3d)
from semantic_segmentation_torch.train.train_end2end_3d import (
    GenSeg3D, load_volume_splits)
from semantic_segmentation_torch.utils.bridge import load_flax


@pytest.fixture(autouse=True)
def _native_cpu_conv3d():
    """torch's CPU conv3d through oneDNN returns a wrong weight gradient on
    one thread (torch 2.13.0+cpu, oneDNN 3.12, AVX-512: 1e29 off at k8,
    s2, p3, while eight threads or the native kernels agree with float64
    to 2e-7), and ``tests/test_torch_long_drift.py`` sets one thread at
    import in every test worker. The port's CPU path is held on torch's
    native conv kernels here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


ARGV = ["--data.synthetic=true", "--data.n_train=3", "--data.n_val=1",
        "--data.n_test=1", "--data.batch_size=1", "--model.ngf=4",
        "--model.ndf=4", "--model.base_features=4",
        "--model.compute_dtype=float32"]
CROP, ND = 32, 3


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _batches(n):
    cfg = parse_config(ARGV)
    splits = load_volume_splits(cfg, CROP)
    it = batch_iterator(splits["train"], 1, np.random.default_rng((0, 0)))
    return [next(it) for _ in range(n)]


def test_two_pix2pix_3d_steps_match_jax():
    jcfg = jparse(ARGV + ["--optim.lr=2e-4"])
    jm = JGenSeg3D(jcfg, num_downs=ND)
    problems, _ = jm.build_problems()
    loss_g, loss_d = problems[0].loss, problems[1].loss
    kg, kd, ka = jax.random.split(jax.random.key(0), 3)
    arch = {"conv": 0.3 * jax.random.normal(ka, (ND, 3))}
    a0 = jnp.zeros((1, CROP, CROP, CROP, 1))
    gv = jm.G.init({"params": kg}, a0, arch["conv"], train=False)
    dv = jm.D.init({"params": kd}, jnp.zeros((1, CROP, CROP, CROP, 2)),
                   train=False)
    state = EngineState(
        params={"netG": gv["params"], "netD": dv["params"]},
        stats={"netG": gv["batch_stats"], "netD": dv["batch_stats"]},
        opts={"netG": jm.tx_g.init(gv["params"]),
              "netD": jm.tx_d.init(dv["params"])},
        arch=arch, opt_arch=None, step=jnp.zeros((), jnp.int32))

    @jax.jit
    def jstep(state, batch, rng):
        # train_pix2pix_3d.py:53-75
        rd, rg = jax.random.split(rng)
        (ld, d_up), d_grads = jax.value_and_grad(loss_d, has_aux=True)(
            state.params["netD"], state, state.arch, batch, rd)
        du, od = jm.tx_d.update(d_grads, state.opts["netD"],
                                state.params["netD"])
        state = state.replace(
            params={**state.params,
                    "netD": optax.apply_updates(state.params["netD"], du)},
            opts={**state.opts, "netD": od}, stats={**state.stats, **d_up})
        (lg, g_up), g_grads = jax.value_and_grad(loss_g, has_aux=True)(
            state.params["netG"], state, state.arch, batch, rg)
        gu, og = jm.tx_g.update(g_grads, state.opts["netG"],
                                state.params["netG"])
        state = state.replace(
            params={**state.params,
                    "netG": optax.apply_updates(state.params["netG"], gu)},
            opts={**state.opts, "netG": og}, stats={**state.stats, **g_up})
        return state, {"loss_G": lg, "loss_D": ld}

    cfg = parse_config(ARGV + ["--optim.lr=2e-4", "--run.device=cpu"])
    tm = GenSeg3D(cfg, num_downs=ND)
    load_flax(tm.G, gv["params"], gv["batch_stats"])
    load_flax(tm.D, dv["params"], dv["batch_stats"])
    tm.arch["conv"].copy_(torch.from_numpy(np.array(arch["conv"])))
    tproblems, _ = tm.build_problems()
    gaps = {}
    for i, b in enumerate(_batches(2)):
        state, mj = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.key(i))
        mt = train_pix2pix_3d.train_step(
            tproblems, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss_G", "loss_D"):
            gaps[k] = max(gaps.get(k, 0.0), _rel(mt[k], mj[k]))
            assert gaps[k] <= 1e-5, (i, k, float(mt[k]), float(mj[k]))
    print("train_pix2pix_3d steps: relative loss gaps", gaps)


def test_three_unet3d_steps_match_jax():
    ju = JUNet3D(1, 2, (4, 8, 16), 32, dtype=jnp.float32)
    v = ju.init({"params": jax.random.key(0)},
                jnp.zeros((1, CROP, CROP, CROP, 1)), train=False)
    params, stats = v["params"], v["batch_stats"]
    tx = jrmsprop(1e-4)
    opt = tx.init(params)

    @jax.jit
    def jstep(params, stats, opt, batch):
        # train_unet3d.py:42-52
        def lf(p):
            logits, mut = ju.apply({"params": p, "batch_stats": stats},
                                   batch["B"], train=True,
                                   mutable=["batch_stats"])
            return jseg3d_loss(logits, batch["mask"][..., 0]), mut

        (loss, mut), grads = jax.value_and_grad(lf, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return (optax.apply_updates(params, updates), mut["batch_stats"],
                opt, loss)

    cfg = parse_config(ARGV)
    net = train_unet3d.build_unet3d(cfg, "cpu")
    load_flax(net, params, stats)
    optimizer = rmsprop_torch(net.parameters(), 1e-4)
    gaps = []
    for i, b in enumerate(_batches(3)):
        params, stats, opt, lj = jstep(params, stats, opt,
                                       {k: jnp.asarray(x)
                                        for k, x in b.items()})
        lt = train_unet3d.train_step(net, optimizer,
                                     {k: torch.from_numpy(x)
                                      for k, x in b.items()},
                                     contextlib.nullcontext)
        gaps.append(_rel(lt, lj))
        assert gaps[-1] <= 1e-5, (i, float(lt), float(lj))
    print("train_unet3d steps: relative loss gaps", gaps)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_entries_on_cpu(tmp_path):
    small = ["--data.synthetic=true", "--data.n_train=2", "--data.n_val=1",
             "--data.n_test=1", "--data.batch_size=1", "--model.ngf=2",
             "--model.ndf=2", "--model.base_features=2",
             "--model.compute_dtype=float32", "--run.device=cpu",
             f"--run.save_dir={tmp_path}"]
    train_end2end_3d.main(small + ["--preset=end2end_3d",
                                   "--engine.train_iters=2",
                                   "--engine.valid_step=1",
                                   "--run.name=e2e"])
    recs = _records(tmp_path / "e2e" / "metrics.jsonl")
    assert any("val_score" in r for r in recs)
    assert np.isfinite([r["test_dice"] for r in recs if "test_dice" in r])\
        .all()
    assert os.listdir(tmp_path / "e2e" / "ckpt") == ["2"]
    assert (tmp_path / "e2e" / "unet_best.pt").exists()

    train_pix2pix_3d.main(small + ["--engine.train_iters=2",
                                   "--run.log_every=1", "--run.name=p2p"])
    assert len(_records(tmp_path / "p2p" / "metrics.jsonl")) == 2
    g = torch.load(tmp_path / "p2p" / train_pix2pix_3d.GENERATOR_FILE,
                   weights_only=True)
    assert set(g) == {"G", "arch"}

    train_unet3d.main(small + ["--engine.train_iters=2",
                               "--engine.valid_step=1", "--run.name=u3d"])
    recs = _records(tmp_path / "u3d" / "metrics.jsonl")
    assert "test_dice" in recs[-1] and (tmp_path / "u3d" /
                                        train_unet3d.MODEL_FILE).exists()

    # the generation CSV of a trained G on the test split
    cfg = parse_config(small + ["--run.name=p2p"])
    model, _ = train_pix2pix_3d.train(cfg, train_iters=1, crop=CROP,
                                      num_downs=ND)
    csv = str(tmp_path / "gen.csv")
    rows = train_pix2pix_3d.evaluate_generation(
        model, load_volume_splits(cfg, CROP)["test"], 1, csv)
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
    assert open(csv).read().splitlines()[0] == \
        "volume,mae,mse,psnr,ssim"


@pytest.mark.parametrize("entry", ["parse_config", "train_unet3d"])
def test_spatial_axis_is_accepted(entry, tmp_path, monkeypatch):
    # the spatial-parallel mesh (parallel/spatial.py): the parser takes the
    # option, and train_unet3d at 0 (every visible device: two here) starts
    # its ranks on the CPU, one depth slab each
    if entry == "parse_config":
        assert parse_config(["--run.spatial_axis=2"]).run.spatial_axis == 2
        return
    from semantic_segmentation_torch.parallel import launch, mesh, spatial
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", 120.0)
    for mod in (mesh, spatial):
        monkeypatch.setattr(mod, "visible_devices", lambda device_type: 2)
    cfg = parse_config(ARGV + ["--run.device=cpu", "--engine.valid_step=1",
                               f"--run.save_dir={tmp_path}"])
    cfg.run.spatial_axis = 0
    net, res = train_unet3d.train(cfg, train_iters=1, crop=CROP)
    assert [r["step"] for r in res["log"]] == [1]
    assert np.isfinite(res["log"][0]["loss"]) and np.isfinite(
        res["test_dice"])
    assert isinstance(net, torch.nn.Module)


def test_end2end_3d_resume_is_bit_for_bit(tmp_path):
    argv = ARGV + ["--preset=end2end_3d", "--data.n_train=2",
                   "--engine.valid_step=1", "--run.device=cpu"]

    def run(name, iters, resume=False):
        cfg = parse_config(argv + [f"--run.save_dir={tmp_path}",
                                   f"--run.name={name}",
                                   f"--run.resume={resume}"])
        return train_end2end_3d.train(cfg, train_iters=iters, crop=CROP,
                                      num_downs=ND)

    eng_full, res_full = run("full", 4)
    run("cut", 2)
    eng_cut, res_cut = run("cut", 4, resume=True)
    assert eng_cut.step == eng_full.step == 4
    a, b = eng_full.state_dict(), eng_cut.state_dict()
    for name in a["problems"]:
        for k, v in a["problems"][name]["module"].items():
            assert torch.equal(v, b["problems"][name]["module"][k]), k
    assert torch.equal(a["arch"]["conv"], b["arch"]["conv"])
    assert res_full["test_dice"] == res_cut["test_dice"]
    assert res_full["best_val"] == res_cut["best_val"]
    full = torch.load(tmp_path / "full" / "unet_best.pt", weights_only=True)
    cut = torch.load(tmp_path / "cut" / "unet_best.pt", weights_only=True)
    assert all(torch.equal(v, cut[k]) for k, v in full.items())
