"""The port's stage-1 Pix2Pix against the JAX package's, at smoke width
(unet_32 and unet_64, ngf = ndf = 8 or 4, f32) from bridged weights:

- five ``train_step``s with dropout off: ``loss_D``/``loss_G`` per step
  within rtol 2e-4 (as ``tests/test_program_parity.py``), G/D parameters and
  BN running stats after the five steps within 1e-4 of each tensor's
  largest magnitude (but for the Adam sign-noise elements ``_gaps``
  describes: at most two in G, each within 2 lr), then ``generate`` within
  1e-5;
- (with dropout on: ``tests/test_torch_pix2pix_dropout.py``);
- one ``architect_step``: arch tables within 1e-6, no BN buffer changed;
- ``lr_schedule`` and ``batch_iterator`` identical;
- the checkpoint: ``save_model`` -> ``load_model`` reproduces ``generate``
  exactly, and a CPU ``train()``'s checkpoint is what ``train_end2end``
  starts from with ``--run.pretrained_pix2pix``.

The largest gaps are printed (``-s``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.core.optim import lr_schedule as jlr_schedule
from semantic_segmentation_tpu.data.pipeline import \
    batch_iterator as jbatch_iterator
from semantic_segmentation_tpu.models.pix2pix.model import Pix2Pix as JPix2Pix
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.core.optim import (get_learning_rate,
                                                    lr_schedule)
from semantic_segmentation_torch.data.pipeline import batch_iterator
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.train import train_end2end, train_pix2pix
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)

LR, ARCH_LR = 2e-5, 1e-4


def _models(netG="unet_32", nf=8, size=32, dropout=False, seed=0):
    """A JAX Pix2Pix with its initial state, and the port's on the same
    weights, BN stats and arch tables."""
    jm = JPix2Pix(input_nc=1, output_nc=1, ngf=nf, ndf=nf, netG=netG,
                  use_dropout=dropout, lr=LR, arch_lr=ARCH_LR,
                  compute_dtype=jnp.float32)
    state = jm.init(jax.random.key(seed), image_size=size)
    tm = Pix2Pix(1, 1, nf, nf, netG, use_dropout=dropout, lr=LR,
                 arch_lr=ARCH_LR)
    load_flax(tm.G, jax.device_get(state.g_params),
              jax.device_get(state.g_stats))
    load_flax(tm.D, jax.device_get(state.d_params),
              jax.device_get(state.d_stats))
    with torch.no_grad():
        for k, v in tm.arch.items():
            v.copy_(torch.from_numpy(np.array(state.arch[k])))
    return jm, state, tm


def jax_state(jm, tm):
    """The JAX ``Pix2PixState`` of the port's ``tm`` (weights, BN
    statistics, arch tables; fresh optimizers): flax's eager init of the
    two nets takes some 10 s, and the port draws from the same laws."""
    from semantic_segmentation_tpu.models.pix2pix.model import Pix2PixState
    (gp, gs), (dp, ds) = (jax.tree.map(jnp.asarray, state_dict_to_flax(
        net, net.state_dict())) for net in (tm.G, tm.D))
    arch = {k: jnp.asarray(v.numpy()) for k, v in tm.arch.items()}
    return Pix2PixState(g_params=gp, g_stats=gs, d_params=dp, d_stats=ds,
                        arch=arch, opt_g=jm.tx_g.init(gp),
                        opt_d=jm.tx_d.init(dp),
                        opt_arch=jm.tx_arch.init(arch),
                        step=jnp.zeros((), jnp.int32))


def _batches(n, size=32, seed=1):
    rng = np.random.default_rng(seed)
    return [{"mask_pix2pix": (rng.random((2, size, size, 1)) > 0.6)
             .astype(np.float32),
             "image_pix2pix": rng.random((2, size, size, 1))
             .astype(np.float32)} for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _gaps(port: dict, ref: dict, lr: float = 0.0):
    """(largest |port - ref| over each leaf's max |ref|, leaving out the
    elements beyond 1e-4 of it; the count of those). An element whose
    gradient is near 0 takes a first Adam step of about lr times a sign that
    rounding decides, so the two packages may end up to 2 lr apart there
    (``tests/test_program_parity.py:320-328``); any element beyond 1e-4 must
    be within that."""
    fp = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    fr = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(ref))[0])
    assert fp.keys() == fr.keys()
    worst, noisy = 0.0, 0
    for k, r in fr.items():
        r = np.asarray(r)
        err = np.abs(np.asarray(fp[k]) - r)
        scale = max(float(np.max(np.abs(r))), 1e-12)
        out = err > 1e-4 * scale
        assert (err[out] <= 2 * lr).all(), (jax.tree_util.keystr(k),
                                            err.max(), scale)
        noisy += int(out.sum())
        if (~out).any():
            worst = max(worst, float(err[~out].max()) / scale)
    return worst, noisy


def _compare_state(tm, state) -> dict:
    """Each tensor within 1e-4 of its largest magnitude, but for at most
    two Adam sign-noise elements in G's and one in D's parameters (none in
    the BN stats)."""
    gp, gs = state_dict_to_flax(tm.G, tm.G.state_dict())
    dp, ds = state_dict_to_flax(tm.D, tm.D.state_dict())
    gaps = {"G params": _gaps(gp, state.g_params, LR),
            "G BN stats": _gaps(gs, state.g_stats),
            "D params": _gaps(dp, state.d_params, LR),
            "D BN stats": _gaps(ds, state.d_stats)}
    for k, most in (("G params", 2), ("D params", 1), ("G BN stats", 0),
                    ("D BN stats", 0)):
        assert gaps[k][1] <= most, (k, gaps[k])
    return gaps


def _check_losses(mj, mt, step, gaps):
    for k, atol in (("loss_D", 2e-5), ("loss_G", 2e-3), ("loss_D_fake", 2e-5),
                    ("loss_D_real", 2e-5)):
        a, b = float(mt[k]), float(mj[k])
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=atol,
                                   err_msg=f"{k} at step {step}")
        gaps[k] = max(gaps.get(k, 0.0), abs(a - b) / abs(b))


def test_five_train_steps_match_jax():
    jm, state, tm = _models()
    loss_gaps = {}
    for i, b in enumerate(_batches(5)):
        state, mj = jm.train_step(state, b, jax.random.key(i + 10))
        mt = tm.train_step(_torch_batch(b))
        _check_losses(mj, mt, i, loss_gaps)
    gaps = _compare_state(tm, state)
    mask = _batches(1, seed=5)[0]["mask_pix2pix"]
    ref = np.asarray(jm.generate(state, jnp.asarray(mask)))
    out = tm.generate(torch.from_numpy(mask)).numpy()
    gaps["generate (abs)"] = float(np.max(np.abs(out - ref)))
    assert out.shape == ref.shape and gaps["generate (abs)"] <= 1e-5
    print("five train_steps: relative loss gaps",
          {k: f"{v:.2e}" for k, v in loss_gaps.items()},
          "| after five steps (gap, sign-noise elements)", gaps)


def test_architect_step_matches_jax_and_keeps_bn_stats():
    jm, state, tm = _models(seed=1)
    b = _batches(1, seed=2)[0]
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in (("G", tm.G), ("D", tm.D))}
    state2, mj = jm.architect_step(state, b, jax.random.key(7))
    mt = tm.architect_step(_torch_batch(b))
    np.testing.assert_allclose(float(mt["loss_arch"]), float(mj["loss_arch"]),
                               rtol=2e-4)
    worst = 0.0
    for k, v in tm.arch.items():
        ref = np.asarray(state2.arch[k])
        worst = max(worst, float(np.max(np.abs(v.numpy() - ref))))
        np.testing.assert_allclose(v.numpy(), ref, rtol=0, atol=1e-6)
        # the step moved both tables (weight decay moves the unread 'conv')
        assert not np.array_equal(ref, np.asarray(state.arch[k]))
    for n, m in (("G", tm.G), ("D", tm.D)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[n][k]), (n, k)
    print(f"architect_step: arch max |err| {worst:.2e}")


@pytest.mark.parametrize("policy", ["linear", "step", "cosine"])
def test_lr_schedule_matches_jax(policy):
    kw = dict(epoch_count=3, n_epochs_decay=40, lr_decay_iters=25)
    ours = lr_schedule(policy, 2e-5, 100, **kw)
    ref = jlr_schedule(policy, 2e-5, 100, **kw)
    epochs = list(range(0, 300, 7)) + [97, 98, 139, 140, 141, 500]
    assert [ours(e) for e in epochs] == [ref(e) for e in epochs]
    if policy == "linear":           # clamped at 0 past the horizon
        assert ours(500) == 0.0 and ours(50) == 2e-5
    with pytest.raises(NotImplementedError):
        lr_schedule("plateau", 2e-5, 100)


@pytest.mark.parametrize("n,batch_size", [(7, 2), (80, 2), (9, 4)])
def test_batch_iterator_matches_jax(n, batch_size):
    data = {"i": np.arange(n), "x": np.arange(n)[:, None] * 10}
    for epoch in range(3):
        ours = list(batch_iterator(data, batch_size,
                                   np.random.default_rng((0, epoch))))
        ref = list(jbatch_iterator(data, batch_size,
                                   np.random.default_rng((0, epoch))))
        assert len(ours) == len(ref) == n // batch_size
        for a, b in zip(ours, ref):
            for k in data:
                np.testing.assert_array_equal(a[k], b[k])


def test_save_load_round_trip_reproduces_generate(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tm = Pix2Pix(1, 1, 8, 8, "unet_32", lr=LR, generator=gen)
    tm.train_step(_torch_batch(_batches(1)[0]), generator=gen)
    train_pix2pix.save_model(tm, str(tmp_path))
    other = Pix2Pix(1, 1, 8, 8, "unet_32", lr=LR,
                    generator=torch.Generator().manual_seed(1))
    mask = torch.from_numpy(_batches(1, seed=3)[0]["mask_pix2pix"])
    assert not torch.equal(other.generate(mask), tm.generate(mask))
    train_pix2pix.load_model(other, str(tmp_path))
    assert torch.equal(other.generate(mask), tm.generate(mask))
    for k, v in tm.arch.items():
        assert torch.equal(other.arch[k], v)


SMALL = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=4",
         "--data.n_val=2", "--model.compute_dtype=float32",
         "--model.netG=unet_32", "--model.ngf=8", "--model.ndf=8"]


def test_cpu_train_checkpoint_starts_train_end2end(tmp_path):
    cfg = parse_config(SMALL + [f"--run.save_dir={tmp_path}",
                                "--run.log_every=1",
                                "--optim.lr_policy=cosine",
                                "--optim.n_epochs=4"],
                       preset="pix2pix_jsrt")
    assert (cfg.optim.lr, cfg.data.n_test, cfg.run.name) == (
        2e-5, 0, "pix2pix-JSRT")
    model, results = train_pix2pix.train(cfg, train_iters=5, device="cpu")
    # 2 batches per epoch: steps 1-2 in epoch 0, 3-4 in 1, 5 in 2
    assert results["steps"] == 5 and results["epochs"] == 3
    assert [r["step"] for r in results["log"]] == [1, 2, 3, 4, 5]
    for r in results["log"]:
        for k in ("loss_G", "loss_D", "loss_D_fake", "loss_D_real"):
            assert np.isfinite(r[k]), r
    sched = lr_schedule("cosine", 2e-5, 4)
    assert get_learning_rate(model.opt_g) == sched(3)
    assert get_learning_rate(model.opt_d) == sched(3)
    ckpt = os.path.join(tmp_path, cfg.run.name)
    assert sorted(os.listdir(ckpt)) == ["metrics.jsonl",
                                        train_pix2pix.DISCRIMINATOR_FILE,
                                        train_pix2pix.GENERATOR_FILE,
                                        "samples"]
    # a sample grid every log_every steps (the JAX trainer's)
    assert sorted(os.listdir(os.path.join(ckpt, "samples"))) == [
        f"step{i}.png" for i in range(1, 6)]
    # the metric stream: one record per log_every steps, the losses
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        stream = [json.loads(line) for line in f]
    assert [r["step"] for r in stream] == [1, 2, 3, 4, 5]
    for r, rec in zip(stream, results["log"]):
        assert r["loss_G"] == rec["loss_G"] and r["loss_D"] == rec["loss_D"]

    e2e = parse_config(SMALL + ["--data.n_test=2", "--model.base_features=8",
                                f"--run.save_dir={tmp_path}",
                                f"--run.pretrained_pix2pix={ckpt}"],
                       preset="end2end_jsrt")
    _, p2p, _ = train_end2end.build_engine(e2e, "cpu")
    for net, saved in ((p2p.G, model.G), (p2p.D, model.D)):
        for k, v in saved.state_dict().items():
            assert torch.equal(net.state_dict()[k], v), k
    for k, v in model.arch.items():
        assert torch.equal(p2p.arch[k], v)
    # and without the option the engine starts from fresh weights
    e2e.run.pretrained_pix2pix = ""
    _, fresh, _ = train_end2end.build_engine(e2e, "cpu")
    assert not torch.equal(fresh.G.down0.weight, model.G.down0.weight)


def test_entry_point_without_device_raises_when_cuda_absent(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_pix2pix.main(SMALL + [f"--run.save_dir={tmp_path}"])
