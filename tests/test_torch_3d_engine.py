"""Three ``end2end_3d`` engine iterations of the port against the JAX
engine from bridged state (the preset: instance norm, ``decay_only``, K = 1,
roll-back), at crop 32, nd 3, ngf = ndf = 4, UNet3D base 4, f32, batch 1,
on the synthetic volumes both packages draw alike, the batch indices from
the same streams (nd 3 has no dropout, so nothing is drawn):

- each iteration's losses within 1e-5 relative; ``loss_unet`` holds two
  argmax-Dice terms, which move in quanta: a voxel whose two logits lie
  within rounding of each other may take the other class in the other
  package (the U-Net's BN-fed biases differ by their noise steps, below),
  which moves a Dice by at most 3 / union. So ``loss_unet`` is held to 1e-5
  relative or to 6 / (the unet batch's mask voxels), two such flips;
- after the three iterations, every parameter of G and D within 1e-5 of
  its problem's largest magnitude, but for at most 1 in 10^4 elements
  within 6 lr (Adam's noise steps on near-zero gradients,
  ``_param_gaps``). The U-Net's parameters are held to the noise rule
  alone (each within 92 lr, RMSprop's three first steps of up to 10 lr each
  on momentum, either sign), the count of elements beyond 1e-5 printed: the
  JAX package's f32 U-Net gradients lie up to 4.9e-3 of a leaf's largest
  from its own float64 ones (``tests/test_torch_3d_nets.py``), and RMSprop's
  first step moves every element by 10 lr in the direction of its
  gradient's sign, so every sign that rounding decides moves. And for the
  biases whose gradient is 0 in exact
  arithmetic (a conv that an instance norm or a batch norm follows: the
  norm removes a per-channel constant). Their optimizers turn rounding
  noise into steps of about their learning rate (Adam) or ten times it
  (RMSprop's first steps, v = 0.01 g^2), whose signs rounding decides, so
  those are held to 12 steps' worth (3 iterations, replays included, and
  RMSprop's momentum);
- the arch table within 1e-6 (weight decay alone);
- under ``darts`` (the reference's mode) the hypergradient is exactly 0 in
  both packages, and the port's ``darts`` iteration equals its
  ``decay_only`` one bit for bit.

The largest gaps are printed (``-s``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.engine.bilevel import \
    BilevelEngine as JBilevelEngine
from semantic_segmentation_tpu.core.optim import adam_torch as jadam
from semantic_segmentation_tpu.train.train_end2end_3d import \
    GenSeg3D as JGenSeg3D
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train.train_end2end_3d import (
    build_engine, load_volume_splits)
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)

ND, CROP = 3, 32
ARGV = ["--preset=end2end_3d", "--data.synthetic=true", "--data.n_train=2",
        "--data.n_val=2", "--data.n_test=1", "--model.ngf=4",
        "--model.ndf=4", "--model.base_features=4",
        "--model.compute_dtype=float32"]
# the largest noise step difference, in learning rates, after 3 iterations:
# Adam's steps are at most lr; RMSprop's first three are 10, 7.1 and 5.8 lr
# on momentum 0.9, 46 lr in all, so two runs may part by 92 lr
NOISE = {"netG": 6, "netD": 6, "unet": 92}
# modules whose bias feeds a norm (a zero gradient in exact arithmetic)
NORMED = {"netG": ("down1", "up1", "up2"),
          "netD": ("conv1", "conv2", "conv3"),
          "unet": ("conv1", "conv2")}


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


_START = {}


def _jax_engine(mode):
    """The JAX engine of ``mode`` and a fresh copy of the start state (the
    engine donates it). The start state does not depend on the mode, so
    it is built once for the file: flax's eager init of the three nets
    takes 95 s a call on the CPU, and the file needs it three times. It
    stays eager: a jitted init rounds apart from it, and the three
    free-running iterations' ``loss_unet`` then parts from JAX's by
    1.6e-4 relative, beyond this file's bar."""
    jcfg = jparse(ARGV + [f"--engine.hypergrad={mode}"])
    model = JGenSeg3D(jcfg, num_downs=ND)
    problems, outer = model.build_problems()
    engine = JBilevelEngine(problems, outer,
                            jadam(jcfg.optim.arch_lr, 0.5,
                                  weight_decay=jcfg.optim.arch_weight_decay),
                            hypergrad=mode)
    if "state" not in _START:
        _START["state"] = jax.device_get(
            model.init_state(engine, jax.random.key(0), CROP))
    return engine, jax.tree.map(jnp.array, _START["state"])


def _port_engine(mode, state):
    cfg = parse_config(ARGV + [f"--engine.hypergrad={mode}",
                               "--run.device=cpu"])
    engine, model = build_engine(cfg, "cpu", num_downs=ND)
    for name, net in (("netG", model.G), ("netD", model.D),
                      ("unet", model.seg)):
        load_flax(net, jax.device_get(state.params[name]),
                  jax.device_get(state.stats[name]))
    with torch.no_grad():
        model.arch["conv"].copy_(torch.from_numpy(
            np.array(state.arch["conv"])))
    return engine, model


def _batches(n_iters):
    cfg = parse_config(ARGV)
    splits = load_volume_splits(cfg, CROP)
    streams = [epoch_index_batches(2, 1, seed=i) for i in range(3)]
    val = epoch_index_batches(2, 1, seed=99)
    out = []
    for _ in range(n_iters):
        idx = {n: next(s) for n, s in zip(("netG", "netD", "unet"), streams)}
        out.append((idx, next(val)))
    return splits, out


def _run(mode, n_iters):
    """(JAX state, JAX metrics, port engine, port model, port metrics)."""
    jengine, state = _jax_engine(mode)
    tengine, model = _port_engine(mode, state)
    splits, batches = _batches(n_iters)
    tr = {k: jnp.asarray(v) for k, v in splits["train"].items()}
    va = {k: jnp.asarray(v) for k, v in splits["val"].items()}
    tr_t = to_device_split(splits["train"], "cpu")
    va_t = to_device_split(splits["val"], "cpu")
    jm, tm = [], []
    for i, (idx, vidx) in enumerate(batches):
        stack = {n: jax.tree.map(lambda x: x[ix][None], tr)
                 for n, ix in idx.items()}
        state, m = jengine.engine_step(state, stack,
                                       jax.tree.map(lambda x: x[vidx], va),
                                       jax.random.key(100 + i))
        jm.append(jax.device_get(m))
        tm.append({k: float(v) for k, v in tengine.engine_step(
            [{n: take_batch(tr_t, ix) for n, ix in idx.items()}],
            take_batch(va_t, vidx)).items()})
    return state, jm, tengine, model, tm


def _param_gaps(model, state, lrs):
    """Per problem: the largest gap of the elements within 1e-5 of the
    problem's largest magnitude, over it; the count of the elements beyond
    (Adam or RMSprop noise: an element whose gradient is near 0 takes steps
    of up to its learning rate in a direction rounding decides, so each is
    held to 6 lr, two per iteration); the largest gap of the zero-gradient
    biases."""
    gaps = {}
    for name, net in (("netG", model.G), ("netD", model.D),
                      ("unet", model.seg)):
        port, _ = state_dict_to_flax(net, net.state_dict())
        fp = dict(jax.tree_util.tree_flatten_with_path(port)[0])
        fr = dict(jax.tree_util.tree_flatten_with_path(
            jax.device_get(state.params[name]))[0])
        assert fp.keys() == fr.keys()
        top = max(float(np.max(np.abs(r))) for r in fr.values())
        lr = lrs[name]
        worst = noisy = 0.0
        n_out = n_all = 0
        for k, r in fr.items():
            key = jax.tree_util.keystr(k)
            err = np.abs(np.asarray(fp[k]) - r)
            if any(f"['{m}']['bias" in key for m in NORMED[name]):
                assert err.max() <= 12 * lr * (10 if name == "unet" else 1),\
                    (name, key, err.max())
                noisy = max(noisy, float(err.max()))
                continue
            out = err > 1e-5 * top
            assert (err[out] <= NOISE[name] * lr).all(), (name, key,
                                                          err.max(), top)
            n_out, n_all = n_out + int(out.sum()), n_all + err.size
            if (~out).any():
                worst = max(worst, float(err[~out].max()) / top)
        if name != "unet":
            assert n_out <= 1e-4 * n_all, (name, n_out, n_all)
        gaps[name] = (f"{worst:.2e} of the largest",
                      f"{n_out} of {n_all} noise elements",
                      f"zero-gradient biases {noisy:.2e}")
    return gaps


def test_three_decay_only_iterations_match_jax():
    state, jm, tengine, model, tm = _run("decay_only", 3)
    splits, batches = _batches(3)
    worst = {}
    for i, (a, b) in enumerate(zip(tm, jm)):
        for k in ("loss_netG", "loss_netD", "loss_unet"):
            rel = abs(a[k] - float(b[k])) / abs(float(b[k]))
            quantum = 6.0 / splits["train"]["mask"][batches[i][0]["unet"]] \
                .sum() if k == "loss_unet" else 0.0
            assert rel <= 1e-5 or abs(a[k] - float(b[k])) <= quantum, \
                (i, k, a[k], float(b[k]))
            worst[k] = max(worst.get(k, 0.0), rel)
        assert a["arch_grad_norm"] == float(b["arch_grad_norm"]) == 0.0
    gaps = _param_gaps(model, state, {"netG": 2e-4, "netD": 2e-4,
                                      "unet": 1e-4})
    arch = np.max(np.abs(model.arch["conv"].numpy()
                         - np.asarray(state.arch["conv"])))
    assert arch <= 1e-6
    print("3D engine, decay_only: relative loss gaps",
          {k: f"{v:.2e}" for k, v in worst.items()}, "| parameters", gaps,
          f"| arch {arch:.2e}")


def test_darts_hypergradient_is_zero_in_both():
    state, jm, tengine, model, tm = _run("darts", 1)
    assert float(jm[0]["arch_grad_norm"]) == 0.0
    assert tm[0]["arch_grad_norm"] == 0.0
    # the port's darts iteration is its decay_only one, bit for bit
    dengine, dmodel = _port_engine("decay_only",
                                   _jax_engine("decay_only")[1])
    splits, batches = _batches(1)
    idx, vidx = batches[0]
    tr_t = to_device_split(splits["train"], "cpu")
    dengine.engine_step([{n: take_batch(tr_t, ix) for n, ix in idx.items()}],
                        take_batch(to_device_split(splits["val"], "cpu"),
                                   vidx))
    for a, b in ((model.G, dmodel.G), (model.D, dmodel.D),
                 (model.seg, dmodel.seg)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    assert torch.equal(model.arch["conv"], dmodel.arch["conv"])
