"""``optim.accumulate`` (``core/optim.Accumulate``) against the JAX
package's ``optax.MultiSteps``:

- four ``train_unet`` steps at ``accumulate=2`` (32^2, f32, U-Net width
  8), each from the JAX state (parameters, statistics, the RMSprop moments,
  the accumulator and its mini-step count): the losses within 1e-6
  relative; on the first and third steps the parameters and RMSprop's
  state do not move at all, and the accumulator (that step's gradient) is
  within 2e-3 of its largest magnitude (measured 1.0e-3: the two packages'
  U-Net gradients differ where a following BN cancels them); on the second
  and fourth every parameter lands within 2e-3 of the JAX one (the most
  one RMSprop step with a flipped sign moves an element, 2 x 10 lr; see
  ``tests/test_torch_train_unet.py``);
- the same gradients fed to ``Accumulate(RMSprop, 3)`` and to the JAX
  package's ``optax.MultiSteps(rmsprop_torch, 3)`` for seven steps: the
  parameters within 1e-6 (relative to 1) after each, so the mean, its
  emission on every third step and the held state are optax's;
- in the flagship's engine (``unet_32``, U-Net width 8, accumulate 2), a
  ``darts`` iteration, whose roll-back restores the accumulator, equals a
  ``decay_only`` one from the same state bit for bit, also mid-
  accumulation; and a run saved with ``CheckpointManager`` mid-
  accumulation and resumed into a fresh engine equals the uninterrupted
  one bit for bit."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import semantic_segmentation_torch.train.train_end2end as t_e2e
from semantic_segmentation_tpu.models.seg import SegProblem as JSegProblem
from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.core.optim import Accumulate
from semantic_segmentation_torch.data.pipeline import (batch_iterator,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train import train_unet
from tests.test_torch_train_unet import random_seg_state
from semantic_segmentation_torch.train.common import (build_seg_problem,
                                                      load_splits)
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax)

ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=8",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.base_features=8", "--optim.accumulate=2",
        "--run.device=cpu"]


def _sync(seg, opt: Accumulate, state):
    """The port's net and accumulating RMSprop from the JAX ``SegState``."""
    load_flax(seg.net, *jax.device_get((state.params, state.stats)))
    ms = jax.device_get(state.opt)
    o = ms.inner_opt_state           # add_decayed_weights, rms, trace, lr
    moments = {k: flax_to_state_dict(seg.net, t) for k, t in
               (("square_avg", o[1].nu), ("momentum_buffer", o[2].trace))}
    inner = opt.inner
    inner.state.clear()
    for name, p in seg.net.named_parameters():
        inner.state[p] = {k: m[name].clone() for k, m in moments.items()}
        inner.state[p]["step"] = torch.tensor(float(o[3].count))
    acc = flax_to_state_dict(seg.net, ms.acc_grads)
    with torch.no_grad():
        for (name, _), a in zip(seg.net.named_parameters(), opt.acc):
            a.copy_(acc[name])
    opt.mini_step = int(ms.mini_step)


def test_four_steps_match_optax_multisteps():
    cfg = parse_config(ARGV)
    problem = JSegProblem("unet", 1, 1, lr=cfg.optim.unet_lr,
                          compute_dtype=jnp.float32, accumulate=2,
                          base_features=8, bilinear=False)
    state = random_seg_state(problem, 32)
    batches = list(batch_iterator(load_splits(cfg)["train"], 2,
                                  np.random.default_rng((0, 0))))
    assert len(batches) == 4
    seg = build_seg_problem(cfg, "cpu")
    opt = seg.make_opt()
    assert isinstance(opt, Accumulate) and opt.every_k == 2
    for i, b in enumerate(batches):
        _sync(seg, opt, state)
        before = {k: v.clone() for k, v in seg.net.named_parameters()}
        inner_before = {id(p): {k: v.clone() for k, v in s.items()}
                        for p, s in opt.inner.state.items()}
        state, m = problem.train_step(state, b)
        got = float(train_unet.train_step(seg, opt, b,
                                          contextlib.nullcontext, "cpu"))
        ref = float(m["loss"])
        assert abs(got - ref) <= 1e-6 * abs(ref), (i, got, ref)
        ms = jax.device_get(state.opt)
        assert opt.mini_step == int(ms.mini_step) == (i + 1) % 2
        acc = flax_to_state_dict(seg.net, ms.acc_grads)
        scale = max(float(acc[n].abs().max()) for n in before)
        err = max(float((a - acc[n]).abs().max())
                  for n, a in zip(before, opt.acc))
        assert err <= 2e-3 * scale, (i, err, scale)
        want = flax_to_state_dict(seg.net, *jax.device_get(
            (state.params, state.stats)))
        for k, p in seg.net.named_parameters():
            if i % 2 == 0:      # a micro-step: nothing moves
                assert torch.equal(p, before[k]), (i, k)
                np.testing.assert_array_equal(p.detach().numpy(),
                                              want[k].numpy())
            else:
                err = float((p.detach() - want[k]).abs().max())
                assert err <= cfg.optim.unet_lr * 20, (i, k, err)
        if i % 2 == 0:
            for p, s in opt.inner.state.items():
                for k, v in s.items():
                    assert torch.equal(v, inner_before[id(p)][k]), (i, k)


def test_same_gradients_step_as_optax_multisteps():
    import optax

    from semantic_segmentation_tpu.core.optim import rmsprop_torch as jrms
    from semantic_segmentation_torch.core.optim import rmsprop_torch
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(7, 5, 4)).astype(np.float32)
    tx = optax.MultiSteps(jrms(1e-2), every_k_schedule=3)
    wj = jnp.asarray(w0)
    sj = tx.init(wj)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Accumulate(rmsprop_torch([w], 1e-2), 3)
    for i, g in enumerate(grads):
        upd, sj = tx.update(jnp.asarray(g), sj, wj)
        wj = optax.apply_updates(wj, upd)
        opt.zero_grad()
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(wj),
                                   rtol=0, atol=1e-6, err_msg=str(i))
        assert opt.mini_step == int(sj.mini_step) == (i + 1) % 3
        moved = not np.array_equal(np.asarray(wj), w0)
        assert moved == (i >= 2)


def _engine(mode):
    cfg = parse_config(ARGV + ["--model.netG=unet_32", "--model.ngf=8",
                               "--model.ndf=8", f"--engine.hypergrad={mode}"],
                       preset="end2end_jsrt")
    engine, _, _ = t_e2e.build_engine(cfg, "cpu")
    splits = load_splits(cfg)
    return (engine, to_device_split(splits["train"], "cpu"),
            to_device_split(splits["val"], "cpu"))


def _batches(train, it):
    return [{n: take_batch(train, [(it + i) % 8, (it + i + 3) % 8])
             for i, n in enumerate(t_e2e.PROBLEMS)}]


def _state(engine):
    return {p.name: {k: v.clone() for k, v in p.module.state_dict().items()}
            for p in engine.problems}


def _equal(a, b):
    for name in a:
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), (name, k)


def test_roll_back_and_resume_mid_accumulation(tmp_path):
    darts, train, val = _engine("darts")
    plain, _, _ = _engine("decay_only")
    unet = {e: e.problems[t_e2e.PROBLEMS.index("unet")].optimizer
            for e in (darts, plain)}
    for it in range(3):
        md = darts.engine_step(_batches(train, it), take_batch(val, [0, 1]))
        mp = plain.engine_step(_batches(train, it), None)
        for k in mp:           # darts' first losses precede the arch step
            if k.startswith("replay_"):
                assert float(md[k]) == float(mp[k]), (it, k)
        _equal(_state(darts), _state(plain))
        assert unet[darts].mini_step == unet[plain].mini_step == \
            (it + 1) % 2
        if it == 0:               # mid-accumulation: save, resume, go on
            mgr = CheckpointManager(str(tmp_path / "ckpt"))
            mgr.save(1, {"engine": plain.state_dict()}, force=True)
            mgr.wait()
            restored, _ = mgr.restore({"engine": None})
            resumed, _, _ = _engine("decay_only")
            resumed.load_state_dict(restored["engine"])
            assert unet[plain].mini_step == 1
    for it in (1, 2):
        resumed.engine_step(_batches(train, it), None)
    _equal(_state(resumed), _state(plain))
    acc = resumed.problems[t_e2e.PROBLEMS.index("unet")].optimizer.acc
    assert all(torch.equal(a, b) for a, b in zip(acc, unet[plain].acc))
