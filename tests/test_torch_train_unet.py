"""Three ``train_unet`` steps of the port against the JAX package's
``SegProblem.train_step`` (32^2, f32, U-Net width 8) from bridged weights on
the same ``batch_iterator`` batches. Run free, the losses agree within 1e-4
relative (measured: 3.4e-7, 2.6e-7, 1.1e-5): RMSprop turns the near-zero
gradients of BN biases that a following BN cancels into full steps of
10 lr with a noisy sign, so the two parameter trajectories part in those
elements from the first step. Each step started from the JAX state
(parameters, statistics, RMSprop moments), the losses agree within 1e-5
relative (measured: 3.4e-7, 8.8e-8, 0) and every parameter after the step within 2e-3 absolute, the
most that one RMSprop step with a flipped sign moves an element
(2 x 10 lr). Also: ``train`` runs on the CPU and writes its artifacts."""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.seg import SegProblem as JSegProblem
from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import batch_iterator
from semantic_segmentation_torch.train import train_unet
from semantic_segmentation_torch.train.common import (build_seg_problem,
                                                      load_splits)
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax)

ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=6",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.base_features=8", "--run.device=cpu"]


@pytest.fixture(scope="module")
def start():
    cfg = parse_config(ARGV)
    problem = JSegProblem("unet", 1, 1, lr=cfg.optim.unet_lr,
                          compute_dtype=jnp.float32, base_features=8,
                          bilinear=False)
    state = problem.init(jax.random.key(0), 32)
    batches = list(batch_iterator(load_splits(cfg)["train"], 2,
                                  np.random.default_rng((0, 0))))
    return cfg, problem, state, batches


def _port(cfg, state):
    seg = build_seg_problem(cfg, "cpu")
    load_flax(seg.net, *jax.device_get((state.params, state.stats)))
    return seg, seg.make_opt()


def _sync(seg, opt, state):
    """The port's net and RMSprop state from the JAX ``SegState``."""
    load_flax(seg.net, *jax.device_get((state.params, state.stats)))
    o = jax.device_get(state.opt)      # add_decayed_weights, rms, trace, lr
    moments = {k: flax_to_state_dict(seg.net, t) for k, t in
               (("square_avg", o[1].nu), ("momentum_buffer", o[2].trace))}
    opt.state.clear()
    for name, p in seg.net.named_parameters():
        opt.state[p] = {k: m[name].clone() for k, m in moments.items()}
        opt.state[p]["step"] = torch.tensor(float(o[3].count))


def test_free_running_losses_match_jax(start):
    cfg, problem, state, batches = start
    seg, opt = _port(cfg, state)
    for i, b in enumerate(batches):
        state, m = problem.train_step(state, b)
        got = float(train_unet.train_step(seg, opt, b,
                                          contextlib.nullcontext, "cpu"))
        ref = float(m["loss"])
        assert abs(got - ref) <= 1e-4 * abs(ref), (i, got, ref)


def test_each_step_from_jax_state_matches(start):
    cfg, problem, state, batches = start
    seg, opt = _port(cfg, state)
    for i, b in enumerate(batches):
        _sync(seg, opt, state)
        state, m = problem.train_step(state, b)
        got = float(train_unet.train_step(seg, opt, b,
                                          contextlib.nullcontext, "cpu"))
        ref = float(m["loss"])
        assert abs(got - ref) <= 1e-5 * abs(ref), (i, got, ref)
        want = flax_to_state_dict(seg.net, *jax.device_get(
            (state.params, state.stats)))
        for k, v in seg.net.state_dict().items():
            tol = 1e-5 if "running" in k else cfg.optim.unet_lr * 20
            err = (v - want[k]).abs().max().item()
            assert err <= tol, (i, k, err)


def test_train_writes_artifacts(tmp_path):
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                               "--run.name=unet", "--engine.valid_step=2"])
    kernels.reset_launches()
    seg, results = train_unet.train(cfg, train_iters=5)
    assert not any(kernels.LAUNCHES.values())
    assert [r["step"] for r in results["log"]] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in results["log"])
    assert 0.0 <= results["best_val"] <= 1.0
    assert 0.0 <= results["test_dice"] <= 1.0
    run = os.path.join(tmp_path, "unet")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r.get("step") for r in recs] == [2, 4, 5]
    assert "test_dice" in recs[-1]
    assert os.listdir(os.path.join(run, "ckpt"))
