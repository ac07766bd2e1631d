"""The port's ``train_bbdm`` on the CPU:

- three ``BBDMModel.train_step``s against the JAX package's from bridged
  non-zero weights, f32, with the JAX draws (t, the noise) injected, at
  ``optim.accumulate`` 1 and 2 (``optax.MultiSteps`` there, ``Accumulate``
  here): each loss within 1e-5 relative; then every weight within 1e-5 of
  the net's largest but for Adam's noise steps (an element whose gradient
  is 0 in exact arithmetic, or within rounding of it, takes steps of up to
  lr in a direction rounding decides: held to 6 lr, at most 1% of the
  elements); the EMA, a copy at step 0 and untouched until step 8, the
  same;
- a run stopped mid-epoch and resumed (``run.resume``) equals the
  uninterrupted run bit for bit: weights, Adam, EMA, arch, the plateau and
  the validation losses;
- ``sample_eval`` (``run.sample_only``) from that run's latest checkpoint
  writes one grid per test batch and scores the JAX package's diversity of
  its samples; FID and LPIPS raise, naming ROADMAP item 12;
- both BBDM entry points raise without CUDA unless given
  ``--run.device=cpu``; on the card they ask for cuDNN's heuristic mode B
  unless the environment says, and warn where CUDA is already
  initialized.

The net is the small ADM denoiser at one level (model_channels 8, one res
block, mult (1,): 5 cells, the middle attention), 8^2, T = 20 with 5
sample steps, so that the JAX compiles stay short."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.diffusion.bbdm import \
    BridgeSchedule as JSchedule
from semantic_segmentation_tpu.ops.gen_metrics import \
    sample_diversity as jdiversity
from semantic_segmentation_tpu.train.train_bbdm import (BBDMModel as JModel,
                                                        BBDMState)
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.diffusion.bbdm import BridgeSchedule
from semantic_segmentation_torch.models.diffusion.ema import ema_init
from semantic_segmentation_torch.train import train_bbdm, train_end2end_bbdm
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)
from tests.test_torch_bbdm_bridge import jax_loss_draws
from tests.test_torch_bbdm_nets import nonzero

NET = dict(model_channels=8, channel_mult=(1,), num_res_blocks=1)
SCHED = dict(num_timesteps=20, sample_step=5)
SIZE, LR = 8, 1e-4


def port_model(accumulate: int = 1, ema: bool = True, seed: int = 0):
    return train_bbdm.BBDMModel(
        1, schedule=BridgeSchedule(**SCHED), accumulate=accumulate,
        compute_dtype="float32", ema=ema,
        generator=torch.Generator().manual_seed(seed), **NET)


def jax_model_and_state(accumulate: int = 1, seed: int = 0):
    """The JAX model and a state of non-zero weights (its zero-init
    layers would keep the output at 0)."""
    jm = JModel(channels=1, schedule=JSchedule(**SCHED),
                accumulate=accumulate, compute_dtype=jnp.float32, **NET)
    x = jnp.zeros((1, SIZE, SIZE, 1))
    arch = jnp.asarray(0.5 * np.random.default_rng(seed).normal(
        size=(jm.n_cells, 3)), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.unet.init(
        {"params": jax.random.key(0)}, x, jnp.zeros((1,), jnp.int32), arch,
        context=x))["params"]
    params = nonzero(shapes, seed + 1)
    # jitted: eager optax inits compile one program a leaf shape
    return jm, jax.jit(lambda p: BBDMState(
        params=p, arch=arch, opt=jm.tx.init(p), ema=jax.tree.map(jnp.array, p),
        step=jnp.zeros((), jnp.int32)))(params)


def bridge_into(model, state):
    load_flax(model.unet, jax.device_get(state.params))
    with torch.no_grad():
        model.arch.copy_(torch.from_numpy(np.array(state.arch)))
    model.ema = ema_init(dict(model.unet.named_parameters()))


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _weight_gaps(module, tensors: dict, ref):
    """(largest gap of the elements within 1e-5 of the largest, over it;
    the share of the elements beyond, each within 6 lr)."""
    got, _ = state_dict_to_flax(module, tensors)
    fg, fr = _flat(got), _flat(jax.device_get(ref))
    assert fg.keys() == fr.keys()
    top = max(float(np.max(np.abs(v))) for v in fr.values())
    worst, n_out, n_all = 0.0, 0, 0
    for k, r in fr.items():
        err = np.abs(np.asarray(fg[k]) - np.asarray(r))
        out = err > 1e-5 * top
        assert (err[out] <= 6 * LR).all(), (jax.tree_util.keystr(k),
                                            err.max(), top)
        n_out, n_all = n_out + int(out.sum()), n_all + err.size
        if (~out).any():
            worst = max(worst, float(err[~out].max()) / top)
    return worst, n_out / n_all


@pytest.mark.parametrize("accumulate", [1, 2])
def test_three_train_steps_match_jax(accumulate):
    jm, state = jax_model_and_state(accumulate)
    model = port_model(accumulate)
    bridge_into(model, state)
    rng = np.random.default_rng(9)
    root = jax.random.key(3)
    gaps = []
    for it in range(3):
        batch = {k: rng.uniform(0, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
                 for k in ("image_pix2pix", "mask_pix2pix")}
        key = jax.random.fold_in(root, 2 * it)
        state, mj = jm.train_step(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, key)
        mt = model.train_step(train_bbdm.to_device(batch, "cpu"),
                              jax_loss_draws(key, (2, SIZE, SIZE, 1),
                                             SCHED["num_timesteps"]))
        a, b = float(mt["loss"]), float(mj["loss"])
        gaps.append(abs(a - b) / abs(b))
        assert gaps[-1] <= 1e-5, (it, a, b)
    assert model.step == int(state.step) == 3
    w, share = _weight_gaps(model.unet, model.unet.state_dict(),
                            state.params)
    assert share <= 1e-2, share
    e, e_share = _weight_gaps(model.unet, model.ema, state.ema)
    assert e_share <= 1e-2, e_share
    print(f"accumulate={accumulate}: losses {max(gaps):.2e} relative; "
          f"weights {w:.2e} of the largest, {share:.2%} Adam noise "
          f"elements; EMA {e:.2e}, {e_share:.2%}")


ARGV = ["--preset=bbdm", "--data.synthetic=true", f"--data.image_size={SIZE}",
        "--data.n_train=6", "--data.n_val=2", "--data.n_test=3",
        "--data.batch_size=2", "--model.compute_dtype=float32",
        "--engine.valid_step=2", "--run.device=cpu",
        "--run.topk_checkpoints=2"]


def _final_state(model):
    sd = model.state_dict()
    return {"unet": sd["unet"], "ema": sd["ema"], "arch": sd["arch"],
            "opt": sd["opt"]["state"], "lr": model.opt.param_groups[0]["lr"],
            "step": sd["step"]}


def _same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _val_losses(run_dir):
    with open(run_dir / "metrics.jsonl") as f:
        return {r["step"]: r["val_loss"] for r in map(json.loads, f)
                if "val_loss" in r}


def test_resume_mid_epoch_and_sample_eval(tmp_path):
    # 6 training images at batch 2: 3 batches an epoch, so iteration 4 is
    # one batch into the second epoch
    straight = parse_config(ARGV + [f"--run.save_dir={tmp_path / 'a'}"])
    m_a, res_a = train_bbdm.train(straight, 6, port_model())
    argv_b = ARGV + [f"--run.save_dir={tmp_path / 'b'}"]
    train_bbdm.train(parse_config(argv_b), 4, port_model())
    m_b, _ = train_bbdm.train(parse_config(argv_b + ["--run.resume=true"]),
                              6, port_model())
    _same(_final_state(m_b), _final_state(m_a))
    assert _val_losses(tmp_path / "b" / "bbdm") == \
        _val_losses(tmp_path / "a" / "bbdm") == \
        {r["it"]: r["val_loss"] for r in res_a["log"]}
    run = tmp_path / "a" / "bbdm"
    assert sorted(p.name for p in (run / "ckpt_top").iterdir()) == \
        sorted(str(r["it"]) for r in sorted(
            res_a["log"], key=lambda r: r["val_loss"])[:2])
    assert (run / "bbdm_best.pt").is_file() and \
        (run / "bbdm_latest.pt").is_file()

    # run.sample_only: the latest checkpoint, two samples a condition
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path / 'a'}",
                               "--run.sample_only=true"])
    samples, scores = train_bbdm.sample_eval(cfg, port_model(seed=1),
                                             n_per_cond=2)
    assert samples.shape == (3, 2, SIZE, SIZE, 1)
    assert np.isfinite(samples).all() and samples.min() >= 0.0 and \
        samples.max() <= 1.0
    assert scores == {"diversity": jdiversity(samples)}
    assert sorted(p.name for p in (run / "sample_to_eval").iterdir()) == \
        ["cond0.png", "cond1.png"]
    # FID and LPIPS score once given the feature nets (random weights
    # here; tests/test_torch_feature_nets.py holds them against JAX)
    from semantic_segmentation_torch.models.extractors import \
        AlexNetFeatures
    big = np.repeat(np.repeat(samples, 8, axis=2), 8, axis=3)
    alex = (AlexNetFeatures(), [torch.ones(w) for w in (64, 192, 384, 256,
                                                        256)])
    scores = train_bbdm.evaluate_samples(big, big[:, 0], alex=alex)
    assert scores["lpips"] == 0.0
    assert scores["diversity"] == jdiversity(big)


@pytest.mark.parametrize("entry", [train_bbdm, train_end2end_bbdm])
def test_entries_need_cuda_or_cpu(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(train_bbdm.MODE_B, "0")   # restored after the test
    monkeypatch.delenv(train_bbdm.MODE_B)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main(["--data.synthetic=true", f"--run.save_dir={tmp_path}"])


@pytest.mark.parametrize("device, env, initialized, want, warns", [
    ("cuda", None, False, "1", False),
    ("cuda", None, True, "1", True),
    ("cuda", "0", True, "0", False),
    ("cpu", None, True, None, False),
])
def test_prefer_cudnn_heuristic_mode_b(device, env, initialized, want, warns,
                                       monkeypatch, recwarn):
    """Mode B on a CUDA device unless the environment already says; a
    CUDA context made before the call draws a warning (a conv may already
    have fixed cuDNN's mode); nothing for the CPU."""
    monkeypatch.setenv(train_bbdm.MODE_B, "x")   # restored after the test
    if env is None:
        monkeypatch.delenv(train_bbdm.MODE_B)
    else:
        monkeypatch.setenv(train_bbdm.MODE_B, env)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialized)
    train_bbdm.prefer_cudnn_heuristic_mode_b(device)
    assert os.environ.get(train_bbdm.MODE_B) == want
    ours = [w for w in recwarn if train_bbdm.MODE_B in str(w.message)]
    assert len(ours) == int(warns)
