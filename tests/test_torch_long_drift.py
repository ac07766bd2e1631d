"""The whole-program envelope: the port's ``BilevelEngine`` run free for 200
iterations against the JAX package's, with the envelope
``tests/test_long_drift.py`` holds its torch restatement of the reference
to (:236, :247, :270).

Configuration: ``tests/test_end2end.tiny_cfg`` as ``test_long_drift``
takes it — ``decay_only``, f32, 32^2, ``unet_32`` with ngf = ndf = U-Net
base 8, no dropout, the ``minmax`` post-process. Both engines start from
the JAX initial weights (bridged into the port) with fresh optimizers and
take the same numpy-seeded batches each iteration; the augment affines of
the U-Net problem are the JAX engine's, re-derived from its key chain and
injected. The port's generators are seeded explicitly by ``build_engine``
(none of them draws here: every draw is injected).

Asserted: per-step losses within rtol 5e-3, atol 5e-4 over the first 20
steps; 25-step windowed means of the U-Net loss within 5% relative; the
final U-Nets' Dice on a held-out set within 0.5 pt, both scored by the JAX
package's evaluation (the port's weights bridged back). The measured gaps
are printed (``-s``).

The port runs on one thread, as ``test_long_drift`` runs its oracle: the
final Dice is chaotic in the sums' order, and another thread count
reorders them.

The JAX engine, its initial state and its jitted ``engine_step`` are built
once for the file (``jax_side``): the second test runs
``scripts/drift_torch_ensemble.py``'s per-seed function on them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.ops.augment import sample_affine_batch
from semantic_segmentation_tpu.ops.metrics import eval_batch_score
from semantic_segmentation_tpu.train.train_end2end import \
    build_engine_and_state
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.train.train_end2end import build_engine
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)
from tests.test_end2end import tiny_cfg

# one thread, as tests/test_long_drift.py runs: the sums' order, and so the
# trajectory, depends on the thread count
torch.set_num_threads(1)

N_STEPS = 200
ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=4",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.netG=unet_32", "--model.ngf=8", "--model.ndf=8",
        "--model.base_features=8", "--model.no_dropout=true",
        "--engine.fake_postprocess=minmax", "--engine.hypergrad=decay_only",
        "--run.device=cpu"]


@jax.jit
def _jax_affines(key):
    rng_r = jax.random.split(key, 3)[2]
    rng_p = jax.random.fold_in(jax.random.split(rng_r, 1)[0], 2)
    rng_aug = jax.random.split(rng_p, 3)[0]
    return sample_affine_batch(rng_aug, 2, 32, 32)


def _unet_affines(key):
    """The matrices the JAX ``loss_unet`` samples under ``engine_step(...,
    key)`` in ``decay_only`` (replay rng, K = 1, problem index 2)."""
    return torch.from_numpy(np.array(_jax_affines(key)))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(engine, initial state, seg, jitted engine_step) of the JAX engine,
    compiled once for the file."""
    jcfg = tiny_cfg(str(tmp_path_factory.mktemp("jax")),
                    **{"engine.fake_postprocess": "minmax",
                       "engine.hypergrad": "decay_only",
                       "model.no_dropout": True})
    engine_j, state, _, seg_j = build_engine_and_state(jcfg,
                                                       jax.random.key(5))
    return engine_j, state, seg_j, jax.jit(engine_j.engine_step)


def test_port_engine_stays_in_the_long_drift_envelope(jax_side):
    engine_j, state, seg_j, step_j = jax_side
    cfg = parse_config(ARGV)
    engine, p2p, seg = build_engine(cfg, "cpu")
    host = jax.device_get(state)
    for p in engine.problems:
        load_flax(p.module, host.params[p.name], host.stats[p.name])
    with torch.no_grad():
        for k, v in p2p.arch.items():
            v.copy_(torch.from_numpy(np.array(host.arch[k])))

    rng_np = np.random.default_rng(11)

    def draw_pair():
        mask = (rng_np.random((2, 32, 32, 1)) > 0.6).astype(np.float32)
        image = rng_np.random((2, 32, 32, 1)).astype(np.float32)
        return mask, image

    ours = {"netG": [], "netD": [], "unet": []}
    theirs = {"netG": [], "netD": [], "unet": []}
    for step in range(N_STEPS):
        (mg, ig), (md, idd), (mu, iu) = draw_pair(), draw_pair(), draw_pair()
        batches = {"netG": {"mask_pix2pix": mg, "image_pix2pix": ig},
                   "netD": {"mask_pix2pix": md, "image_pix2pix": idd},
                   "unet": {"image": iu, "mask": mu}}
        stack = {n: jax.tree.map(lambda x: jnp.asarray(x)[None], b)
                 for n, b in batches.items()}
        key = jax.random.fold_in(jax.random.key(77), step)
        state, mj = step_j(state, stack, stack["unet"], key)
        mt = engine.engine_step(
            [{n: {k: torch.from_numpy(v) for k, v in b.items()}
              for n, b in batches.items()}], None,
            {"replay": [{"unet": {"affine": _unet_affines(key)}}]})
        for n in ours:
            ours[n].append(float(mt[f"loss_{n}"]))
            theirs[n].append(float(mj[f"loss_{n}"]))

    # (i) the first 20 steps, step by step (test_long_drift.py:236)
    early = 0.0
    for n in ours:
        a, b = np.asarray(ours[n][:20]), np.asarray(theirs[n][:20])
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4,
                                   err_msg=f"early {n} trajectory")
        early = max(early, float(np.max(np.abs(a - b) / np.abs(b))))
    # (ii) 25-step windowed means of the U-Net loss (:247)
    n_win = (N_STEPS // 25) * 25
    a = np.asarray(ours["unet"][:n_win]).reshape(-1, 25).mean(axis=1)
    b = np.asarray(theirs["unet"][:n_win]).reshape(-1, 25).mean(axis=1)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    assert rel.max() < 0.05, f"windowed unet-loss drift {rel}"
    # (iii) final Dice on a held-out set, both through the JAX evaluation
    # (:270)
    test_mask = (rng_np.random((8, 32, 32, 1)) > 0.6).astype(np.float32)
    test_img = jnp.asarray(rng_np.random((8, 32, 32, 1)).astype(np.float32))
    d_jax = float(eval_batch_score(
        seg_j.eval_logits_p(state.params["unet"], state.stats["unet"],
                            test_img), jnp.asarray(test_mask), 1, "dice"))
    tp, ts = state_dict_to_flax(seg.net, seg.net.state_dict())
    d_port = float(eval_batch_score(
        seg_j.eval_logits_p(jax.tree.map(jnp.asarray, tp),
                            jax.tree.map(jnp.asarray, ts), test_img),
        jnp.asarray(test_mask), 1, "dice"))
    assert abs(d_port - d_jax) < 0.005, (d_port, d_jax)
    print(f"port vs JAX engine, {N_STEPS} steps: early rel max "
          f"{early:.2e}, windowed unet-loss drift max {rel.max():.4f}, "
          f"final dice port {d_port:.4f} jax {d_jax:.4f}")


def test_drift_ensemble_seed_function(jax_side):
    """``scripts/drift_torch_ensemble.run_seed`` for 3 iterations on the
    file's JAX compile, with its controls: trajectory (b), the port on the
    JAX initial weights, within the early tolerance of the JAX losses
    (``test_long_drift.py:236``); a control with eps = 0 equal to (b) bit
    for bit (losses and final Dice); the 1-ulp control (c) apart from
    (b)."""
    from scripts import drift_torch_ensemble as ens
    engine_j, state, seg_j, step_j = jax_side
    rec, losses = ens.run_seed(0, 3, engine_j, state, step_j, seg_j, 32,
                               ens.port_argv(), controls=(("zero", 0.0),
                                                          ("ulp", 1e-7)))
    for n in ("netG", "netD", "unet"):
        np.testing.assert_allclose(losses["base"][n], losses["jax"][n],
                                   rtol=5e-3, atol=5e-4, err_msg=n)
        assert losses["zero"][n] == losses["base"][n], n
    assert rec["final_dice_torch_zero"] == rec["final_dice_torch"]
    assert losses["ulp"]["unet"] != losses["base"]["unet"]
    assert rec["early20_max_rel"]["unet"] < 5e-3


def test_drift_ensemble_one_step_deviation(jax_side):
    """``epsilon`` mode's measure on the file's compile (the JAX state of
    seed 0): one paired iteration leaves the losses within 1e-5 relative;
    the sign flips of the updates are counted per tensor, a small share of
    the elements, and setting them aside shrinks no gap below 0 nor raises
    it."""
    from scripts import drift_torch_ensemble as ens
    engine_j, state, seg_j, step_j = jax_side
    d = ens.one_step_deviation(0, state, step_j, 32)
    assert d["loss_rel_max"] < 1e-5
    assert 0 <= d["sign_flips"] < 0.01 * d["elements"]
    assert d["tensors"] == len(jax.tree.leaves(state.params))
    assert d["param_rel_norm_unflipped"] <= d["param_rel_norm"]
    top = d["largest_tensors"]
    assert [r["rel"] for r in top] == sorted((r["rel"] for r in top),
                                             reverse=True)
    assert all(r["rel_unflipped"] <= r["rel"] and 0 <= r["sign_flips"]
               <= r["n"] for r in top)


def test_drift_ensemble_summary_takes_any_controls():
    """The ensemble's summary over the controls a run names: per control its
    spreads, mean, maximum and Mann-Whitney p of the gap against them."""
    from scripts import drift_torch_ensemble as ens
    recs = [{"seed": s, "gap_jax_vs_torch_pt": g,
             "spread_torch_vs_torch_ulp_pt": u,
             "spread_torch_vs_torch_param_pt": q,
             "early20_max_rel": {"unet": 1e-4}, "windowed_unet_rel_max": w}
            for s, g, u, q, w in ((0, 1.0, 2.0, 3.0, 0.002),
                                  (1, 4.0, 0.5, 1.0, None),
                                  (2, 2.0, 1.0, 5.0, 0.004))]
    out = ens.summary(recs, 1000, (("ulp", 1e-7), ("param", 2e-5)))
    assert out["eps_param"] == 2e-5 and out["seeds"] == [0, 1, 2]
    assert out["param_mean_pt"] == 3.0 and out["param_max_pt"] == 5.0
    assert out["ulp_max_pt"] == 2.0 and out["gap_max_pt"] == 4.0
    assert 0 < out["mannwhitney_gap_vs_param_p"] <= 1
    assert out["windowed_unet_rel_max_all"] == 0.004
    assert ens.parse_controls("ulp=1e-07,param=2.2e-05") == (
        ("ulp", 1e-7), ("param", 2.2e-5))
