"""The port's Brownian bridge (``models/diffusion/bbdm.py``) and EMA
(``models/diffusion/ema.py``) against the JAX package's, f32:

- the schedule tables (``m_t``, ``variance_t``, the step table) equal,
  exactly, for ``linear``/``sin`` x ``linear``/``cosine`` x skip sampling on
  and off at T = 20, 5 sample steps, and for the default 200-step table
  (999 ... 15, 10, 5, 1, 0);
- ``q_sample`` and ``predict_x0_from_objective`` for the three objectives
  within 1e-6;
- ``p_losses`` (l1 and l2) and ``p_sample_step`` (a middle step and the
  final step 0) around a linear toy denoiser, with the JAX draws (t, the
  noise) injected: within 1e-6;
- (the 5-step ``p_sample_loop`` around the ADM denoiser is in
  ``tests/test_torch_bbdm_nets.py``, beside that net's one JAX compile);
- ``ema_step``: the copy at step 0 (decay 0), no change off the interval,
  the decayed blend from ``start_ema_step`` on, within 1e-7.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.diffusion import bbdm as jbbdm
from semantic_segmentation_tpu.models.diffusion import ema as jema
from semantic_segmentation_torch.models.diffusion import bbdm as tbbdm
from semantic_segmentation_torch.models.diffusion import ema as tema
from tests.test_torch_bbdm_nets import nchw, nhwc

SHORT = dict(num_timesteps=20, sample_step=5)


@pytest.mark.parametrize("mt_type", ["linear", "sin"])
@pytest.mark.parametrize("sample_type", ["linear", "cosine"])
@pytest.mark.parametrize("skip", [True, False])
def test_schedule_tables(mt_type, sample_type, skip):
    kw = dict(SHORT, mt_type=mt_type, sample_type=sample_type,
              skip_sample=skip)
    ref, got = jbbdm.BridgeSchedule(**kw), tbbdm.BridgeSchedule(**kw)
    for k in ("m_t", "variance_t", "steps"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_default_step_table():
    ref, got = jbbdm.BridgeSchedule(), tbbdm.BridgeSchedule()
    np.testing.assert_array_equal(got.steps, ref.steps)
    np.testing.assert_array_equal(got.m_t, ref.m_t)
    np.testing.assert_array_equal(got.variance_t, ref.variance_t)
    assert len(got.steps) == 200 and got.steps[0] == 999
    assert list(got.steps[-5:]) == [15, 10, 5, 1, 0]


def _toy(objective="grad", loss_type="l1", w=0.3):
    """(JAX bridge, port bridge, port denoiser) around x -> w * x."""
    jb = jbbdm.BrownianBridge(lambda p, x, t, c, r, train: p["w"] * x,
                              jbbdm.BridgeSchedule(**SHORT), objective,
                              loss_type)
    tb = tbbdm.BrownianBridge(tbbdm.BridgeSchedule(**SHORT), objective,
                              loss_type)
    return jb, tb, (lambda x, t, c, train: w * x)


def _data(seed=0, shape=(2, 8, 8, 1)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("objective", ["grad", "noise", "ysubx"])
def test_q_sample_and_predict_x0(objective):
    jb, tb, _ = _toy(objective)
    x0, y, noise = _data()
    t = np.array([3, 17])
    jx, jobj = jb.q_sample(*map(jnp.asarray, (x0, y)), jnp.asarray(t),
                           jnp.asarray(noise))
    tx, tobj = tb.q_sample(nchw(x0), nchw(y), torch.from_numpy(t),
                           nchw(noise))
    np.testing.assert_allclose(nhwc(tx), jx, atol=1e-6, rtol=0)
    np.testing.assert_allclose(nhwc(tobj), jobj, atol=1e-6, rtol=0)
    rec = np.random.default_rng(1).normal(size=x0.shape).astype(np.float32)
    jp = jb.predict_x0_from_objective(jx, jnp.asarray(y), jnp.asarray(t),
                                      jnp.asarray(rec))
    tp = tb.predict_x0_from_objective(tx, nchw(y), torch.from_numpy(t),
                                      nchw(rec))
    np.testing.assert_allclose(nhwc(tp), jp, atol=1e-6, rtol=0)


@partial(jax.jit, static_argnums=(1, 2))
def _loss_draws(rng, x0_shape, T):
    rng_t, rng_n, _ = jax.random.split(rng, 3)
    return (jax.random.randint(rng_t, (x0_shape[0],), 0, T),
            jax.random.normal(rng_n, x0_shape, jnp.float32))


def jax_loss_draws(rng, x0_shape, T):
    """What the JAX ``p_losses`` draws from ``rng`` (bbdm.py:114-116), in
    the port's layout."""
    t, noise = _loss_draws(rng, tuple(x0_shape), T)
    return {"t": torch.from_numpy(np.array(t)).long(), "noise": nchw(noise)}


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses(loss_type):
    jb, tb, den = _toy("grad", loss_type)
    x0, y, _ = _data(2)
    rng = jax.random.key(7)
    jl, jaux = jb.p_losses({"w": jnp.float32(0.3)}, jnp.asarray(x0),
                           jnp.asarray(y), rng)
    tl, taux = tb.p_losses(den, nchw(x0), nchw(y),
                           jax_loss_draws(rng, x0.shape, 20))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(nhwc(taux["x0_recon"]), jaux["x0_recon"],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("i", [2, 4])
def test_p_sample_step(i):
    jb, tb, den = _toy()
    xt, y, _ = _data(3)
    rng = jax.random.key(11)
    assert (int(jb.sched.steps[i]) == 0) == (i == 4)
    jx, jrec = jb.p_sample_step({"w": jnp.float32(0.3)}, jnp.asarray(xt),
                                jnp.asarray(y), jnp.asarray(y), i, rng)
    noise = nchw(jax.random.normal(rng, xt.shape, jnp.float32))
    tx, trec = tb.p_sample_step(den, nchw(xt), nchw(y), nchw(y), i, noise)
    np.testing.assert_allclose(nhwc(tx), jx, atol=1e-6, rtol=0)
    np.testing.assert_allclose(nhwc(trec), jrec, atol=1e-6, rtol=0)
    if i == 4:                        # the final step returns x0_recon
        assert torch.equal(tx, trec)


def test_ema_step():
    cfg_kw = dict(ema_decay=0.9, update_ema_interval=2, start_ema_step=4)
    jcfg, tcfg = jema.EMAConfig(**cfg_kw), tema.EMAConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    shadow = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    params = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in shadow.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for step in (0, 3, 6):
        ref = jema.ema_step(jcfg, jnp.int32(step),
                            {k: jnp.asarray(v) for k, v in shadow.items()},
                            {k: jnp.asarray(v) for k, v in params.items()})
        tshadow = tema.ema_init({k: torch.from_numpy(v)
                                 for k, v in shadow.items()})
        got = tema.ema_step(tcfg, step, tshadow, tparams)
        for k in shadow:
            np.testing.assert_allclose(got[k].numpy(), ref[k], atol=1e-7,
                                       rtol=0)
        if step == 0:
            for k in shadow:
                np.testing.assert_array_equal(got[k].numpy(), params[k])
        if step == 3:
            for k in shadow:
                np.testing.assert_array_equal(got[k].numpy(), shadow[k])
