"""Two ``train_step``s of the port's Pix2Pix against the JAX package's with
dropout on (unet_64, ngf = ndf = 4, 64^2, f32, bridged weights): the JAX
step's dropout draws, one set per G forward (the fake forward and the G
step's), are injected into the port's step. Losses within rtol 2e-4;
parameters and BN stats as in ``tests/test_torch_pix2pix.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_nets import _dropout_masks
from tests.test_torch_pix2pix import (_batches, _check_losses, _compare_state,
                                      _models, _torch_batch)


def test_train_steps_with_dropout_match_jax():
    jm, state, tm = _models("unet_64", nf=4, size=64, dropout=True, seed=3)
    loss_gaps = {}
    for i, b in enumerate(_batches(2, size=64, seed=4)):
        key = jax.random.key(i + 20)
        rng_fake, rng_g = jax.random.split(key)
        # the keep-masks of the two G forwards of the step; a mask depends
        # on the key and the shape only
        draws = []
        for rng in (rng_fake, rng_g):
            m = _dropout_masks(jm.G, {"params": state.g_params,
                                      "batch_stats": state.g_stats},
                               jnp.asarray(b["mask_pix2pix"]),
                               state.arch["upconv"], rng=rng)
            assert set(m) == {4}
            draws.append({d: torch.from_numpy(
                np.ascontiguousarray(np.transpose(v, (0, 3, 1, 2))))
                for d, v in m.items()})
        state, mj = jm.train_step(state, b, key)
        mt = tm.train_step(_torch_batch(b), dropout_masks=tuple(draws))
        _check_losses(mj, mt, i, loss_gaps)
    gaps = _compare_state(tm, state)
    print("two dropout train_steps: relative loss gaps",
          {k: f"{v:.2e}" for k, v in loss_gaps.items()},
          "| after two steps (gap, sign-noise elements)", gaps)
