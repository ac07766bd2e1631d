"""The port's VQGAN (``models/diffusion/vqgan.py``) against the JAX
package's ``VQModel``, and ``utils/torch_port.port_vqgan`` against the
taming oracle, on the CPU in float32:

- the tiny VQ of ``tests/test_utils_and_latent.py`` (ch 8, ch_mult (1, 2),
  one res block, z 2, embed 2, 32 codes, one channel) on random weights
  drawn from ``jax.eval_shape``'s shapes (no flax init compiled) and
  bridged into the port (``utils/bridge.load_vqgan_flax``): ``encode_pre_
  quant`` and ``decode`` within 1e-5 of the largest magnitude, the code
  indices equal, the codebook loss and ``vq_train_loss`` within 1e-5
  relative, and the
  straight-through gradients of ``mean(recon^2) + qloss`` within 1e-5 of
  each leaf's largest (of 1e-2 of the largest gradient, for the biases
  whose gradient is 0 in exact arithmetic);
- ``port_vqgan`` of a ``TorchTamingVQGAN`` (``tests/torch_oracles.py``)
  ``state_dict`` the test writes, with ``loss.*`` keys beside it: the
  port's names are the oracle's (a strict load), and the reconstruction
  and codebook loss agree within 1e-5.

The worst gaps are printed (``-s``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.diffusion.vqgan import \
    VQModel as JVQModel
from semantic_segmentation_tpu.models.diffusion.vqgan import \
    vq_train_loss as jvq_train_loss
from semantic_segmentation_torch.models.diffusion.vqgan import (VQModel,
                                                                vq_train_loss)
from semantic_segmentation_torch.utils.bridge import (load_vqgan_flax,
                                                      vqgan_state_dict_to_flax)
from semantic_segmentation_torch.utils.torch_port import (load_state_dict,
                                                          port_vqgan)
from tests.test_torch_sivae_nets import random_tree
from tests.torch_oracles import TorchTamingVQGAN

TINY = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=2,
            embed_dim=2, n_embed=32, out_channels=1)
TOL = 1e-5


def tiny_pair(seed: int = 0, size: int = 16, **kw):
    """The JAX tiny VQ with random params (its codebook N(0, 0.5^2), so the
    codes spread) and the port's on the same weights."""
    cfg = {**TINY, **kw}
    jm = JVQModel(dtype=jnp.float32, **cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, size, size, cfg["out_channels"]))))
    params = random_tree(shapes, seed)["params"]
    # a jnp array: the JAX quantizer indexes it with traced indices
    params["quantize"]["embedding"] = jnp.asarray(
        0.5 * np.random.default_rng(seed + 100).normal(
            size=(cfg["n_embed"], cfg["embed_dim"])), jnp.float32)
    tm = VQModel(**cfg)
    load_vqgan_flax(tm, params)
    return jm, params, tm


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def gap(a, b) -> float:
    """|a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def tiny():
    jm, params, tm = tiny_pair()
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 1)).astype(
        np.float32)

    @jax.jit
    def fwd(p, x):
        v = {"params": p}
        z = jm.apply(v, x, method=JVQModel.encode_pre_quant)
        z_q, qloss, idx = jm.apply(v, z, method=lambda m, z: m.quantize(z))
        return z, z_q, qloss, idx, jm.apply(v, z_q, method=JVQModel.decode)

    @jax.jit
    def grads(p, x):
        def loss(p):
            recon, qloss, _ = jm.apply({"params": p}, x)
            return jnp.mean(recon ** 2) + qloss
        return jax.grad(loss)(p)

    return jm, params, tm, x, fwd(params, x), grads(params, x)


def test_forward_matches_jax(tiny):
    _, _, tm, x, (jz, jzq, jq, jidx, jrec), _ = tiny
    with torch.no_grad():
        z = tm.encode_pre_quant(nchw(x))
        zq, q, idx = tm.quantize(z)
        rec = tm.decode(zq)
        full, q_full, idx_full = tm(nchw(x))
    gaps = {"encode_pre_quant": gap(nhwc(z), jz),
            "z_q": gap(nhwc(zq), jzq),
            "decode": gap(nhwc(rec), jrec),
            "qloss": abs(float(q) - float(jq)) / abs(float(jq))}
    jl = float(jvq_train_loss(jrec, x, jq))
    gaps["vq_train_loss"] = abs(float(vq_train_loss(rec, nchw(x), q))
                                - jl) / abs(jl)
    print("vqgan forward gaps:", gaps)
    assert max(gaps.values()) <= TOL, gaps
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(np.asarray(jidx))) > 4      # the codes spread
    assert torch.equal(idx_full, idx) and torch.equal(full, rec)
    assert float(q_full) == float(q)
    assert full.shape == (2, 1, 16, 16) and idx.shape == (2, 8, 8)


def test_straight_through_gradients_match_jax(tiny):
    _, params, tm, x, _, jgrads = tiny
    tm.zero_grad()
    recon, qloss, _ = tm(nchw(x))
    (torch.mean(recon ** 2) + qloss).backward()
    tgrads = vqgan_state_dict_to_flax(
        params, {k: p.grad for k, p in tm.named_parameters()})
    jgrads = jax.device_get(jgrads)
    # a conv bias that a one-channel-group GroupNorm follows has a
    # gradient of 0 in exact arithmetic (rounding leaves ~1e-8): such
    # leaves are held to 1e-2 of the largest gradient instead
    floor = 1e-2 * max(np.abs(g).max() for g in jax.tree.leaves(jgrads))
    gaps = jax.tree.map(
        lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                     floor)),
        tgrads, jgrads)
    worst = max(jax.tree.leaves(gaps))
    print(f"vqgan gradient gap (of each leaf's largest): {worst:.2e}")
    assert worst <= TOL
    # the straight-through estimator reaches the encoder, and the codebook
    # loss the codebook
    assert np.abs(tgrads["encoder"]["conv_in"]["kernel"]).max() > 0
    assert np.abs(tgrads["quantize"]["embedding"]).max() > 0


def test_port_vqgan_matches_the_taming_oracle(tmp_path):
    torch.manual_seed(0)
    oracle = TorchTamingVQGAN(ch=8, ch_mult=(1, 2), nrb=1, z=3, n_embed=16,
                              out_ch=1).eval()
    sd = dict(oracle.state_dict())
    sd["loss.discriminator.main.0.weight"] = torch.zeros(4, 1, 4, 4)
    sd["loss.perceptual_loss.lin0.model.1.weight"] = torch.zeros(1, 64, 1, 1)
    path = str(tmp_path / "vqgan.ckpt")
    torch.save({"state_dict": sd}, path)
    ported = port_vqgan(load_state_dict(path))
    tm = VQModel(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
                 embed_dim=3, n_embed=16, out_channels=1)
    assert set(ported) == set(tm.state_dict())
    tm.load_state_dict(ported, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 1, 16, 16)).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        o_rec, o_q = oracle(x)
        t_rec, t_q, _ = tm(x)
    g = gap(t_rec.numpy(), o_rec.numpy())
    print(f"port_vqgan against taming: recon {g:.2e}, qloss "
          f"{abs(float(t_q) - float(o_q)) / abs(float(o_q)):.2e}")
    assert g <= TOL
    assert abs(float(t_q) - float(o_q)) <= TOL * abs(float(o_q))
