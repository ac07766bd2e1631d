"""The port's GenSeg-3D losses and init laws against the JAX package's:

- the weighted cross entropy within 1e-6 (and its gradient within 1e-6 of
  the largest), against torch's ``cross_entropy(weight=)`` too;
- the argmax Dice: value bit for bit, its gradient exactly 0 in both;
- ``zero_division``: both branches, value and gradient, with no NaN;
- the masked-L1 + tumour-MSE generator loss, with and without a tumour,
  within 1e-6 relative (``GenSeg3D.g_losses`` against the JAX problem's);
- ``seg_criterion`` and ``mse_loss`` within 1e-6;
- ``reinit_``: each law on the torch layout, by shape, zeroed biases, BN
  scales around 1, and sample std against the law within 5% (the draws
  themselves cannot match)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.ops import losses as jl
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.pix2pix.networks3d import (
    NLayerDiscriminator3D, UnetGenerator3D)
from semantic_segmentation_torch.ops import losses as tl
from semantic_segmentation_torch.ops.layers import BatchNorm2d, reinit_
from semantic_segmentation_torch.train.train_end2end_3d import GenSeg3D


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_weighted_cross_entropy():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 6, 5, 4, 2)).astype(np.float32)
    labels = rng.integers(0, 2, size=(2, 6, 5, 4)).astype(np.float32)
    w = (0.004, 0.996)
    ref, gref = jax.value_and_grad(lambda l: jl.softmax_cross_entropy_weighted(
        l, jnp.asarray(labels), w))(jnp.asarray(logits))
    lt = _ncdhw(logits).requires_grad_(True)
    out = tl.softmax_cross_entropy_weighted(lt, torch.from_numpy(labels), w)
    out.backward()
    assert abs(float(out) - float(ref)) <= 1e-6 * abs(float(ref))
    g = np.moveaxis(lt.grad.numpy(), 1, -1)
    assert np.max(np.abs(g - np.asarray(gref))) <= 1e-6 * np.max(
        np.abs(np.asarray(gref)))
    torch_ref = torch.nn.functional.cross_entropy(
        _ncdhw(logits), torch.from_numpy(labels).long(),
        weight=torch.tensor(w))
    assert abs(float(out) - float(torch_ref)) <= 1e-6


def test_argmax_dice_value_and_zero_gradient():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 6, 5, 4, 2)).astype(np.float32)
    target = (rng.random((2, 6, 5, 4)) > 0.5).astype(np.float32)
    ref = jl.argmax_dice_score(jnp.asarray(logits), jnp.asarray(target))
    lt = _ncdhw(logits).requires_grad_(True)
    out = tl.argmax_dice_score(lt, torch.from_numpy(target))
    assert np.float32(out) == np.float32(ref)
    gj = jax.grad(lambda l: jl.argmax_dice_loss(l, jnp.asarray(target)))(
        jnp.asarray(logits))
    assert float(jnp.abs(gj).max()) == 0.0
    # the constant next to a differentiable term: its gradient is exactly
    # that term's
    loss = tl.argmax_dice_loss(lt, torch.from_numpy(target)) + lt.sum() * 0
    loss.backward()
    assert float(lt.grad.abs().max()) == 0.0
    assert float(tl.argmax_dice_loss(lt, torch.from_numpy(target))) == \
        float(jl.argmax_dice_loss(jnp.asarray(logits), jnp.asarray(target)))


@pytest.mark.parametrize("d", [0.0, 4.0])
def test_zero_division_both_branches(d):
    n = torch.tensor(3.0, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    out = tl.zero_division(n * 2.0, dt)
    out.backward()
    jv, (gn, gd) = jax.value_and_grad(
        lambda a, b: jl.zero_division(a * 2.0, b), argnums=(0, 1))(3.0, d)
    assert float(out) == float(jv) == (0.0 if d == 0 else 1.5)
    assert float(n.grad) == float(gn) and not torch.isnan(n.grad)
    assert dt.grad is not None and not torch.isnan(dt.grad)


@pytest.mark.parametrize("tumour", [True, False], ids=["tumour", "none"])
def test_generator_loss_masked_l1_tumour_mse(tumour):
    from semantic_segmentation_tpu.ops import losses as jlosses
    rng = np.random.default_rng(2)
    shape = (1, 8, 8, 8, 1)
    fake = rng.random(shape).astype(np.float32) * 2 - 1
    batch = {"B": rng.random(shape).astype(np.float32) * 2 - 1,
             "mask": (rng.random(shape) > 0.4).astype(np.float32),
             "truth": ((rng.random(shape) > 0.8) if tumour
                       else np.zeros(shape)).astype(np.float32)}
    lam, gamma = 100.0, 10.0
    ref = float(jlosses.zero_division(
        jlosses.l1_loss_sum(fake * batch["mask"], batch["B"] * batch["mask"])
        * lam, jnp.sum(batch["mask"])) + jlosses.zero_division(
        jlosses.mse_loss_sum(fake * batch["truth"],
                             batch["B"] * batch["truth"]) * gamma,
        jnp.sum(batch["truth"])))
    cfg = parse_config(["--model.ngf=2", "--model.ndf=2",
                        "--model.base_features=2", "--optim.lambda_L1=100"])
    model = GenSeg3D(cfg, num_downs=3, gamma_tmse=gamma)
    out = model.g_losses(_ncdhw(fake), {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert abs(float(out) - ref) <= 1e-6 * abs(ref)


def test_seg_criterion_and_mse():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 5, 6))
    ref = float(jl.seg_criterion(jnp.asarray(logits), jnp.asarray(labels), 3))
    out = float(tl.seg_criterion(
        torch.from_numpy(np.moveaxis(logits, -1, 1).copy()),
        torch.from_numpy(labels), 3))
    assert abs(out - ref) <= 1e-6 * abs(ref)
    x, y = logits[..., :1], logits[..., 1:2]
    ref = float(jl.seg_criterion(jnp.asarray(x), jnp.asarray(y > 0), 1))
    out = float(tl.seg_criterion(torch.from_numpy(x),
                                 torch.from_numpy(y > 0), 1))
    assert abs(out - ref) <= 1e-6 * abs(ref)
    assert abs(float(tl.mse_loss(torch.from_numpy(x), torch.from_numpy(y)))
               - float(jl.mse_loss(x, y))) <= 1e-6


def _std_law(init_type, w, gain):
    rf = math.prod(w.shape[2:])
    if init_type == "normal":
        return gain
    if init_type == "xavier":
        return gain * math.sqrt(2.0 / (rf * w.shape[1] + rf * w.shape[0]))
    if init_type == "kaiming":
        return math.sqrt(2.0 / (rf * w.shape[1]))
    # orthogonal: the rows (or columns) of the flattening have norm gain
    rows, cols = w.shape[0], w.numel() // w.shape[0]
    return gain * math.sqrt(min(rows, cols) / (rows * cols))


@pytest.mark.parametrize("init_type",
                         ["normal", "xavier", "kaiming", "orthogonal"])
def test_reinit_laws(init_type):
    gain = 0.5
    nets = {"G deconv batch": UnetGenerator3D(1, 1, 3, 8, "deconvolution",
                                              False, "batch"),
            "G linear instance": UnetGenerator3D(1, 1, 3, 8, "linear",
                                                 False, "instance"),
            "D batch": NLayerDiscriminator3D(2, 8, 3, "batch")}
    gen = torch.Generator().manual_seed(0)
    for name, net in nets.items():
        shapes = {k: p.shape for k, p in net.named_parameters()}
        reinit_(net, init_type, gain, gen)
        for k, p in net.named_parameters():
            assert p.shape == shapes[k]
            owner = net.get_submodule(k.rpartition(".")[0])
            leaf = k.rpartition(".")[2]
            if isinstance(owner, BatchNorm2d):
                if leaf == "bias":
                    assert float(p.abs().max()) == 0.0
                else:
                    assert abs(float(p.mean()) - 1.0) <= 4 * gain
            elif leaf.startswith("bias"):
                assert float(p.abs().max()) == 0.0, (name, k)
            elif p.numel() >= 2000:
                want = _std_law(init_type, p, gain)
                got = float(p.std()) if init_type != "orthogonal" else \
                    float(p.pow(2).mean().sqrt())
                assert abs(got / want - 1.0) <= 0.05, (name, k, got, want)
        if init_type == "orthogonal":
            w = net.conv1.weight if name.startswith("D") else \
                net.down1.weight if "deconv" in name else net.down1.kernel_4
            flat = w.reshape(w.shape[0], -1)
            short = flat @ flat.T if flat.shape[0] <= flat.shape[1] \
                else flat.T @ flat
            eye = torch.eye(short.shape[0]) * gain ** 2
            assert torch.allclose(short, eye, atol=1e-5), name
    with pytest.raises(NotImplementedError):
        reinit_(nets["D batch"], "uniform")
