"""Five ``train_step``s of the port's Pix2Pix against the JAX package's at
``model.norm=instance`` (unet_32, ngf = ndf = 8, f32, dropout off, bridged
weights), in the pattern of ``tests/test_torch_pix2pix.py``: losses per
step within its tolerances (rtol 2e-4), then G's and D's parameters within
1e-4 of each tensor's largest magnitude, but for Adam's sign-noise elements
(each within 2 lr a step) and for the biases of the convs that an instance
norm follows, whose gradient is 0 in exact arithmetic (rounding noise that
Adam turns into steps of up to lr: each within 2 lr a step); then
``generate`` within 1e-5. Also: ``build_pix2pix`` takes the norm and the
non-default init laws from the config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.pix2pix.model import Pix2Pix as JPix2Pix
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.pix2pix.model import Pix2Pix
from semantic_segmentation_torch.ops.layers import BatchNorm2d, InstanceNorm
from semantic_segmentation_torch.train.train_pix2pix import build_pix2pix
from semantic_segmentation_torch.utils.bridge import state_dict_to_flax
from tests.test_torch_pix2pix import (_batches, _check_losses, _torch_batch,
                                     jax_state)

LR, ARCH_LR, STEPS = 2e-5, 1e-4, 5
# the convs an instance norm follows (unet_32: nd 5; the basic PatchGAN)
NORMED = {"G": tuple(f"down{d}" for d in range(1, 4))
          + tuple(f"up{d}" for d in range(1, 5)),
          "D": ("conv1", "conv2", "conv3")}


def _models(seed=0):
    jm = JPix2Pix(input_nc=1, output_nc=1, ngf=8, ndf=8, netG="unet_32",
                  norm="instance", use_dropout=False, lr=LR,
                  arch_lr=ARCH_LR, compute_dtype=jnp.float32)
    tm = Pix2Pix(1, 1, 8, 8, "unet_32", use_dropout=False, lr=LR,
                 arch_lr=ARCH_LR, norm="instance",
                 generator=torch.Generator().manual_seed(seed))
    return jm, jax_state(jm, tm), tm


def _gaps(net, ref, normed):
    """(largest gap within 1e-4 of its leaf's largest, over it; elements
    beyond; largest gap of the zero-gradient biases)."""
    port, stats = state_dict_to_flax(net, net.state_dict())
    assert not stats
    fp = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    fr = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(ref))[0])
    assert fp.keys() == fr.keys()
    worst, noisy, zero_bias = 0.0, 0, 0.0
    for k, r in fr.items():
        name = jax.tree_util.keystr(k)
        err = np.abs(np.asarray(fp[k]) - np.asarray(r))
        if any(f"['{m}']['bias" in name for m in normed):
            assert err.max() <= 2 * STEPS * LR, name
            zero_bias = max(zero_bias, float(err.max()))
            continue
        scale = max(float(np.max(np.abs(r))), 1e-12)
        out = err > 1e-4 * scale
        assert (err[out] <= 2 * STEPS * LR).all(), (name, err.max(), scale)
        noisy += int(out.sum())
        if (~out).any():
            worst = max(worst, float(err[~out].max()) / scale)
    return worst, noisy, zero_bias


def test_five_instance_norm_train_steps_match_jax():
    jm, state, tm = _models()
    assert not any(isinstance(m, BatchNorm2d) for m in tm.G.modules())
    assert any(isinstance(m, InstanceNorm) for m in tm.G.modules())
    loss_gaps = {}
    for i, b in enumerate(_batches(STEPS)):
        state, mj = jm.train_step(state, b, jax.random.key(i + 10))
        mt = tm.train_step(_torch_batch(b))
        _check_losses(mj, mt, i, loss_gaps)
    g = _gaps(tm.G, state.g_params, NORMED["G"])
    d = _gaps(tm.D, state.d_params, NORMED["D"])
    assert g[1] <= 2 and d[1] <= 1, (g, d)
    mask = _batches(1, seed=5)[0]["mask_pix2pix"]
    ref = np.asarray(jm.generate(state, jnp.asarray(mask)))
    out = tm.generate(torch.from_numpy(mask)).numpy()
    gen = float(np.max(np.abs(out - ref)))
    assert gen <= 1e-5
    print("instance norm, five train_steps: relative loss gaps",
          {k: f"{v:.2e}" for k, v in loss_gaps.items()},
          "| G (gap, noise elements, zero-gradient biases)", g, "| D", d,
          f"| generate {gen:.2e}")


@pytest.mark.parametrize("netG,netD", [("unet_32", "basic"),
                                       ("resnet_6blocks", "pixel")])
def test_build_pix2pix_norm_and_init_from_config(netG, netD):
    cfg = parse_config([f"--model.netG={netG}", f"--model.netD={netD}",
                        "--model.ngf=4", "--model.ndf=4",
                        "--model.norm=instance",
                        "--model.init_type=kaiming",
                        "--model.init_gain=0.5"])
    p2p = build_pix2pix(cfg, "cpu", torch.Generator().manual_seed(0))
    for net in (p2p.G, p2p.D):
        assert not any(isinstance(m, BatchNorm2d) for m in net.modules())
        for k, p in net.named_parameters():
            if k.rpartition(".")[2].startswith("bias"):
                assert float(p.abs().max()) == 0.0, k
    # kaiming: std sqrt(2 / fan_in), unlike the default N(0, 0.02)
    w = p2p.D.conv0.weight if netD == "basic" else p2p.D.conv1.weight
    fan = w[0].numel()
    assert float(w.std()) > 2 * 0.02 and abs(
        float(w.std()) / (2.0 / fan) ** 0.5 - 1.0) < 0.3
