"""The port's checkpoint maps (``utils/torch_port.py``) against the JAX
package's: for each reference checkpoint, written by the test from the
oracles of ``tests/torch_oracles.py`` (random weights and BN statistics)
or the synthetic timm Swin of ``tests/test_swin_port.py``, the port's map
overlaid on a fresh net gives the same ``state_dict``, bit for bit, as the
JAX map overlaid on the same init (``overlay_pytree``) and carried across
by ``utils/bridge.py``:

- ``port_deeplabv3``: a full head, and a 21-class (COCO) head over a
  1-class net, whose fresh classifier stays;
- ``port_resnet50_backbone``: an ImageNet resnet50 (its ``fc`` ignored)
  overlays the backbone only;
- ``port_deeplabv2`` and ``port_swin_tiny`` (the decoder mirror);
- ``overlay`` refuses a key the net lacks and a shape that differs;
- ``run.seg_pretrained`` through ``train_unet``'s init: a milesial U-Net,
  against the JAX package's ``apply_seg_pretrained``, then two steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_segmentation_torch.train.common as common
from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.models.deeplab import (DeepLabV2 as JV2,
                                                      DeepLabV3 as JV3)
from semantic_segmentation_tpu.models.swin_unet import SwinUnet as JSwin
from semantic_segmentation_tpu.train.common import (
    apply_seg_pretrained as japply_seg_pretrained,
    build_seg_problem as jbuild_seg_problem)
from semantic_segmentation_tpu.utils import torch_port as jport
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.deeplab import DeepLabV2, DeepLabV3
from semantic_segmentation_torch.models.swin_unet import SwinUnet
from semantic_segmentation_torch.train import train_unet
from semantic_segmentation_torch.utils import torch_port
from semantic_segmentation_torch.utils.bridge import (flax_to_state_dict,
                                                      load_flax)
from tests.test_swin_port import fake_timm_sd
from tests.test_torch_sivae_nets import random_variables
from torch_oracles import TorchDeepLabV2, TorchDeepLabV3, TorchMilesialUNet

L4 = (1, 1, 1, 1)


def _randomize(module, seed):
    """Random weights and BN statistics, so a map that mixes up two
    layers shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return module


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _same_as_jax(tnet, jnet, x_shape, ported, jported):
    """``tnet`` with ``ported`` overlaid equals the JAX init (the same
    one, bridged into ``tnet`` first) with ``jported`` overlaid."""
    # values drawn from the init's shapes (no flax init is compiled)
    v = random_variables(jnet, jnp.zeros(x_shape), train=False)
    load_flax(tnet, v["params"], v.get("batch_stats", {}))
    fresh = {k: t.clone() for k, t in tnet.state_dict().items()}
    torch_port.overlay(tnet, ported)
    jp, js = jported
    want = flax_to_state_dict(
        tnet, jax.device_get(jport.overlay_pytree(v["params"], jp)),
        jax.device_get(jport.overlay_pytree(v.get("batch_stats", {}), js)))
    got = tnet.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    return fresh, got


def test_port_deeplabv3_full_head():
    oracle = _randomize(TorchDeepLabV3(n_classes=1, layers=L4), 1)
    sd = oracle.state_dict()
    net = DeepLabV3(1, 1, layers=L4)
    _, got = _same_as_jax(net, JV3(1, 1, layers=L4, dtype=jnp.float32),
                          (1, 32, 32, 1), torch_port.port_deeplabv3(sd),
                          jport.port_deeplabv3(_np(sd), layers=L4))
    assert torch.equal(got["classifier.weight"], sd["classifier.4.weight"])
    assert torch.equal(got["aspp.pool_bn.running_var"],
                       sd["classifier.0.convs.4.2.running_var"])
    # the whole net is the oracle's: the same eval logits
    net.eval()
    oracle.eval()
    x = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), oracle(x).numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_port_deeplabv3_coco_head_over_one_class():
    sd = _randomize(TorchDeepLabV3(n_classes=21, layers=L4), 2).state_dict()
    ported = torch_port.port_deeplabv3(sd, n_classes=1)
    assert not any(k.startswith("classifier.") for k in ported)
    fresh, got = _same_as_jax(
        DeepLabV3(1, 1, layers=L4), JV3(1, 1, layers=L4, dtype=jnp.float32),
        (1, 32, 32, 1), ported,
        jport.port_deeplabv3(_np(sd), layers=L4, n_classes=1))
    assert torch.equal(got["classifier.weight"], fresh["classifier.weight"])
    assert torch.equal(got["head_conv.weight"], sd["classifier.1.weight"])


def test_port_resnet50_backbone():
    trunk = _randomize(TorchDeepLabV3(n_classes=1, layers=L4), 3).backbone
    sd = {**trunk.state_dict(), "fc.weight": torch.zeros(1000, 2048),
          "fc.bias": torch.zeros(1000)}
    ported = torch_port.port_resnet50_backbone(sd)
    assert all(k.startswith("backbone.") for k in ported)
    jp, js = jport.port_resnet50_backbone(_np(sd))
    fresh, got = _same_as_jax(
        DeepLabV3(1, 1, layers=L4), JV3(1, 1, layers=L4, dtype=jnp.float32),
        (1, 32, 32, 1), ported, ({"backbone": jp}, {"backbone": js}))
    assert torch.equal(got["backbone.layer4_0.down_bn.running_mean"],
                       sd["layer4.0.downsample.1.running_mean"])
    for k in ("aspp.b1_conv.weight", "head_conv.weight", "classifier.bias"):
        assert torch.equal(got[k], fresh[k]), k
    # seg_pretrained dispatches an ImageNet resnet50 to the backbone map
    assert torch_port.port_seg_checkpoint("deeplab", sd).keys() == \
        ported.keys()


def test_port_deeplabv2():
    sd = _randomize(TorchDeepLabV2(3, 2, layers=(1, 1, 1)), 4).state_dict()
    _same_as_jax(DeepLabV2(3, 2, layers=(1, 1, 1)),
                 JV2(3, 2, layers=(1, 1, 1), dtype=jnp.float32),
                 (1, 48, 48, 3), torch_port.port_deeplabv2(sd),
                 jport.port_deeplabv2(_np(sd), layers=(1, 1, 1)))


def test_port_swin_tiny_mirrors_the_encoder():
    kw = dict(img_size=64, patch_size=4, embed_dim=12, depths=L4,
              depths_decoder=L4, num_heads=(2, 2, 2, 2), window_size=2)
    sd = fake_timm_sd()
    ported = torch_port.port_swin_tiny(sd, L4, L4)
    _, got = _same_as_jax(
        SwinUnet(1, 2, generator=torch.Generator().manual_seed(0), **kw),
        JSwin(n_channels=1, n_classes=2, dtype=jnp.float32, **kw),
        (1, 64, 64, 1), ported,
        (jport.port_swin_tiny(sd, depths=L4, depths_decoder=L4), {}))
    assert torch.equal(got["dec0_blk0.attn.qkv.weight"],
                       got["enc2_blk0.attn.qkv.weight"])


def test_overlay_refuses_unknown_keys_and_shapes():
    net = DeepLabV3(1, 1, layers=L4)
    full = _randomize(TorchDeepLabV3(n_classes=1, layers=(1, 2, 1, 1)),
                      5).state_dict()
    with pytest.raises(ValueError, match="lacks"):
        torch_port.overlay(net, torch_port.port_deeplabv3(full))
    coco = _randomize(TorchDeepLabV3(n_classes=21, layers=L4),
                      6).state_dict()
    before = {k: t.clone() for k, t in net.state_dict().items()}
    with pytest.raises(ValueError, match="shapes differ"):
        torch_port.overlay(net, torch_port.port_deeplabv3(coco))
    for k, t in net.state_dict().items():     # nothing half-loaded
        assert torch.equal(t, before[k]), k


def test_seg_pretrained_through_train_unet(tmp_path, monkeypatch):
    path = str(tmp_path / "milesial.pth")
    torch.save(_randomize(TorchMilesialUNet(1, 1, f=8), 7).state_dict(),
               path)
    argv = ["--data.synthetic=true", "--data.image_size=32",
            "--data.n_train=4", "--data.n_val=2", "--data.n_test=2",
            "--model.base_features=8", "--model.compute_dtype=float32",
            f"--run.seg_pretrained={path}", f"--run.save_dir={tmp_path}",
            "--run.name=pre", "--engine.valid_step=2"]
    cfg = parse_config(argv + ["--run.device=cpu"])
    jcfg = jparse(argv)
    _, jstate = jbuild_seg_problem(jcfg)
    jstate = japply_seg_pretrained(jcfg, jstate)
    net = common.build_seg_problem(cfg, "cpu").net
    want = flax_to_state_dict(net, *jax.device_get((jstate.params,
                                                    jstate.stats)))
    for k, t in net.state_dict().items():
        assert torch.equal(t, want[k]), k
    # train_unet starts from it: record the net its first step runs on
    seen = []
    plain = train_unet.train_step

    def first_step(seg, *a, **kw):
        if not seen:
            seen.append({k: t.clone() for k, t in seg.net.state_dict().items()})
        return plain(seg, *a, **kw)

    monkeypatch.setattr(train_unet, "train_step", first_step)
    _, results = train_unet.train(cfg, train_iters=2)
    for k, t in seen[0].items():
        assert torch.equal(t, want[k]), k
    assert np.isfinite(results["log"][-1]["loss"])


def test_seg_pretrained_deeplab_backbone_keeps_the_fresh_head(tmp_path,
                                                               monkeypatch):
    trunk = _randomize(TorchDeepLabV3(n_classes=1, layers=L4), 8).backbone
    path = str(tmp_path / "resnet50.pth")
    torch.save({"state_dict": trunk.state_dict()}, path)
    monkeypatch.setattr(common, "seg_model_kwargs",
                        lambda cfg: {"layers": L4})
    cfg = parse_config(["--model.seg_model=deeplab",
                        f"--run.seg_pretrained={path}"])
    fresh = DeepLabV3(1, 1, layers=L4,
                      generator=torch.Generator().manual_seed(0))
    net = common.build_seg_problem(cfg, "cpu").net
    ported = torch_port.port_resnet50_backbone(trunk.state_dict())
    for k, t in net.state_dict().items():
        want = ported[k] if k.startswith("backbone.") else \
            fresh.state_dict()[k]
        assert torch.equal(t, want), k
