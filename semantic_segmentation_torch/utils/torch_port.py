"""Key maps from the reference's torch segmenter checkpoints onto the port's
module names — the counterpart of ``semantic_segmentation_tpu/utils/
torch_port.py``'s segmenter porters (``load_state_dict`` :18,
``port_swin_tiny`` :165, ``port_unet_milesial`` :285, the ResNet and
DeepLab maps :330-447, ``_strip_module`` :448, ``overlay_pytree`` and
``port_seg_checkpoint`` :539-581).

The port's layers hold torch's own layouts, so a map renames keys and
keeps the values (as float32); BN's ``num_batches_tracked`` and the
checkpoints' other bookkeeping have no counterpart and are dropped. Each
``port_*`` returns ``{port key: tensor}``; ``overlay`` loads such a dict,
whole or partial, onto a fresh net:

- ``deeplab``: a torchvision ``deeplabv3_resnet50`` checkpoint (its
  ``aux_classifier`` ignored; a final classifier of another class count
  dropped, so the fresh head stays) or an ImageNet ``resnet50`` one (the
  backbone only: what ``deeplab/deeplabv3.py:8`` starts from);
- ``deeplabv2``: the reference's ``deeplabv2/`` naming;
- ``vit``/``swin``/``swin_unet``: a timm/microsoft ``swin_tiny`` checkpoint,
  its encoder also copied into the mirrored decoder stages (the reference's
  ``load_from``);
- ``unet``: a milesial U-Net, transposed-conv or bilinear layout.
"""

from __future__ import annotations

import torch

_BN = ("weight", "bias", "running_mean", "running_var")
_DOUBLE_CONV = {"0": "conv0", "1": "bn0", "3": "conv1", "4": "bn1"}


def load_state_dict(path: str) -> dict:
    """A checkpoint file's tensors: a bare ``state_dict``, or one wrapped
    under ``state_dict`` or ``model`` (timm's files)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    return sd


def _strip_module(sd: dict) -> dict:
    """Drop the ``module.`` prefix of a DataParallel-wrapped save."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _take(sd: dict, keys: dict) -> dict:
    """{dst: sd[src] as float32} for the {src: dst} map ``keys``; a
    missing source key raises KeyError."""
    return {dst: torch.as_tensor(sd[src]).float() for src, dst in keys.items()}


def _bn(src: str, dst: str) -> dict:
    return {f"{src}.{leaf}": f"{dst}.{leaf}" for leaf in _BN}


def _resnet_keys(sd: dict, prefix: str, layers, dst: str = "") -> dict:
    """The torch ResNet (``conv1``/``bn1``/``layer{L}.{B}.conv{1,2,3}``,
    ``bn{1,2,3}``, ``downsample.{0,1}``) -> the port's ``stem``/
    ``stem_bn``/``layer{L}_{B}.*``/``down_conv``/``down_bn``; shared by
    torchvision's resnet50 and the deeplabv2 backbone (dilations are
    architectural, not stored)."""
    keys = {f"{prefix}conv1.weight": f"{dst}stem.weight",
            **_bn(f"{prefix}bn1", f"{dst}stem_bn")}
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            src, out = f"{prefix}layer{li + 1}.{bi}", f"{dst}layer{li + 1}_{bi}"
            for ci in (1, 2, 3):
                keys[f"{src}.conv{ci}.weight"] = f"{out}.conv{ci}.weight"
                keys.update(_bn(f"{src}.bn{ci}", f"{out}.bn{ci}"))
            if f"{src}.downsample.0.weight" in sd:
                keys[f"{src}.downsample.0.weight"] = f"{out}.down_conv.weight"
                keys.update(_bn(f"{src}.downsample.1", f"{out}.down_bn"))
    return keys


def _infer_resnet_layers(sd: dict, prefix: str, stages=(1, 2, 3, 4)):
    """Blocks per stage, read off the keys."""
    return tuple(
        1 + max(int(k[len(f"{prefix}layer{li}."):].split(".")[0])
                for k in sd if k.startswith(f"{prefix}layer{li}."))
        for li in stages)


def port_resnet50_backbone(sd: dict) -> dict:
    """A torchvision ImageNet ``resnet50`` checkpoint (``fc`` ignored) ->
    the ``backbone.*`` of ``models/deeplab.DeepLabV3``."""
    sd = _strip_module(sd)
    return _take(sd, _resnet_keys(sd, "", _infer_resnet_layers(sd, ""),
                                  "backbone."))


def port_deeplabv3(sd: dict, n_classes: int | None = None) -> dict:
    """A torchvision ``deeplabv3_resnet50`` checkpoint -> ``DeepLabV3``:
    ``backbone.*`` keeps resnet names; ``classifier`` is DeepLabHead =
    (ASPP, 3x3, BN, ReLU, 1x1), its ASPP ``convs.0`` 1x1 + BN,
    ``convs.1-3`` the dilated 3x3s + BN, ``convs.4`` the pooling branch
    (conv .1, BN .2) and ``project`` 1x1 + BN. The final 1x1 is left out
    when ``n_classes`` differs from its class count."""
    sd = _strip_module(sd)
    keys = _resnet_keys(sd, "backbone.",
                        _infer_resnet_layers(sd, "backbone."), "backbone.")
    aspp = "classifier.0"
    for i in range(4):
        keys[f"{aspp}.convs.{i}.0.weight"] = f"aspp.b{i}_conv.weight"
        keys.update(_bn(f"{aspp}.convs.{i}.1", f"aspp.b{i}_bn"))
    keys[f"{aspp}.convs.4.1.weight"] = "aspp.pool_conv.weight"
    keys.update(_bn(f"{aspp}.convs.4.2", "aspp.pool_bn"))
    keys[f"{aspp}.project.0.weight"] = "aspp.proj_conv.weight"
    keys.update(_bn(f"{aspp}.project.1", "aspp.proj_bn"))
    keys["classifier.1.weight"] = "head_conv.weight"
    keys.update(_bn("classifier.2", "head_bn"))
    if n_classes is None or sd["classifier.4.weight"].shape[0] == n_classes:
        keys["classifier.4.weight"] = "classifier.weight"
        keys["classifier.4.bias"] = "classifier.bias"
    return _take(sd, keys)


def port_deeplabv2(sd: dict) -> dict:
    """The reference's ``deeplabv2/`` checkpoint (``backbone.*`` with the
    3-block multi-grid layer4, ``classifier.conv2d_list.{i}``) ->
    ``DeepLabV2``."""
    sd = _strip_module(sd)
    layers = _infer_resnet_layers(sd, "backbone.", (1, 2, 3)) + (3,)
    keys = _resnet_keys(sd, "backbone.", layers, "backbone.")
    for i in range(4):
        for leaf in ("weight", "bias"):
            keys[f"classifier.conv2d_list.{i}.{leaf}"] = \
                f"classifier.conv{i}.{leaf}"
    return _take(sd, keys)


def port_swin_tiny(sd: dict, depths=(2, 2, 2, 2),
                   depths_decoder=(1, 2, 2, 2)) -> dict:
    """A timm/microsoft ``swin_tiny_patch4_window7_224`` checkpoint ->
    ``SwinUnet``, as the reference's ``load_from``
    (``swin_unet/vision_transformer.py:54+``): the encoder loads, and its
    stage ``i`` also fills the decoder stage that mirrors it; heads and
    skip projections keep their init."""
    keys = {"patch_embed.proj.weight": "patch_embed.weight",
            "patch_embed.proj.bias": "patch_embed.bias",
            "patch_embed.norm.weight": "embed_norm.weight",
            "patch_embed.norm.bias": "embed_norm.bias"}
    leaves = {"norm1": "norm1", "norm2": "norm2", "attn.qkv": "attn.qkv",
              "attn.proj": "attn.proj", "mlp.fc1": "mlp_fc1",
              "mlp.fc2": "mlp_fc2"}

    def block(src: str, dst: str):
        out = {f"{src}.attn.relative_position_bias_table":
               f"{dst}.attn.rel_pos_bias"}
        for s, d in leaves.items():
            out.update({f"{src}.{s}.{leaf}": f"{dst}.{d}.{leaf}"
                        for leaf in ("weight", "bias")})
        return out

    nl = len(depths)
    pairs = []       # (src key, dst key)
    for li in range(nl):
        for bi in range(depths[li]):
            pairs += block(f"layers.{li}.blocks.{bi}",
                           f"enc{li}_blk{bi}").items()
        if li < nl - 1:
            ds = f"layers.{li}.downsample"
            pairs += [(f"{ds}.norm.weight", f"merge{li}.norm.weight"),
                      (f"{ds}.norm.bias", f"merge{li}.norm.bias"),
                      (f"{ds}.reduction.weight",
                       f"merge{li}.reduction.weight")]
    # the decoder's stage li mirrors encoder stage nl - 2 - li
    for li in range(nl - 1):
        src = nl - 2 - li
        for dbi in range(depths_decoder[src]):
            sbi = min(dbi, depths[src] - 1)
            pairs += block(f"layers.{src}.blocks.{sbi}",
                           f"dec{li}_blk{dbi}").items()
    if "norm.weight" in sd:
        pairs += [("norm.weight", "bottleneck_norm.weight"),
                  ("norm.bias", "bottleneck_norm.bias")]
    out = _take(sd, keys)
    out.update({dst: torch.as_tensor(sd[src]).float() for src, dst in pairs})
    return out


def is_milesial(sd: dict) -> bool:
    return "inc.double_conv.0.weight" in sd


def milesial_is_bilinear(sd: dict) -> bool:
    """The bilinear-upsampling layout has no ``up{i}.up`` weights."""
    return "up1.up.weight" not in sd


def milesial_key_map(sd: dict) -> dict:
    """{reference key: port key} for a milesial U-Net (``inc.double_conv.
    {0,1,3,4}`` = conv, BN, conv, BN; ``down{i}.maxpool_conv.1.
    double_conv.*``; ``up{i}.up.*``, the k2-s2 transposed conv, absent in
    the bilinear layout; ``up{i}.conv.double_conv.*``; ``outc.conv.*``)."""
    blocks = {"inc.double_conv": "inc"}
    for i in range(1, 5):
        blocks[f"down{i}.maxpool_conv.1.double_conv"] = f"down{i}.conv"
        blocks[f"up{i}.conv.double_conv"] = f"up{i}.conv"
    keys = {}
    for src, dst in blocks.items():
        for idx, layer in _DOUBLE_CONV.items():
            leaves = ("weight",) if layer.startswith("conv") else _BN
            for leaf in leaves:
                keys[f"{src}.{idx}.{leaf}"] = f"{dst}.{layer}.{leaf}"
    if not milesial_is_bilinear(sd):
        for i in range(1, 5):
            for leaf in ("weight", "bias"):
                keys[f"up{i}.up.{leaf}"] = f"up{i}.up.{leaf}"
    for leaf in ("weight", "bias"):
        keys[f"outc.conv.{leaf}"] = f"outc.{leaf}"
    return keys


def port_unet_milesial(sd: dict) -> dict:
    """A milesial U-Net checkpoint -> ``models/unet.UNet``."""
    sd = _strip_module(sd)
    return _take(sd, milesial_key_map(sd))


def load_milesial(net: torch.nn.Module, sd: dict):
    """Load a milesial checkpoint into the port's ``UNet`` (strict). The
    layout must be the net's: transposed-conv ups, or bilinear with
    ``model.bilinear``. The bilinear net's DoubleConv mid width is half the
    upsampled input's channels, as in the JAX package; milesial's
    published ``Up`` takes half the concatenated input's, which fits
    neither package."""
    bilinear = milesial_is_bilinear(sd)
    if bilinear != net.bilinear:
        kind = ("bilinear-upsampling" if bilinear else "transposed-conv")
        raise ValueError(f"the state dict is the {kind} variant of the "
                         f"milesial U-Net; the net has "
                         f"model.bilinear={net.bilinear}")
    net.load_state_dict(port_unet_milesial(sd))
    return net


def overlay(net: torch.nn.Module, ported: dict):
    """Copy ``ported`` ({port key: tensor}) into ``net`` in place; the keys
    it lacks keep their fresh init (the JAX package's ``overlay_pytree``).
    A key the net does not have, or a shape that differs, is an error."""
    own = net.state_dict()
    unknown = sorted(set(ported) - set(own))
    if unknown:
        raise ValueError(f"the checkpoint maps onto keys the net lacks: "
                         f"{unknown[:5]}{' ...' if len(unknown) > 5 else ''}")
    bad = [(k, tuple(v.shape), tuple(own[k].shape))
           for k, v in ported.items() if v.shape != own[k].shape]
    if bad:
        raise ValueError(f"shapes differ (key, checkpoint, net): {bad[:5]}")
    with torch.no_grad():
        for k, v in ported.items():
            own[k].copy_(v)
    return net


def port_seg_checkpoint(seg_model: str, sd: dict, n_classes: int = 1) -> dict:
    """The map of ``seg_model``'s checkpoint family, chosen by its keys."""
    sd = _strip_module(sd)
    if seg_model == "deeplab":
        if "classifier.0.convs.0.0.weight" in sd:
            return port_deeplabv3(sd, n_classes)
        if "conv1.weight" in sd:
            return port_resnet50_backbone(sd)
        raise KeyError("unrecognized deeplab checkpoint naming (need "
                       "torchvision deeplabv3_resnet50 or resnet50 keys)")
    if seg_model in ("vit", "swin", "swin_unet"):
        if isinstance(sd.get("model"), dict):    # vision_transformer.py:58
            sd = sd["model"]
        return port_swin_tiny(sd)
    if seg_model == "unet":
        return port_unet_milesial(sd)
    if seg_model == "deeplabv2":
        return port_deeplabv2(sd)
    raise NotImplementedError(f"seg_pretrained for seg_model={seg_model!r}")
