"""Key map from the reference's milesial U-Net ``state_dict`` to the port's
``models/unet.UNet`` — the counterpart of
``semantic_segmentation_tpu/utils/torch_port.port_unet_milesial``.

The reference (``unet/unet_model.py``, ``unet/unet_parts.py``) names its
layers ``inc.double_conv.{0,1,3,4}`` (conv, BN, conv, BN; 2 and 5 are the
ReLUs), ``down{i}.maxpool_conv.1.double_conv.*``, ``up{i}.up.*`` (the k2-s2
transposed conv), ``up{i}.conv.double_conv.*`` and ``outc.conv.*``. The
port's layers are torch's own conv layouts, so the map renames keys and
keeps the values; BN's ``num_batches_tracked`` has no counterpart and is
dropped. The port's U-Net has transposed-conv ups only: a bilinear-variant
state dict (no ``up{i}.up.weight``) is refused.
"""

from __future__ import annotations

import torch

_DOUBLE_CONV = {"0": "conv0", "1": "bn0", "3": "conv1", "4": "bn1"}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def is_milesial(state_dict: dict) -> bool:
    return "inc.double_conv.0.weight" in state_dict


def milesial_key_map(state_dict: dict) -> dict:
    """{reference key: port key} for every tensor the port's UNet holds."""
    missing_up = [f"up{i}.up.weight" for i in range(1, 5)
                  if f"up{i}.up.weight" not in state_dict]
    if missing_up:
        raise ValueError(
            f"the state dict has no {missing_up}: it is the "
            "bilinear-upsampling variant of the milesial U-Net, and the "
            "port's UNet has transposed-conv ups only")
    blocks = {"inc.double_conv": "inc"}
    for i in range(1, 5):
        blocks[f"down{i}.maxpool_conv.1.double_conv"] = f"down{i}.conv"
        blocks[f"up{i}.conv.double_conv"] = f"up{i}.conv"
    keys = {}
    for src, dst in blocks.items():
        for idx, layer in _DOUBLE_CONV.items():
            leaves = ("weight",) if layer.startswith("conv") else _BN_LEAVES
            for leaf in leaves:
                keys[f"{src}.{idx}.{leaf}"] = f"{dst}.{layer}.{leaf}"
    for i in range(1, 5):
        for leaf in ("weight", "bias"):
            keys[f"up{i}.up.{leaf}"] = f"up{i}.up.{leaf}"
    for leaf in ("weight", "bias"):
        keys[f"outc.conv.{leaf}"] = f"outc.{leaf}"
    return keys


def port_unet_milesial(state_dict: dict) -> dict:
    """The port UNet's ``state_dict`` holding a reference milesial one's
    tensors (float32)."""
    return {dst: torch.as_tensor(state_dict[src]).float()
            for src, dst in milesial_key_map(state_dict).items()}
