"""Weight bridge between the JAX package's parameter/stat pytrees (nested
dicts of numpy arrays) and the port's ``state_dict``s.

The port's modules use the JAX package's submodule names, except flax's
auto-names inside the U-Net's Down/Up blocks (``RENAME``). Leaves convert by
the kind of port module that owns them:

- conv kernels (``nn.Conv2d``/``nn.Conv3d``, ``MixedConv``'s forward
  ``kernel_*``): HWIO <-> OIHW, DHWIO <-> OIDHW;
- transposed convs (``nn.ConvTranspose2d``/``3d``, ``MixedConvTranspose``):
  the JAX package stores the forward-equivalent kernel, spatially flipped
  on every spatial axis, in (H)WIO / DHWIO (``ops/conv.py:5-10``); torch
  stores (C_in, C_out, k, ...) unflipped;
- ``BatchNorm2d`` (any rank): scale/bias <-> weight/bias, stats mean/var
  <-> running_mean/running_var; ``InstanceNorm`` has no leaves;
- ``nn.Linear`` (flax ``Dense``) kernel: (in, out) <-> (out, in);
- ``nn.LayerNorm`` and the denoiser's flax-rule ``GroupNorm``: scale/bias
  <-> weight/bias;
- any other leaf (the Swin's ``rel_pos_bias`` table) as it is.

The arch dict ({'conv', 'upconv'} tables) converts as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from semantic_segmentation_torch.models.diffusion.adm_unet import GroupNorm
from semantic_segmentation_torch.ops.layers import BatchNorm2d
from semantic_segmentation_torch.ops.nas import MixedConvTranspose

RENAME = {"DoubleConv_0": "conv", "TorchConvTranspose_0": "up"}
_UNRENAME = {v: k for k, v in RENAME.items()}
_TRANSPOSED = (nn.ConvTranspose2d, nn.ConvTranspose3d, MixedConvTranspose)
_KERNEL_RANKS = (4, 5)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _owner(module: nn.Module, key: str):
    path = key.rpartition(".")[0]
    return module.get_submodule(path) if path else module


def _flip_spatial(w, nsp: int):
    """``w`` reversed on its trailing ``nsp`` (spatial) axes."""
    return w[(Ellipsis,) + (slice(None, None, -1),) * nsp]


def _kernel_to_torch(k, transposed: bool):
    nsp = k.ndim - 2
    spatial = tuple(range(nsp))
    if transposed:
        return np.ascontiguousarray(_flip_spatial(
            k.transpose((nsp, nsp + 1) + spatial), nsp))
    return np.ascontiguousarray(k.transpose((nsp + 1, nsp) + spatial))


def _kernel_to_flax(w, transposed: bool):
    nsp = w.ndim - 2
    spatial = tuple(range(2, 2 + nsp))
    if transposed:
        return np.ascontiguousarray(
            _flip_spatial(w, nsp).transpose(spatial + (0, 1)))
    return np.ascontiguousarray(w.transpose(spatial + (1, 0)))


def flax_to_state_dict(module: nn.Module, params: dict,
                       stats: dict | None = None) -> dict:
    """The state_dict of ``module`` holding the JAX package's ``params``
    (and BN ``stats``)."""
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}
    sd = {}
    for tree in (params, stats or {}):
        for path, leaf in _flatten(tree):
            key = ".".join([RENAME.get(p, p) for p in path[:-1]]
                           + [leaf_names.get(path[-1], path[-1])])
            arr = np.asarray(leaf, np.float32)
            if arr.ndim in _KERNEL_RANKS:
                arr = _kernel_to_torch(
                    arr, isinstance(_owner(module, key), _TRANSPOSED))
            elif arr.ndim == 2 and path[-1] == "kernel":
                arr = np.ascontiguousarray(arr.T)
            sd[key] = torch.from_numpy(arr.copy())
    return sd


def state_dict_to_flax(module: nn.Module, state_dict: dict):
    """(params, stats) nested numpy dicts in the JAX package's layout."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        owner = _owner(module, key)
        arr = t.detach().cpu().numpy()
        tree = params
        if isinstance(owner, BatchNorm2d):
            leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                    "running_var": "var"}[leaf]
            tree = stats if leaf in ("mean", "var") else params
        elif isinstance(owner, (nn.LayerNorm, GroupNorm)):
            leaf = {"weight": "scale", "bias": "bias"}[leaf]
        elif leaf == "weight":
            leaf = "kernel"
            if isinstance(owner, nn.Linear):
                arr = np.ascontiguousarray(arr.T)
        if arr.ndim in _KERNEL_RANKS:
            arr = _kernel_to_flax(arr, isinstance(owner, _TRANSPOSED))
        node = tree
        for m in mods:
            node = node.setdefault(_UNRENAME.get(m, m), {})
        node[leaf] = arr
    return params, stats


def load_flax(module: nn.Module, params: dict, stats: dict | None = None):
    """Load the JAX package's params/stats into ``module`` (strict)."""
    sd = flax_to_state_dict(module, params, stats)
    ref = module.state_dict()
    module.load_state_dict({k: v.to(ref[k].device) for k, v in sd.items()},
                           strict=True)
    return module


def arch_to_torch(arch: dict, device=None) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arch.items()}


def arch_to_flax(arch: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in arch.items()}


def load_sivae_flax(vae: nn.Module, variables: dict):
    """Load the JAX package's ``SoftIntroVAE`` variables ({'enc': {'params',
    'batch_stats'}, 'dec': {'params'[, 'batch_stats']}, 'arch'}, numpy)
    into the port's ``models/vae/sivae.SoftIntroVAE``: the encoder, the
    decoder and the arch table."""
    for part, net in (("enc", vae.encoder), ("dec", vae.decoder)):
        v = variables[part]
        load_flax(net, v["params"], v.get("batch_stats", {}))
    with torch.no_grad():
        vae.arch.copy_(torch.from_numpy(np.asarray(variables["arch"],
                                                   np.float32)))
    return vae


def _vqgan_module_key(side: str, name: str) -> str:
    """The port's (taming's) module path of the JAX ``VQModel`` submodule
    ``name`` of ``side`` ('encoder'/'decoder'): ``down{i}_block{j}`` ->
    ``down.{i}.block.{j}``, ``down{i}_conv`` -> ``down.{i}.downsample.conv``
    (``up...`` likewise with ``upsample``), ``mid_block1``/``mid_attn``/
    ``mid_block2`` -> ``mid.block_1``/``mid.attn_1``/``mid.block_2``."""
    mid = {"mid_block1": "mid.block_1", "mid_attn": "mid.attn_1",
           "mid_block2": "mid.block_2"}
    if name in mid:
        return f"{side}.{mid[name]}"
    for kind, resample in (("down", "downsample"), ("up", "upsample")):
        if name.startswith(kind) and name[len(kind)].isdigit():
            level, _, rest = name[len(kind):].partition("_")
            if rest == "conv":
                return f"{side}.{kind}.{level}.{resample}.conv"
            return f"{side}.{kind}.{level}.block.{rest[len('block'):]}"
    return f"{side}.{name}"



def _vqgan_key(path) -> str:
    """The port key of the JAX ``VQModel`` params leaf at ``path``."""
    if path[0] == "quantize":
        return "quantize.embedding.weight"
    if path[0] in ("encoder", "decoder"):
        mod = [_vqgan_module_key(path[0], path[1])] + list(path[2:-1])
    else:
        mod = list(path[:-1])
    return ".".join(mod + ["bias" if path[-1] == "bias" else "weight"])


def vqgan_flax_to_state_dict(params: dict) -> dict:
    """The state_dict of the port's ``models/diffusion/vqgan.VQModel``
    holding the JAX package's ``VQModel`` params: conv kernels HWIO ->
    OIHW, the attention's ``Dense`` kernels (I, O) -> 1x1 convs
    (O, I, 1, 1), GroupNorm scale -> weight, the codebook as it is."""
    sd = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            arr = (arr.T[:, :, None, None] if arr.ndim == 2
                   else _kernel_to_torch(arr, False))
        sd[_vqgan_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def vqgan_state_dict_to_flax(params_template: dict, state_dict: dict) -> dict:
    """The inverse of ``vqgan_flax_to_state_dict`` in the layout of
    ``params_template`` (a JAX ``VQModel`` params tree, or its shapes): the
    port's tensors (weights, or their gradients) as numpy leaves."""
    out: dict = {}
    for path, leaf in _flatten(params_template):
        t = state_dict[_vqgan_key(path)].detach().cpu().float().numpy()
        if path[-1] == "kernel":
            t = t[:, :, 0, 0].T if len(leaf.shape) == 2 else \
                t.transpose(2, 3, 1, 0)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(t)
    return out


def load_vqgan_flax(vq: nn.Module, params: dict):
    """Load the JAX package's ``VQModel`` params into the port's
    ``VQModel`` (strict)."""
    sd = vqgan_flax_to_state_dict(params)
    ref = vq.state_dict()
    vq.load_state_dict({k: v.to(ref[k].device) for k, v in sd.items()},
                       strict=True)
    return vq
