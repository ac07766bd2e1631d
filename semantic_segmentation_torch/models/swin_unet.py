"""Swin-UNet, the ``--seg_model vit`` segmenter — the port of
``semantic_segmentation_tpu/models/swin_unet.py``: a Swin-Tiny encoder and a
symmetric Swin decoder with patch-expanding upsampling and skip connections
(``swin_unet/swin_transformer_unet_skip_expand_decoder_sys.py``:
WindowAttention :63, SwinTransformerBlock :169, PatchMerging :309,
PatchExpand :358, FinalPatchExpand_X4 :385, SwinTransformerSys :599-804) at
the reference's lite config (img 224, patch 4, window 7, embed 96, depths
[2,2,2,2], decoder depths [1,2,2,2], heads [3,6,12,24], drop-path 0.2).

Where PyTorch's defaults differ from flax's, the flax ones are kept:
LayerNorm eps 1e-6, GELU in its tanh form, the attention softmax in
float32 whatever the autocast dtype, and lecun-normal init. Attention is
the plain ``q @ k^T + bias (+ mask) -> softmax -> @ v`` the JAX package
computes with einsum.

Submodule names are the flax ones (``patch_embed``, ``enc{s}_blk{b}``,
``merge{s}``, ``expand{s}``, ``skip_proj{s}``, ``dec{s}_blk{b}``,
``final_expand``, ``output``; ``norm1``/``attn``/``mlp_fc1``... inside a
block), so the weight bridge maps the trees leaf by leaf.

Stochastic depth: in train mode each block with a non-zero rate drops its
attention and MLP branches per sample. The keep-masks are drawn for the
whole net before the forward (``draw_drop_path``) or passed in (the tests
inject the JAX package's draws), so a block recomputed under
``use_checkpoint`` sees the same masks: checkpoint's RNG replay covers the
global generator only, not an explicit ``torch.Generator``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import checkpointed, lecun_normal_
from semantic_segmentation_torch.parallel import collectives

LN_EPS = 1e-6        # flax LayerNorm's epsilon


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * H//ws * W//ws, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))            # (2, ws, ws)
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The SW-MSA mask (reference :232-247): -100 on the pairs of a window
    that straddle the cyclic shift's regions. (nW, ws*ws, ws*ws)."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    b, _, _, c = img.shape
    mw = img.reshape(b, h // ws, ws, w // ws, ws, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _index_on(ws: int, device: torch.device):
    return torch.from_numpy(_relative_position_index(ws).reshape(-1)).to(
        device)


@functools.lru_cache(maxsize=64)
def _mask_on(h: int, w: int, ws: int, shift: int, device: torch.device):
    return torch.from_numpy(_shift_attn_mask(h, w, ws, shift)).to(device)


def drop_path(x, keep_mask, rate: float):
    """Stochastic depth (timm DropPath, reference :209-210): per-sample
    keep mask (B,) bool, kept samples scaled by 1 / (1 - rate); under data
    parallelism the global batch's mask, of which this rank takes its
    rows."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep_mask = collectives.rows(keep_mask, x.shape[0])
    return x / keep * keep_mask.reshape(shape).to(x.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, \
            window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        bnw, n, c = x.shape
        h = self.num_heads
        hd = self.dim // h
        qkv = self.qkv(x).reshape(bnw, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        idx = _index_on(self.window_size, x.device)
        bias = self.rel_pos_bias[idx].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bnw // nw, nw, h, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(
                        bnw, h, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """W-MSA or SW-MSA, then the MLP, each a residual branch with its own
    stochastic depth at ``drop_path_rate``."""

    def __init__(self, dim: int, num_heads: int, input_resolution: tuple,
                 window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        hh, ww = input_resolution
        ws = min(window_size, min(hh, ww))
        shift = 0 if ws == min(hh, ww) and shift_size >= min(hh, ww) \
            else shift_size
        if min(hh, ww) <= window_size:
            ws, shift = min(hh, ww), 0
        self.resolution, self.ws, self.shift = (hh, ww), ws, shift
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, keep=None):
        """``keep``: (2, B) bool keep-masks of the attention and MLP
        branches, or None for no stochastic depth."""
        hh, ww = self.resolution
        ws, shift = self.ws, self.shift
        b, n, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, hh, ww, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _mask_on(hh, ww, ws, shift, x.device) if shift > 0 else None
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, hh,
                           ww)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = x.reshape(b, n, c)
        if keep is not None:
            x = drop_path(x, keep[0], self.drop_path_rate)
        x = shortcut + x
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)),
                                approximate="tanh"))
        if keep is not None:
            y = drop_path(y, keep[1], self.drop_path_rate)
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, input_resolution: tuple, dim: int):
        super().__init__()
        self.resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        hh, ww = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, hh, ww, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (hh // 2) * (ww // 2), 4 * c)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """x2 upsampling: a linear to 2C, then its channels laid out as 2x2
    pixels of C/2."""

    def __init__(self, input_resolution: tuple, dim: int, scale: int = 2):
        super().__init__()
        self.resolution, self.scale = input_resolution, scale
        out = dim // 2 if scale == 2 else dim
        self.expand = nn.Linear(dim, scale * scale * out, bias=False)
        self.norm = nn.LayerNorm(out, eps=LN_EPS)

    def forward(self, x):
        hh, ww = self.resolution
        s = self.scale
        b, n, _ = x.shape
        x = self.expand(x)
        c = x.shape[-1] // (s * s)
        x = x.reshape(b, hh, ww, s, s, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(b, s * s * n, c))


class FinalPatchExpandX4(PatchExpand):
    """x4 upsampling to the input resolution, C channels kept."""

    def __init__(self, input_resolution: tuple, dim: int):
        super().__init__(input_resolution, dim, scale=4)


class SwinUnet(nn.Module):
    """SwinTransformerSys (:599-804). NCHW in, NCHW float32 logits out."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 img_size: int = 224, patch_size: int = 4,
                 embed_dim: int = 96, depths: tuple = (2, 2, 2, 2),
                 depths_decoder: tuple = (1, 2, 2, 2),
                 num_heads: tuple = (3, 6, 12, 24), window_size: int = 7,
                 drop_path_rate: float = 0.2, use_checkpoint: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.img_size, self.patch_size = img_size, patch_size
        self.depths, self.drop_path_rate = tuple(depths), drop_path_rate
        self.use_checkpoint = use_checkpoint
        nl = len(depths)
        # a 1-channel input is broadcast to 3 (:248-249)
        c_in = 3 if n_channels == 1 else n_channels
        self.patch_embed = nn.Conv2d(c_in, embed_dim, patch_size, patch_size)
        self.embed_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        res, dim = img_size // patch_size, embed_dim
        # block names per stage, in forward order
        self.enc_blocks, self.dec_blocks = [], []
        for li, depth in enumerate(depths):
            self.enc_blocks.append([self._add_block(
                f"enc{li}_blk{bi}", dim, num_heads[li], res, window_size, bi,
                self._dpr(li, bi)) for bi in range(depth)])
            if li < nl - 1:
                self.add_module(f"merge{li}", PatchMerging((res, res), dim))
                res, dim = res // 2, dim * 2
        self.bottleneck_norm = nn.LayerNorm(dim, eps=LN_EPS)
        for li in range(nl - 1):
            self.add_module(f"expand{li}", PatchExpand((res, res), dim))
            res, dim = res * 2, dim // 2
            self.add_module(f"skip_proj{li}", nn.Linear(2 * dim, dim))
            stage = nl - 2 - li
            self.dec_blocks.append([self._add_block(
                f"dec{li}_blk{bi}", dim, num_heads[stage], res, window_size,
                bi, self._dpr(stage, bi))
                for bi in range(depths_decoder[stage])])
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.final_expand = FinalPatchExpandX4((res, res), dim)
        self.output = nn.Conv2d(dim, n_classes, 1, bias=False)
        self._init(generator)

    def _add_block(self, name, dim, heads, res, window_size, bi, rate):
        """A block, shifted at odd ``bi``; returns its name."""
        self.add_module(name, SwinBlock(
            dim, heads, (res, res), window_size,
            0 if bi % 2 == 0 else window_size // 2, drop_path_rate=rate))
        return name

    def _dpr(self, stage: int, block: int) -> float:
        """linspace(0, drop_path_rate, sum(depths)) indexed by encoder
        stage and block; a decoder block reads its stage's entry."""
        table = np.linspace(0.0, self.drop_path_rate, sum(self.depths))
        return float(table[sum(self.depths[:stage]) + block])

    def _init(self, generator):
        """flax's defaults: lecun-normal kernels, zero biases, unit
        LayerNorm scales; the relative-position tables N(0, 0.02) truncated
        at two standard deviations."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, WindowAttention):
                    nn.init.trunc_normal_(m.rel_pos_bias, 0.0, 0.02, -0.04,
                                          0.04, generator=generator)

    def stochastic_blocks(self) -> list[str]:
        """The blocks that drop paths in train mode, in forward order."""
        return [n for stage in self.enc_blocks + self.dec_blocks
                for n in stage if getattr(self, n).drop_path_rate > 0.0]

    def draw_drop_path(self, batch: int, generator=None, device=None):
        """{block: (2, batch) bool keep-masks} for every stochastic block,
        drawn from ``generator`` on ``device`` (for the global batch under
        data parallelism)."""
        batch = collectives.global_batch(batch)
        return {n: torch.rand(2, batch, generator=generator, device=device)
                < 1.0 - getattr(self, n).drop_path_rate
                for n in self.stochastic_blocks()}

    def _run(self, name, x, masks):
        keep = masks.get(name) if masks is not None else None
        block = getattr(self, name)
        if self.use_checkpoint:
            return checkpointed(block, x, keep)
        return block(x, keep)

    def forward(self, x, drop_masks=None,
                generator: torch.Generator | None = None):
        """``drop_masks`` ({block: (2, B) bool}) replaces the train-mode
        draw from ``generator``."""
        b, c, H, W = x.shape
        if c == 1:
            x = x.expand(b, 3, H, W)
        masks = None
        if self.training and self.stochastic_blocks():
            masks = (drop_masks if drop_masks is not None else
                     self.draw_drop_path(b, generator, x.device))
        x = self.patch_embed(x)
        x = self.embed_norm(x.permute(0, 2, 3, 1).reshape(b, -1, x.shape[1]))
        nl = len(self.depths)
        skips = []
        for li in range(nl):
            for name in self.enc_blocks[li]:
                x = self._run(name, x, masks)
            skips.append(x)
            if li < nl - 1:
                x = getattr(self, f"merge{li}")(x)
        x = self.bottleneck_norm(x)
        for li in range(nl - 1):
            x = getattr(self, f"expand{li}")(x)
            skip = skips[nl - 2 - li]
            x = getattr(self, f"skip_proj{li}")(
                torch.cat([x, skip.to(x.dtype)], dim=-1))
            for name in self.dec_blocks[li]:
                x = self._run(name, x, masks)
        x = self.final_expand(self.final_norm(x))
        x = x.reshape(b, H, W, -1).permute(0, 3, 1, 2)
        return self.output(x).float()
