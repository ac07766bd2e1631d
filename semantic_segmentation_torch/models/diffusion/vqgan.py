"""The VQGAN first stage of latent BBDM — the port of
``semantic_segmentation_tpu/models/diffusion/vqgan.py`` (taming's
``VQModel``, ``BBDM/model/VQGAN/vqgan.py`` and ``model.py``), NCHW.

conv stem -> per level ResnetBlocks and a stride-2 downsample conv after an
asymmetric (0, 1) pad -> mid (ResnetBlock, attention, ResnetBlock) ->
GroupNorm + swish -> conv_out -> ``quant_conv`` 1x1 -> ``VectorQuantizer``
(the nearest codebook entry, the straight-through estimator, the codebook
and commitment losses) -> ``post_quant_conv`` 1x1 -> the mirrored decoder
with nearest 2x upsampling.

Submodules carry taming's names (``encoder.down.{i}.block.{j}``,
``encoder.down.{i}.downsample.conv``, ``encoder.mid.block_1``/``attn_1``/
``block_2``, ``decoder.up.{i}.block.{j}``, ``decoder.up.{i}.upsample.conv``,
``quantize.embedding``, ``quant_conv``, ``post_quant_conv``), so a reference
checkpoint's ``state_dict`` loads strictly once its ``loss.*`` keys are
dropped (``utils/torch_port.port_vqgan``). The attention's q/k/v/proj_out
are 1x1 convs, as in taming (the JAX package holds them as ``Dense``; the
bridge reshapes). GroupNorm is the flax rule of the port's ADM denoiser
(32 groups, or the largest divisor of the channels under that; statistics
in float32, a float32 output) at eps 1e-6.

Initialization follows the JAX package's laws: LeCun-normal kernels, zero
biases, and the codebook uniform on [0, 2 / n_embed) (flax's
``uniform(scale=2/n)``; taming draws U(-1/n, 1/n)).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.models.diffusion.adm_unet import GroupNorm
from semantic_segmentation_torch.ops.layers import lecun_normal_


def _gn(channels: int) -> GroupNorm:
    return GroupNorm(channels, eps=1e-6)


def _conv(c_in: int, c_out: int, k: int = 3, stride: int = 1,
          padding: int | None = None) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride,
                     k // 2 if padding is None else padding)


def swish(x):
    return x * torch.sigmoid(x)


class _Level(nn.Module):
    """One encoder or decoder level: ``block`` (a list) and its resampling
    conv under ``downsample``/``upsample``."""


class _Resample(nn.Module):
    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = _conv(channels, channels, 3, stride,
                          0 if stride == 2 else 1)


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm1 = _gn(c_in)
        self.conv1 = _conv(c_in, c_out)
        self.norm2 = _gn(c_out)
        self.conv2 = _conv(c_out, c_out)
        if c_in != c_out:
            self.nin_shortcut = _conv(c_in, c_out, 1)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x.to(h.dtype) + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the positions, its softmax in
    float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _gn(channels)
        self.q = _conv(channels, channels, 1)
        self.k = _conv(channels, channels, 1)
        self.v = _conv(channels, channels, 1)
        self.proj_out = _conv(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q = self.q(y).reshape(b, c, h * w)
        k = self.k(y).reshape(b, c, h * w)
        v = self.v(y).reshape(b, c, h * w)
        attn = torch.softmax(torch.einsum("bci,bcj->bij", q, k).float()
                             * c ** -0.5, dim=-1).to(v.dtype)
        out = torch.einsum("bij,bcj->bci", attn, v).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, in_channels: int, ch: int = 128, ch_mult=(1, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 3):
        super().__init__()
        self.conv_in = _conv(in_channels, ch)
        self.down = nn.ModuleList()
        c = ch
        for li, mult in enumerate(ch_mult):
            lvl = _Level()
            lvl.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                lvl.block.append(ResnetBlock(c, ch * mult))
                c = ch * mult
            if li < len(ch_mult) - 1:
                lvl.downsample = _Resample(c, 2)
            self.down.append(lvl)
        self.mid = _Mid(c)
        self.norm_out = _gn(c)
        self.conv_out = _conv(c, z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for lvl in self.down:
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "downsample"):
                # taming's downsample: pad (0, 1) on both spatial axes, then
                # the unpadded stride-2 conv
                h = lvl.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, out_channels: int, ch: int = 128, ch_mult=(1, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 3):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = _conv(z_channels, c)
        self.mid = _Mid(c)
        levels = [None] * len(ch_mult)
        for li in reversed(range(len(ch_mult))):
            lvl = _Level()
            lvl.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                lvl.block.append(ResnetBlock(c, ch * ch_mult[li]))
                c = ch * ch_mult[li]
            if li > 0:
                lvl.upsample = _Resample(c, 1)
            levels[li] = lvl
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(c)
        self.conv_out = _conv(c, out_channels)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for li in reversed(range(len(self.up))):
            lvl = self.up[li]
            for blk in lvl.block:
                h = blk(h)
            if li > 0:
                h = lvl.upsample.conv(F.interpolate(h, scale_factor=2.0,
                                                    mode="nearest"))
        return self.conv_out(swish(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """taming's VectorQuantizer2: the nearest codebook entry by ``|z|^2 -
    2 z.e + |e|^2`` in float32 (``argmin``: the first index on ties),
    the codebook and beta-weighted commitment losses, and the
    straight-through estimator. ``forward(z)`` on NCHW ``z`` returns
    (z_q float32 NCHW, loss, indices (B, H, W))."""

    def __init__(self, n_embed: int = 16384, embed_dim: int = 3,
                 beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def forward(self, z):
        b, c, h, w = z.shape
        cb = self.embedding.weight.float()
        zf = z.float()
        flat = zf.permute(0, 2, 3, 1).reshape(-1, c)
        with torch.autocast(z.device.type, enabled=False):
            d = (flat.square().sum(1, keepdim=True) - 2.0 * flat @ cb.t()
                 + cb.square().sum(1)[None])
        idx = torch.argmin(d, dim=1)
        z_q = cb[idx].reshape(b, h, w, c).permute(0, 3, 1, 2)
        loss = torch.mean((z_q.detach() - zf) ** 2) \
            + self.beta * torch.mean((z_q - zf.detach()) ** 2)
        z_q = zf + (z_q - zf).detach()
        return z_q, loss, idx.reshape(b, h, w)


class VQModel(nn.Module):
    """encoder -> quant_conv -> quantize -> post_quant_conv -> decoder, the
    JAX ``VQModel``'s defaults (the f4 first stage: 256^2 -> 64^2 x 3).
    ``in_channels`` defaults to ``out_channels``. ``amp`` makes the context
    the nets run in (``torch.autocast`` for bf16; the JAX package's
    ``dtype``); the quantizer and ``decode``'s output are float32."""

    def __init__(self, ch: int = 128, ch_mult=(1, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 3,
                 embed_dim: int = 3, n_embed: int = 16384,
                 out_channels: int = 3, in_channels: int | None = None,
                 amp=None, generator: torch.Generator | None = None):
        super().__init__()
        ch_mult = tuple(ch_mult)
        self.out_channels, self.embed_dim = out_channels, embed_dim
        self.in_channels = in_channels or out_channels
        self.downsample = 2 ** (len(ch_mult) - 1)
        self.amp = amp or contextlib.nullcontext
        self.encoder = Encoder(self.in_channels, ch, ch_mult, num_res_blocks,
                               z_channels)
        self.decoder = Decoder(out_channels, ch, ch_mult, num_res_blocks,
                               z_channels)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = _conv(z_channels, embed_dim, 1)
        self.post_quant_conv = _conv(embed_dim, z_channels, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
        w = self.quantize.embedding.weight
        w.copy_(torch.rand(w.shape, generator=generator, device=w.device)
                * (2.0 / self.quantize.n_embed))

    def encode_pre_quant(self, x):
        """E(x) after ``quant_conv``, before quantization (NCHW): what
        latent BBDM diffuses."""
        with self.amp():
            return self.quant_conv(self.encoder(x))

    def encode(self, x):
        """(z_q, codebook loss, indices)."""
        return self.quantize(self.encode_pre_quant(x))

    def decode(self, z_q):
        with self.amp():
            return self.decoder(self.post_quant_conv(z_q)).float()

    def decode_from_pre_quant(self, z):
        z_q, _, _ = self.quantize(z)
        return self.decode(z_q)

    def forward(self, x):
        """(reconstruction float32, codebook loss, indices)."""
        z_q, qloss, idx = self.encode(x)
        return self.decode(z_q), qloss, idx


def vq_train_loss(recon, x, qloss):
    """The objective without the LPIPS and GAN terms: L1 reconstruction
    plus the quantization losses."""
    return torch.mean(torch.abs(recon.float() - x.float())) + qloss
