"""ADM-style denoiser U-Net with DARTS cells — the port of
``semantic_segmentation_tpu/models/diffusion/adm_unet.py`` (the BBDM
``UNetModel``, ``BBDM/model/BrownianBridge/base/modules/diffusionmodules/
openaimodel.py:498-780``), NCHW.

- Every ResBlock's first conv is a searchable cell mixing k3/k5/k7 stride-1
  convs (``ops/nas.MixedConv`` with ``KERNEL_SIZES_S1``, fused into one
  7-tap conv), driven by row ``cell_index`` of the arch table
  (n_cells, 3). Cells are numbered in construction order (input blocks,
  downs, middle, output blocks, ups), the reference's ``cell_index``.
- Timestep embedding: sinusoidal ``[cos, sin]`` of width model_channels,
  then a 2-layer SiLU MLP to 4x.
- ResBlock: GN+SiLU (+ nearest 2x up or 2x2 average-pool down of both the
  branch and the skip) + cell conv; the embedding's scale-shift on the
  second GN; SiLU, zero-init 3x3 conv; a 1x1 skip conv where the width
  changes.
- Attention where the cumulative downsample rate is in
  ``attention_resolutions`` (the canonical (32, 16, 8) never matches ds in
  {1, 2, 4}, so only the middle block attends) and always in the middle
  block; heads = channels // num_head_channels, the qkv channels split as
  (3, heads, head_dim), an explicit f32 softmax (under autograd one image
  at a time, the scores recomputed in the backward), zero-init
  projection.
- GroupNorm is flax's: 32 groups (the largest divisor <= 32 at small
  widths), statistics in float32 with the variance as E[x^2] - E[x]^2
  clipped at 0, and a float32 output (flax promotes a bfloat16 input with
  its float32 scale). Each norm with what follows it up to the next conv
  (scale-shift, SiLU) recomputes its float32 intermediates in the
  backward (``norm_act``): kept, they took most of the memory of a
  batch-8 step at 256^2.

Submodules carry the JAX package's names, so ``utils/bridge.load_flax``
maps its parameters. ``assemble`` builds every cell's mixed kernel once,
for a caller that runs the net many times at fixed weights (the 200-step
sampler); ``forward(..., kernels=...)`` then skips the per-call assembly.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from semantic_segmentation_torch.ops.layers import _at_least_f32, lecun_normal_
from semantic_segmentation_torch.ops.nas import (KERNEL_SIZES_S1, MixedConv,
                                                 _embed, arch_softmax)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """(B,) timesteps -> (B, dim) float32 ``[cos, sin]`` features."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def num_groups(channels: int) -> int:
    """GroupNorm32 (the reference's ``normalization()``); at small widths
    the largest divisor <= 32."""
    if channels % 32 == 0:
        return 32
    return max(g for g in range(1, min(32, channels) + 1)
               if channels % g == 0)


def group_norm(x, weight, bias, groups: int, eps: float = 1e-5):
    """flax ``nn.GroupNorm`` on NC... (see the module docstring)."""
    xs = _at_least_f32(x)
    n, c = x.shape[:2]
    g = xs.reshape(n, groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    mean2 = (g * g).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps).expand(n, groups, c // groups).reshape(
        n, c) * weight
    view = (n, c) + (1,) * (x.dim() - 2)
    y = (g - mean).reshape(x.shape)
    return y * mul.reshape(view) + bias.reshape((1,) + view[1:])


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon=1e-5)`` on NCHW."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = num_groups(channels), eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


def norm_act(norm: GroupNorm, x, scale=None, shift=None, act: bool = True):
    """``silu(norm(x) * (1 + scale) + shift)`` (the scale-shift where
    given, the SiLU where ``act``). Under autograd its float32
    intermediates (several tensors the size of ``x`` a call, the most of
    the denoiser's activations) are recomputed in the backward from ``x``,
    the same math: only the inputs are kept. The norm's weights are
    passed in, so that a recompute after ``functional_call`` reads the
    weights the forward read."""
    def fn(x, weight, bias, scale, shift):
        y = group_norm(x, weight, bias, norm.groups, norm.eps)
        if scale is not None:
            y = y * (1 + scale) + shift
        return F.silu(y) if act else y
    args = (x, norm.weight, norm.bias, scale, shift)
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v, the softmax in float32; (b, heads, n,
    d) each."""
    attn = torch.matmul(q * (q.shape[-1] ** -0.5), k.transpose(-1, -2))
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, num_head_channels: int = 64):
        super().__init__()
        self.heads = (max(1, channels // num_head_channels)
                      if num_head_channels > 0 else 8)
        self.norm = GroupNorm(channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        hd = c // self.heads
        y = norm_act(self.norm, x, act=False).reshape(b, c, h * w).transpose(
            1, 2)
        qkv = self.qkv(y).reshape(b, h * w, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # (b, heads, hw, hd)
        if torch.is_grad_enabled():
            # one image at a time, its scores recomputed in the backward:
            # kept, the float32 scores of the 64^2 middle block (16 heads,
            # 4,096 tokens) take 1 GiB an image, and their backward three
            # times that at once
            out = torch.cat([checkpoint(_attention, q[i:i + 1], k[i:i + 1],
                                        v[i:i + 1], use_reentrant=False)
                             for i in range(b)])
        else:
            out = _attention(q, k, v)
        out = out.permute(0, 2, 1, 3).reshape(b, h * w, c)
        out = self.proj(out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def _resample(x, up: bool):
    if up:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return F.avg_pool2d(x, 2, 2)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, emb_channels: int,
                 out_channels: int, dropout: float = 0.0,
                 use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False, cell_index: int = -1):
        super().__init__()
        if dropout:
            raise NotImplementedError(
                "ADMUNet dropout > 0: no entry point of the JAX package "
                "sets it, and the port does not draw its masks")
        self.up, self.down, self.cell_index = up, down, cell_index
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm(in_channels)
        if cell_index >= 0:
            self.in_conv_cell = MixedConv(in_channels, out_channels,
                                          kernel_sizes=KERNEL_SIZES_S1,
                                          stride=1)
        else:
            self.in_conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.emb_proj = nn.Linear(
            emb_channels,
            2 * out_channels if use_scale_shift_norm else out_channels)
        self.out_norm = GroupNorm(out_channels)
        self.out_conv = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.skip = (nn.Conv2d(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def forward(self, x, emb, arch=None, kernels=None):
        h = norm_act(self.in_norm, x)
        if self.up or self.down:
            h = _resample(h, self.up)
            x = _resample(x, self.up)
        if self.cell_index < 0:
            h = self.in_conv(h)
        elif kernels is not None:
            kmix, bias = kernels[self.cell_index]
            h = F.conv2d(h, kmix, bias, padding=(max(KERNEL_SIZES_S1) - 1)
                         // 2)
        else:
            h = self.in_conv_cell(h, arch_softmax(arch[self.cell_index]))
        e = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(e, 2, dim=1)
            h = norm_act(self.out_norm, h, scale, shift)
        else:
            h = norm_act(self.out_norm, h + e)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x.to(h.dtype) + h


class ADMUNet(nn.Module):
    """UNetModel at the BBDM template config. ``in_channels`` counts the
    conditioning channels too: the caller's context is concatenated to the
    input (2 * C for BBDM's ``SpatialRescaler`` condition)."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 model_channels: int = 128, num_res_blocks: int = 2,
                 attention_resolutions: tuple = (32, 16, 8),
                 channel_mult: tuple = (1, 4, 8), dropout: float = 0.0,
                 num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        self.n_cells = self.num_cells(tuple(channel_mult), num_res_blocks,
                                      resblock_updown)
        emb_ch = 4 * mc
        self.time_fc1 = nn.Linear(mc, emb_ch)
        self.time_fc2 = nn.Linear(emb_ch, emb_ch)
        self.in0 = nn.Conv2d(in_channels, mc, 3, padding=1)
        cell = iter(range(self.n_cells))
        # the forward's order: (kind, block name, attention name or None);
        # 'push' blocks feed the skip stack, 'cat' blocks take from it
        self._plan: list = []
        self._cells: list = []           # (cell_index, module path, cell)

        def res(name, c_in, c_out, **kw):
            block = ResBlock(c_in, emb_ch, c_out, dropout,
                             use_scale_shift_norm, cell_index=next(cell),
                             **kw)
            self.add_module(name, block)
            self._cells.append((block.cell_index, f"{name}.in_conv_cell",
                                block.in_conv_cell))

        def attn(name, c):
            self.add_module(name, AttentionBlock(c, num_head_channels))
            return name

        ch, ds, nl = mc, 1, len(channel_mult)
        skips = [mc]
        for li, mult in enumerate(channel_mult):
            for bi in range(num_res_blocks):
                res(f"in_l{li}_b{bi}", ch, mc * mult)
                ch = mc * mult
                a = (attn(f"in_attn_l{li}_b{bi}", ch)
                     if ds in attention_resolutions else None)
                self._plan.append(("push", f"in_l{li}_b{bi}", a))
                skips.append(ch)
            if li < nl - 1:
                if resblock_updown:
                    res(f"down{li}", ch, ch, down=True)
                    self._plan.append(("push", f"down{li}", None))
                else:
                    self.add_module(f"down{li}", nn.Conv2d(
                        ch, ch, 3, stride=2, padding=1))
                    self._plan.append(("push_conv", f"down{li}", None))
                skips.append(ch)
                ds *= 2
        res("mid0", ch, ch)
        self.mid_attn = AttentionBlock(ch, num_head_channels)
        res("mid1", ch, ch)
        self._plan.append(("res", "mid0", "mid_attn"))
        self._plan.append(("res", "mid1", None))
        for li, mult in list(enumerate(channel_mult))[::-1]:
            for bi in range(num_res_blocks + 1):
                res(f"out_l{li}_b{bi}", ch + skips.pop(), mc * mult)
                ch = mc * mult
                a = (attn(f"out_attn_l{li}_b{bi}", ch)
                     if ds in attention_resolutions else None)
                self._plan.append(("cat", f"out_l{li}_b{bi}", a))
            if li > 0:
                if resblock_updown:
                    res(f"up{li}", ch, ch, up=True)
                    self._plan.append(("res", f"up{li}", None))
                else:
                    self.add_module(f"up{li}", nn.Conv2d(ch, ch, 3,
                                                         padding=1))
                    self._plan.append(("up_conv", f"up{li}", None))
                ds //= 2
        self.out_norm = GroupNorm(ch)
        self.out_conv = nn.Conv2d(ch, out_channels, 3, padding=1)

    @staticmethod
    def num_cells(channel_mult=(1, 4, 8), num_res_blocks=2,
                  resblock_updown=True):
        """Cells in construction order (the reference's cell_index): input
        resblocks + down resblocks + 2 middle + output resblocks + up
        resblocks."""
        nl = len(channel_mult)
        cells = nl * num_res_blocks
        if resblock_updown:
            cells += nl - 1
        cells += 2
        cells += nl * (num_res_blocks + 1)
        if resblock_updown:
            cells += nl - 1
        return cells

    def assemble(self, arch, params: dict | None = None, dtype=None):
        """{cell_index: (mixed kernel, mixed bias)} of every cell under the
        arch table ``arch``, from ``params`` ({name: tensor}, as
        ``named_parameters``) where given, else the module's own; the
        kernels cast to ``dtype`` where given. The same math as
        ``MixedConv.forward``."""
        out = {}
        for idx, path, cell in self._cells:
            def get(leaf):
                return (params[f"{path}.{leaf}"] if params is not None
                        else getattr(cell, leaf))
            w = arch_softmax(arch[idx])
            kmix = _embed([get(f"kernel_{k}") for k in KERNEL_SIZES_S1], w,
                          max(KERNEL_SIZES_S1))
            bias = sum(wi * get(f"bias_{k}")
                       for wi, k in zip(w, KERNEL_SIZES_S1))
            out[idx] = (kmix if dtype is None else kmix.to(dtype), bias)
        return out

    def forward(self, x, t, arch=None, context=None, kernels=None):
        """``x`` (B, C, H, W) float, ``t`` (B,) timesteps, ``arch`` the
        (n_cells, 3) table (unread with ``kernels``, ``assemble``'s
        output); returns float32 (B, out_channels, H, W)."""
        if context is not None:
            x = torch.cat([x, context], dim=1)
        emb = timestep_embedding(t, self.model_channels).to(
            self.time_fc1.weight.dtype)        # float64 nets: float64
        emb = self.time_fc2(F.silu(self.time_fc1(emb)))
        h = self.in0(x)
        hs = [h]
        for kind, name, attn in self._plan:
            block = getattr(self, name)
            if kind == "cat":
                h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            if kind == "push_conv":
                h = block(h)
            elif kind == "up_conv":
                h = block(F.interpolate(h, scale_factor=2, mode="nearest"))
            else:
                h = block(h, emb, arch, kernels)
            if attn is not None:
                h = getattr(self, attn)(h)
            if kind in ("push", "push_conv"):
                hs.append(h)
        return self.out_conv(norm_act(self.out_norm, h)).float()


@torch.no_grad()
def init_weights_(net: ADMUNet, generator: torch.Generator | None = None):
    """flax's initializers of the JAX ``ADMUNet``: lecun-normal convs and
    dense kernels, he-uniform cell kernels, zero biases, GroupNorm scale 1,
    and zero ``out_conv`` kernels (every ResBlock's and the net's) and
    attention ``proj``. Draws on the parameters' device from
    ``generator``."""
    zero = {"out_conv", "proj"}
    for name, m in net.named_modules():
        leaf = name.rpartition(".")[2]
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if leaf in zero:
                m.weight.zero_()
            else:
                lecun_normal_(m.weight, generator)
            m.bias.zero_()
        elif isinstance(m, MixedConv):
            for k in m.kernel_sizes:
                w = getattr(m, f"kernel_{k}")
                bound = math.sqrt(6.0 / w[0].numel())
                w.uniform_(-bound, bound, generator=generator)
                getattr(m, f"bias_{k}").zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return net
