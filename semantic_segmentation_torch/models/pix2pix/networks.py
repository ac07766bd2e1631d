"""Pix2Pix generators and discriminators with embedded DARTS cells — the
port of ``semantic_segmentation_tpu/models/pix2pix/networks.py``:

- ``UnetGenerator`` (``models_pix2pix/networks.py:514-617``): the recursive
  skip U-Net with 4x4 stride-2 down-convs, every up-conv a searchable mixed
  op, BN on the interior downs/ups, dropout(0.5) on the interior ngf*8 ups,
  tanh head.
- ``ResnetGenerator`` (``:321-439``): reflection-padded 7x7 stem, two
  stride-2 downs, n residual blocks (dropout(0.5) between their convs),
  two transposed-conv ups, tanh head. Any input size divisible by 4.
- ``NLayerDiscriminator`` (``:620-665``): the 70x70 PatchGAN;
  ``PixelDiscriminator`` (``:668-697``): the 1x1 PatchGAN.

NCHW. Submodule names are the JAX package's (``down{d}``, ``down_bn{d}``,
``up{d}``, ``up_bn{d}``; ``stem``, ``res{i}``; ``conv{n}``, ``bn{n}``,
``head``) so the weight bridge maps the trees leaf by leaf. ``norm`` is
``get_norm_layer``'s (``networks.py:23-41``): 'batch' (the default),
'instance' (no parameters) or 'none'; a conv that a norm follows carries a
bias only under instance norm (``use_bias = norm == 'instance'``, JAX
``models/pix2pix/networks.py:51, 76, 149, 196, 228``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import (dropout_half, norm_layer,
                                                    pix2pix_normal_)
from semantic_segmentation_torch.ops.nas import MixedConvTranspose, arch_softmax
from semantic_segmentation_torch.parallel import collectives


def dropout_depths(num_downs: int):
    """Depths whose up block applies dropout: the nd-5 interior ngf*8
    blocks, 4 <= d <= nd-2 (networks.py:535-537, 607)."""
    return tuple(range(4, num_downs - 1))


class UnetGenerator(nn.Module):
    """unet_{256,128,64,32} generator. ``arch_upconv`` (num_downs, 3): row
    ``num_downs - 1 - d`` feeds depth d's mixed up-conv (the construction
    order of networks.py:530-546)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 num_downs: int = 8, ngf: int = 64, use_dropout: bool = True,
                 norm: str = "batch"):
        super().__init__()
        nd = self.num_downs = num_downs
        self.use_dropout = use_dropout
        use_bias = norm == "instance"
        inner = [min(ngf * 2 ** d, ngf * 8) for d in range(nd)]
        self.up_channels = [output_nc] + [ngf * min(2 ** (d - 1), 8)
                                          for d in range(1, nd)]
        for d in range(nd):
            c_in = input_nc if d == 0 else inner[d - 1]
            self.add_module(f"down{d}", nn.Conv2d(c_in, inner[d], 4, 2, 1,
                                                  bias=use_bias))
            if 0 < d < nd - 1:
                self.add_module(f"down_bn{d}", norm_layer(norm, inner[d]))
            up_in = inner[d] * (2 if d < nd - 1 else 1)
            out_ch = self.up_channels[d]
            self.add_module(f"up{d}", MixedConvTranspose(
                up_in, out_ch, bias=d == 0 or use_bias))
            if d > 0:
                self.add_module(f"up_bn{d}", norm_layer(norm, out_ch))

    def forward(self, x, arch_upconv, dropout_masks=None,
                generator: torch.Generator | None = None):
        """``dropout_masks``: {depth: bool keep-mask shaped like that
        depth's up-block output} replaces the draw from ``generator`` (train
        mode only)."""
        return self._block(x, 0, arch_upconv, dropout_masks, generator)

    def draw_dropout(self, shape, generator=None, device=None) -> dict:
        """{depth: keep-mask} for a train-mode forward on an NCHW input of
        ``shape``, drawn from ``generator`` in the order the forward draws
        them (the deepest first). Under data parallelism, at the global
        batch's size (``dropout_half`` takes this rank's rows)."""
        if not self.use_dropout:
            return {}
        b, _, hh, ww = shape
        b = collectives.global_batch(b)
        return {d: torch.rand((b, self.up_channels[d], hh >> d, ww >> d),
                              generator=generator, device=device) < 0.5
                for d in reversed(dropout_depths(self.num_downs))}

    def _block(self, h, d, arch_upconv, dropout_masks, generator):
        """The skip block at depth ``d`` and, inside it, those below. A
        method, not a closure that calls itself: such a closure is a
        reference cycle that keeps the module alive until the cyclic
        garbage collector runs."""
        nd = self.num_downs
        skip = h
        if d > 0:
            h = F.leaky_relu(h, 0.2)
        h = getattr(self, f"down{d}")(h)
        if 0 < d < nd - 1:
            h = getattr(self, f"down_bn{d}")(h)
        if d < nd - 1:
            h = self._block(h, d + 1, arch_upconv, dropout_masks, generator)
        h = F.relu(h)
        weights = arch_softmax(arch_upconv[nd - 1 - d])
        h = getattr(self, f"up{d}")(h, weights)
        if d == 0:
            return torch.tanh(h.float())
        h = getattr(self, f"up_bn{d}")(h)
        if self.training and self.use_dropout and d in dropout_depths(nd):
            h = dropout_half(h, None if dropout_masks is None
                             else dropout_masks[d], generator)
        return torch.cat([skip, h.to(skip.dtype)], dim=1)


def _reflect(x, p: int):
    return F.pad(x, [p, p, p, p], mode="reflect")


class ResnetBlock(nn.Module):
    """networks.py:382-439: two reflect-padded 3x3 conv -> BN stages with
    ReLU (and dropout) between them, added to the input."""

    def __init__(self, dim: int, use_dropout: bool = False,
                 norm: str = "batch"):
        super().__init__()
        self.use_dropout = use_dropout
        use_bias = norm == "instance"
        self.conv0 = nn.Conv2d(dim, dim, 3, bias=use_bias)
        self.bn0 = norm_layer(norm, dim)
        self.conv1 = nn.Conv2d(dim, dim, 3, bias=use_bias)
        self.bn1 = norm_layer(norm, dim)

    def forward(self, x, keep=None, generator=None):
        """``keep``: a keep-mask that replaces the train-mode dropout
        draw."""
        h = F.relu(self.bn0(self.conv0(_reflect(x, 1))))
        if self.training and self.use_dropout:
            h = dropout_half(h, keep, generator)
        h = self.bn1(self.conv1(_reflect(h, 1)))
        return x + h.to(x.dtype)


class ResnetGenerator(nn.Module):
    """networks.py:321-379. ``arch_upconv`` is accepted and ignored (the
    generators share one signature)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9, use_dropout: bool = False,
                 norm: str = "batch"):
        super().__init__()
        self.n_blocks = n_blocks
        use_bias = norm == "instance"
        self.stem = nn.Conv2d(input_nc, ngf, 7, bias=use_bias)
        self.stem_bn = norm_layer(norm, ngf)
        for i in range(2):
            c = ngf * 2 ** i
            self.add_module(f"down{i}", nn.Conv2d(c, 2 * c, 3, 2, 1,
                                                  bias=use_bias))
            self.add_module(f"down_bn{i}", norm_layer(norm, 2 * c))
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(ngf * 4, use_dropout,
                                                   norm))
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            # torch ConvTranspose2d(k3, s2, p1, output_padding=1): 2n out
            self.add_module(f"up{i}", nn.ConvTranspose2d(
                c, c // 2, 3, 2, 1, output_padding=1, bias=use_bias))
            self.add_module(f"up_bn{i}", norm_layer(norm, c // 2))
        self.head = nn.Conv2d(ngf, output_nc, 7, bias=True)

    def draw_dropout(self, shape, generator=None, device=None) -> dict:
        """{block index: keep-mask} for a train-mode forward on an NCHW
        input of ``shape``, drawn from ``generator`` in the forward's
        order (the blocks run at a quarter of the input's size); at the
        global batch's size under data parallelism."""
        if not self.res0.use_dropout:
            return {}
        b, _, hh, ww = shape
        b = collectives.global_batch(b)
        size = (b, self.res0.conv0.out_channels, (hh + 3) // 4,
                (ww + 3) // 4)
        return {i: torch.rand(size, generator=generator, device=device) < 0.5
                for i in range(self.n_blocks)}

    def forward(self, x, arch_upconv=None, dropout_masks=None,
                generator: torch.Generator | None = None):
        """``dropout_masks``: {block index: keep-mask shaped like that
        block's first conv output} replaces the draw from ``generator``
        (train mode only)."""
        h = F.relu(self.stem_bn(self.stem(_reflect(x, 3))))
        for i in range(2):
            h = F.relu(getattr(self, f"down_bn{i}")(
                getattr(self, f"down{i}")(h)))
        for i in range(self.n_blocks):
            keep = None if dropout_masks is None else dropout_masks[i]
            h = getattr(self, f"res{i}")(h, keep, generator)
        for i in range(2):
            h = F.relu(getattr(self, f"up_bn{i}")(getattr(self, f"up{i}")(h)))
        return torch.tanh(self.head(_reflect(h, 3)).float())


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN (networks.py:620-665): NCHW logit map."""

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch"):
        super().__init__()
        self.n_layers = n_layers
        use_bias = norm == "instance"
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, 2, 1, bias=True)
        nf = ndf
        for n in range(1, n_layers):
            nf_out = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", nn.Conv2d(nf, nf_out, 4, 2, 1,
                                                  bias=use_bias))
            self.add_module(f"bn{n}", norm_layer(norm, nf_out))
            nf = nf_out
        nf_out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", nn.Conv2d(nf, nf_out, 4, 1, 1,
                                                     bias=use_bias))
        self.add_module(f"bn{n_layers}", norm_layer(norm, nf_out))
        self.head = nn.Conv2d(nf_out, 1, 4, 1, 1, bias=True)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"bn{n}")(h), 0.2)
        return self.head(h).float()


class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN (networks.py:668-697): a per-pixel NCHW logit map."""

    def __init__(self, input_nc: int = 2, ndf: int = 64,
                 norm: str = "batch"):
        super().__init__()
        use_bias = norm == "instance"
        self.conv0 = nn.Conv2d(input_nc, ndf, 1, bias=True)
        self.conv1 = nn.Conv2d(ndf, 2 * ndf, 1, bias=use_bias)
        self.bn1 = norm_layer(norm, 2 * ndf)
        self.head = nn.Conv2d(2 * ndf, 1, 1, bias=use_bias)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        h = F.leaky_relu(self.bn1(self.conv1(h)), 0.2)
        return self.head(h).float()


_NUM_DOWNS = {256: 8, 128: 7, 64: 6, 32: 5}


def define_G(input_nc: int = 1, output_nc: int = 1, netG: str = "unet_256",
             ngf: int = 64, use_dropout: bool = True,
             generator: torch.Generator | None = None, norm: str = "batch"):
    """Generator factory (networks.py:125-165): unet_{256,128,64,32} and
    resnet_{9,6}blocks, 'normal' init at gain 0.02."""
    if netG.startswith("unet_"):
        net = UnetGenerator(input_nc, output_nc,
                            _NUM_DOWNS[int(netG.split("_")[1])], ngf,
                            use_dropout, norm)
    elif netG in ("resnet_9blocks", "resnet_6blocks"):
        net = ResnetGenerator(input_nc, output_nc, ngf,
                              9 if netG == "resnet_9blocks" else 6,
                              use_dropout, norm)
    else:
        raise NotImplementedError(f"generator {netG!r} is not recognized")
    pix2pix_normal_(net, 0.02, generator)
    return net


def define_D(input_nc: int = 2, netD: str = "basic", ndf: int = 64,
             n_layers_D: int = 3, generator: torch.Generator | None = None,
             norm: str = "batch"):
    """Discriminator factory (networks.py:168-209): 'basic' (3 layers),
    'n_layers' (``n_layers_D``) and 'pixel'."""
    if netD in ("basic", "n_layers"):
        net = NLayerDiscriminator(input_nc, ndf,
                                  3 if netD == "basic" else n_layers_D, norm)
    elif netD == "pixel":
        net = PixelDiscriminator(input_nc, ndf, norm)
    else:
        raise NotImplementedError(f"discriminator {netD!r} is not "
                                  "recognized")
    pix2pix_normal_(net, 0.02, generator)
    return net
