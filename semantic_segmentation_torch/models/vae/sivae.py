"""The soft-intro VAE family — the port of
``semantic_segmentation_tpu/models/vae/sivae.py`` (``Soft-intro_VAE/
models.py``, ``UNet.py``, ``Discriminator.py``, ``loss.py``), NCHW.

- ``ResNet18Encoder`` (models.py:80-126): the ResNet-18 trunk up to layer3
  (256 channels) with every 3x3 stride-1 conv a searchable cell
  (``ops/nas.MixedConv`` at kernel sizes 3/5/7, stride 1; 10 cells, the
  (10, 3) arch table ``conv``), the average pool of window ``min(8, H)``
  and the fc heads ``fc_mu`` / ``fc_logvar``. The pooled map is flattened
  in NHWC order, as the JAX package does, so that its Dense kernels load
  as they are (at 256^2 the pooled map is 2x2).
- ``GUnetAddInput`` (UNet.py:14-47): the BicycleGAN-style U-Net decoder, z
  broadcast and concatenated at the input, plain 4x4 stride-2 downs,
  bilinear x2 + reflect pad + 3x3 conv ups, a tanh head in float32.
- ``DNLayersMulti`` (Discriminator.py:7-114): the multi-scale PatchGAN.
- the losses (loss.py:58-127): ``calc_reconstruction_loss`` (mse, l1, bce;
  'none' gives per-sample sums), ``calc_kl`` and ``reparameterize``, whose
  noise is an input.

Module and parameter names are the JAX package's, so ``utils/bridge``
loads its variables. Weights follow flax's laws: lecun-normal convs and
dense kernels, he-uniform cell kernels, zero biases, BN scale 1. Every
net computes in its parameters' dtype (float32); bf16 is ``torch.autocast``
around the call, as in the port's other trainers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from semantic_segmentation_torch.ops.layers import (BatchNorm2d,
                                                    InstanceNorm,
                                                    dropout_half,
                                                    lecun_normal_)
from semantic_segmentation_torch.ops.nas import (KERNEL_SIZES_S1,
                                                 MixedConv, arch_softmax)

N_CELLS = 10


def _norm(norm: str, c: int) -> nn.Module:
    """``_norm``: 'instance' (no parameters) or flax-rule BatchNorm."""
    return InstanceNorm() if norm == "instance" else BatchNorm2d(c)


def _conv(c_in, c_out, k, stride=1, padding=0, bias=True):
    return nn.Conv2d(c_in, c_out, k, stride, padding, bias=bias)


class _BasicBlock(nn.Module):
    """A ResNet basic block whose stride-1 3x3 convs are the cells
    ``cell_base`` (conv1, stride 1 only) and the next one (conv2); a
    strided block's conv1 is a plain conv and its conv2 cell
    ``cell_base``."""

    def __init__(self, c_in: int, planes: int, stride: int, cell_base: int):
        super().__init__()
        self.stride, self.cell_base = stride, cell_base
        if stride == 1:
            self.conv1 = MixedConv(c_in, planes, bias=False,
                                   kernel_sizes=KERNEL_SIZES_S1, stride=1)
        else:
            self.conv1 = _conv(c_in, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = MixedConv(planes, planes, bias=False,
                               kernel_sizes=KERNEL_SIZES_S1, stride=1)
        self.bn2 = BatchNorm2d(planes)
        self.has_down = stride != 1 or c_in != planes
        if self.has_down:
            self.down_conv = _conv(c_in, planes, 1, stride, bias=False)
            self.down_bn = BatchNorm2d(planes)

    def forward(self, x, arch):
        ci = self.cell_base
        if self.stride == 1:
            h = self.conv1(x, arch_softmax(arch[ci]))
            cell2 = ci + 1
        else:
            h = self.conv1(x)
            cell2 = ci
        h = F.relu(self.bn1(h))
        h = self.bn2(self.conv2(h, arch_softmax(arch[cell2])))
        identity = x
        if self.has_down:
            identity = self.down_bn(self.down_conv(x))
        return F.relu(h + identity.to(h.dtype))


# (name, C_in, planes, stride, cell of conv1 / of conv2 when strided)
BLOCKS = (("l1b0", 64, 64, 1, 0), ("l1b1", 64, 64, 1, 2),
          ("l2b0", 64, 128, 2, 4), ("l2b1", 128, 128, 1, 5),
          ("l3b0", 128, 256, 2, 7), ("l3b1", 256, 256, 1, 8))


class ResNet18Encoder(nn.Module):
    """models.py Encoder: resnet18 children[:-3] + AvgPool(8) + fc heads.
    ``forward(x, arch)``: x NCHW, arch (10, 3) (softmaxed per row here);
    returns (mu, logvar) in float32. ``image_size`` sizes the fc heads:
    256 * (pooled side)^2 inputs."""

    def __init__(self, latent_dim: int = 8, image_size: int = 256,
                 in_ch: int = 3):
        super().__init__()
        self.latent_dim = latent_dim
        self.stem = _conv(in_ch, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm2d(64)
        for name, c_in, planes, stride, cell in BLOCKS:
            self.add_module(name, _BasicBlock(c_in, planes, stride, cell))
        side = self.trunk_side(image_size)
        pooled = side // min(8, side)
        self.fc_mu = nn.Linear(256 * pooled * pooled, latent_dim)
        self.fc_logvar = nn.Linear(256 * pooled * pooled, latent_dim)

    @staticmethod
    def trunk_side(size: int) -> int:
        """The trunk's output side for a ``size`` input: the stem conv and
        max-pool, then layer2 and layer3, each halve it (rounding up)."""
        for _ in range(4):
            size = (size + 1) // 2
        return size

    def forward(self, x, arch):
        h = F.relu(self.stem_bn(self.stem(x)))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name, *_ in BLOCKS:
            h = getattr(self, name)(h, arch)
        k = min(8, h.shape[-2])
        h = F.avg_pool2d(h, k, k)
        h = h.permute(0, 2, 3, 1).flatten(1)        # NHWC order, as flax
        return self.fc_mu(h).float(), self.fc_logvar(h).float()


class GUnetAddInput(nn.Module):
    """UNet.py G_Unet_add_input: ``forward(x, z)`` with x NCHW (input_nc
    channels) and z (B, nz); returns NCHW float32 in [-1, 1]. The norm
    ('instance' by default, or 'batch') sits on downs 1 to nd - 2 and on
    every up but the outermost; with ``use_dropout`` the ups at
    4 <= d <= nd - 2 drop half their units in training (keep-masks by
    depth in ``dropout``, else drawn from ``generator``)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, nz: int = 8,
                 num_downs: int = 7, ngf: int = 64,
                 use_dropout: bool = False, norm: str = "instance"):
        super().__init__()
        self.nz, self.nd, self.use_dropout = nz, num_downs, use_dropout
        nd = num_downs
        inner = [min(ngf * 2 ** d, ngf * 8) for d in range(nd)]
        outer = [output_nc] + [min(ngf * 2 ** (d - 1), ngf * 8)
                               for d in range(1, nd)]
        for d in range(nd):
            c_in = input_nc + nz if d == 0 else inner[d - 1]
            self.add_module(f"down{d}", _conv(c_in, inner[d], 4, 2, 1))
            if 0 < d < nd - 1:
                self.add_module(f"down_bn{d}", _norm(norm, inner[d]))
            up_in = inner[d] * (2 if d < nd - 1 else 1)
            self.add_module(f"up{d}", _conv(up_in, outer[d], 3))
            if d > 0:
                self.add_module(f"up_bn{d}", _norm(norm, outer[d]))

    def forward(self, x, z=None, dropout: dict | None = None,
                generator: torch.Generator | None = None):
        nd = self.nd
        if self.nz > 0:
            zi = z[:, :, None, None].to(x.dtype).expand(
                -1, -1, x.shape[2], x.shape[3])
            x = torch.cat([x, zi], dim=1)
        drop = self.use_dropout and self.training

        def block(h, d):
            skip = h
            if d > 0:
                h = F.leaky_relu(h, 0.2)
            h = getattr(self, f"down{d}")(h)
            if 0 < d < nd - 1:
                h = getattr(self, f"down_bn{d}")(h)
            if d < nd - 1:
                h = block(h, d + 1)
            h = F.relu(h)
            h = F.interpolate(h, scale_factor=2, mode="bilinear",
                              align_corners=False)
            h = getattr(self, f"up{d}")(F.pad(h, (1, 1, 1, 1),
                                              mode="reflect"))
            if d == 0:
                return torch.tanh(h.float())
            h = getattr(self, f"up_bn{d}")(h)
            if drop and 4 <= d <= nd - 2:
                h = dropout_half(h, (dropout or {}).get(d), generator)
            return torch.cat([skip, h.to(skip.dtype)], dim=1)

        return block(x, 0)


class DNLayersMulti(nn.Module):
    """Discriminator.py D_NLayersMulti: a PatchGAN at each of ``num_D``
    scales (the input avg-pooled 3x3/2, padding excluded, between scales);
    returns the list of float32 logit maps."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 2,
                 num_D: int = 1, norm: str = "batch"):
        super().__init__()
        self.n_layers, self.num_D = n_layers, num_D
        for i in range(num_D):
            self._stack(input_nc, int(round(ndf / 2 ** i)), norm,
                        f"model_{i}")

    def _stack(self, c_in, ndf, norm, prefix):
        self.add_module(f"{prefix}_conv0", _conv(c_in, ndf, 4, 2, 1))
        c = ndf
        for n in range(1, self.n_layers):
            nf = min(2 ** n, 8)
            self.add_module(f"{prefix}_conv{n}", _conv(c, ndf * nf, 4, 2, 1))
            self.add_module(f"{prefix}_bn{n}", _norm(norm, ndf * nf))
            c = ndf * nf
        nf = min(2 ** self.n_layers, 8)
        self.add_module(f"{prefix}_conv{self.n_layers}",
                        _conv(c, ndf * nf, 4, 1, 1))
        self.add_module(f"{prefix}_bn{self.n_layers}", _norm(norm, ndf * nf))
        self.add_module(f"{prefix}_head", _conv(ndf * nf, 1, 4, 1, 1))

    def _run(self, x, prefix):
        h = F.leaky_relu(getattr(self, f"{prefix}_conv0")(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"{prefix}_conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"{prefix}_bn{n}")(h), 0.2)
        return getattr(self, f"{prefix}_head")(h).float()

    def forward(self, x):
        outs = [self._run(x, "model_0")]
        for i in range(1, self.num_D):
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
            outs.append(self._run(x, f"model_{i}"))
        return outs


@torch.no_grad()
def init_weights_(net: nn.Module, generator: torch.Generator | None = None):
    """flax's initializers of the JAX nets: lecun-normal conv and dense
    kernels, he-uniform cell kernels (U(+-sqrt(6 / fan_in))), zero biases,
    BN scale 1 and bias 0. Draws on the parameters' device."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MixedConv):
            for k in m.kernel_sizes:
                w = getattr(m, f"kernel_{k}")
                bound = math.sqrt(6.0 / w[0].numel())
                w.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return net


# -- losses (loss.py:58-127) -------------------------------------------------

def calc_reconstruction_loss(x, recon_x, loss_type: str = "mse",
                             reduction: str = "sum"):
    """'sum' or 'none' (the (B,) per-sample sums) over every element but
    the batch axis; 'mean' is the mean of the per-sample sums under mse
    and the elementwise mean under l1 and bce, as in loss.py. float32."""
    x = x.float().reshape(x.shape[0], -1)
    r = recon_x.float().reshape(recon_x.shape[0], -1)
    if loss_type == "mse":
        err = (r - x).square().sum(dim=1, keepdim=True)
    elif loss_type == "l1":
        err = (r - x).abs()
    elif loss_type == "bce":
        rc = r.clamp(1e-7, 1.0 - 1e-7)
        err = -(x * torch.log(rc) + (1 - x) * torch.log(1 - rc))
    else:
        raise NotImplementedError(loss_type)
    if reduction == "sum":
        return err.sum()
    if reduction == "mean":
        return err.mean()
    return err.sum(dim=1)


def calc_kl(logvar, mu, reduce: str = "sum"):
    kl = -0.5 * (1 + logvar - mu.square() - torch.exp(logvar)).sum(dim=1)
    if reduce == "sum":
        return kl.sum()
    return kl.mean() if reduce == "mean" else kl


def reparameterize(mu, logvar, eps):
    """mu + exp(logvar / 2) * eps, with the noise ``eps`` an input."""
    return mu + torch.exp(0.5 * logvar) * eps


class SoftIntroVAE(nn.Module):
    """SoftIntroVAESimple (models.py:215-245): the encoder, the decoder and
    the encoder's (10, 3) arch table ``arch`` (1e-3 * N(0, 1), a plain
    tensor: the bilevel engine owns it as the outer variable). The decoder's depth is
    log2 of ``netG``'s size (unet_128 -> 7, unet_256 -> 8), at least 3.
    Drawn on the CPU from ``generator`` (a CPU generator, so that one seed
    gives one net on every device), then moved to ``device``."""

    def __init__(self, latent_dim: int = 8, output_nc: int = 3,
                 ngf: int = 64, netG: str = "unet_128",
                 image_size: int | None = None, in_ch: int = 3,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.latent_dim = latent_dim
        size = int(netG.split("_")[1])
        num_downs = max(int(math.log2(size)), 3)
        self.encoder = ResNet18Encoder(latent_dim, image_size or size, in_ch)
        self.decoder = GUnetAddInput(in_ch, output_nc, latent_dim,
                                     num_downs, ngf)
        init_weights_(self, generator)
        self.arch = (1e-3 * torch.randn(N_CELLS, 3, generator=generator)
                     ).to(device)
        self.to(device)
