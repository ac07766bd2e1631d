"""DARTS-style mixed (transposed) convolutions — the searchable up-conv of
the GenSeg generator and the searchable down-conv of the GenSeg-3D
generator, ported from ``semantic_segmentation_tpu/ops/nas.py``.

Reference semantics (``models_pix2pix/networks.py:476-511``): each
searchable layer holds three ``ConvTranspose2d`` candidates (k, s, p) =
(4, 2, 1), (6, 2, 2), (8, 2, 3) and computes
``sum_i softmax(arch[layer])_i * op_i(x)``. All three give the same output
size and are linear, so the mixture is ONE 8-tap transposed conv whose kernel
is the weighted sum of the candidates, each zero-embedded at the centre of
the 8x8 window (for a transposed conv, tap j of k4p1 is tap j + 2 of k8p3,
tap j of k6p2 is tap j + 1). Kernels are kept in torch's ConvTranspose2d
layout (C_in, C_out, k, k); the weight bridge flips the JAX package's
forward-equivalent HWIO kernels into it.

``MixedConv`` is the forward counterpart (``networks.py:448-473``, the 3D
``Cell_conv`` at ``GenSeg-3D/models/networks.py:570-574``): candidates
(4, 2, 1), (6, 2, 2), (8, 2, 3) fused into one k8-s2-p3 conv, each
zero-embedded at the centre (a forward conv's tap j of k4p1 is tap j + 2
of k8p3, so no flip), for 2-D or 3-D input, kernels in torch's
(C_out, C_in, k, ...) layout. ``kernel_sizes`` and ``stride`` are
arguments: BBDM's stride-1 cells use (3, 5, 7) at stride 1.

The architecture tables mirror ``networks.py:442-446`` and ``:476-484``:
(n_layers, 3) each, 1e-3 * N(0, 1), softmaxed per row. They are not module
parameters: the bilevel engine owns them as the outer variables.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

KERNEL_SIZES = (4, 6, 8)
# BBDM's stride-1 searchable convs (openaimodel.py:37-47): k3s1p1/k5s1p2/k7s1p3
KERNEL_SIZES_S1 = (3, 5, 7)
NUM_OPS = len(KERNEL_SIZES)


def init_arch_params(generator: torch.Generator | None = None,
                     n_conv_layers: int = 8, n_upconv_layers: int = 8,
                     scale: float = 1e-3, device=None):
    """{'conv': (L, 3), 'upconv': (L, 3)}, init 1e-3 * randn
    (``networks.py:443,477``)."""
    dev = device if device is not None else (
        generator.device if generator is not None else "cpu")
    return {
        "conv": scale * torch.randn(n_conv_layers, NUM_OPS,
                                    generator=generator, device=dev),
        "upconv": scale * torch.randn(n_upconv_layers, NUM_OPS,
                                      generator=generator, device=dev),
    }


def arch_softmax(arch_row):
    """Per-layer softmax over the 3 candidates (networks.py:469, 508-509)."""
    return torch.softmax(arch_row.float(), dim=-1)


def _embed(kernels, weights, kmax: int):
    """sum_i weights[i] * kernels[i], each zero-padded at the centre of a
    ``kmax`` window on its trailing spatial axes."""
    mixed = 0.0
    for w, k in zip(weights, kernels):
        off = (kmax - k.shape[-1]) // 2
        mixed = mixed + w * F.pad(k, [off, off] * (k.dim() - 2))
    return mixed


class MixedConv(nn.Module):
    """``Cell_conv``/``MixedOp_conv`` (networks.py:448-473; BBDM
    openaimodel.py:65-90): the softmax mixture of forward convs fused into
    ONE conv with the largest tap window, stride ``stride`` and padding
    (k_max - stride) // 2, on ``ndim_spatial``-D input (2 or 3)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True, ndim_spatial: int = 2,
                 kernel_sizes: tuple = KERNEL_SIZES, stride: int = 2):
        super().__init__()
        if ndim_spatial not in (2, 3):
            raise ValueError(f"ndim_spatial {ndim_spatial} (2 or 3)")
        self.ndim_spatial, self.stride = ndim_spatial, stride
        self.kernel_sizes = tuple(kernel_sizes)
        for k in self.kernel_sizes:
            self.register_parameter(f"kernel_{k}", nn.Parameter(torch.empty(
                (out_channels, in_channels) + (k,) * ndim_spatial)))
            self.register_parameter(f"bias_{k}", nn.Parameter(
                torch.zeros(out_channels)) if bias else None)
        self.has_bias = bias

    def mixed_kernel(self, weights):
        return _embed([getattr(self, f"kernel_{k}")
                       for k in self.kernel_sizes], weights,
                      max(self.kernel_sizes))

    def forward(self, x, weights):
        """``weights``: the softmaxed arch row, shape (n_ops,)."""
        kmix = self.mixed_kernel(weights)
        bias = None
        if self.has_bias:
            bias = sum(w * getattr(self, f"bias_{k}")
                       for w, k in zip(weights, self.kernel_sizes))
        conv = F.conv3d if self.ndim_spatial == 3 else F.conv2d
        return conv(x, kmix, bias, stride=self.stride,
                    padding=(max(self.kernel_sizes) - self.stride) // 2)


class MixedConvTranspose(nn.Module):
    """``Cell_upconv``/``MixedOp_upconv`` (networks.py:486-511): x2
    upsampling, the softmax mixture fused into one k8-s2-p3 transposed
    conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True):
        super().__init__()
        for k in KERNEL_SIZES:
            self.register_parameter(f"kernel_{k}", nn.Parameter(
                torch.empty(in_channels, out_channels, k, k)))
            self.register_parameter(f"bias_{k}", nn.Parameter(
                torch.zeros(out_channels)) if bias else None)
        self.has_bias = bias

    def mixed_kernel(self, weights):
        return _embed([getattr(self, f"kernel_{k}") for k in KERNEL_SIZES],
                      weights, KERNEL_SIZES[-1])

    def forward(self, x, weights):
        """``weights``: the softmaxed arch row, shape (3,)."""
        kmix = self.mixed_kernel(weights)
        bias = None
        if self.has_bias:
            bias = sum(w * getattr(self, f"bias_{k}")
                       for w, k in zip(weights, KERNEL_SIZES))
        return F.conv_transpose2d(x, kmix, bias, stride=2, padding=3)
