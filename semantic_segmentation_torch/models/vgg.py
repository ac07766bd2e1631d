"""VGG16 features — the port of ``semantic_segmentation_tpu/models/vgg.py``:
the backbone of the soft-intro VAE's perceptual reconstruction loss
(``Soft-intro_VAE/loss.py:9-57``, VGGLoss over relu2_2 and relu3_3) and of
LPIPS(vgg) (``BBDM/model/VQGAN/lpips.py``).

``VGG16Features`` is torchvision's ``vgg16().features`` up to relu5_3 under
the JAX package's names (``conv0`` ... ``conv12``), NCHW; the ImageNet
weights map onto it with ``utils/torch_port.port_vgg16_features``. They are
not in the repository: without them the net runs on random weights, and the
perceptual numbers mean nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg16 'D' config up to relu5_3 (feature index 29)
CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
       512, 512, 512)
# taps after this many conv + relu pairs: relu1_2, relu2_2, relu3_3,
# relu4_3, relu5_3 (torch feature indices 3/8/15/22/29)
TAPS = (2, 4, 7, 10, 13)
# the lpips ScalingLayer constants
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """``forward(x)``: x NCHW (3 channels); returns the five taps
    (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), NCHW."""

    def __init__(self):
        super().__init__()
        c_in, i = 3, 0
        for c in CFG:
            if c != "M":
                self.add_module(f"conv{i}", nn.Conv2d(c_in, c, 3, 1, 1))
                c_in, i = c, i + 1

    def forward(self, x):
        taps, i = [], 0
        for c in CFG:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{i}")(x))
            i += 1
            if i in TAPS:
                taps.append(x)
        return tuple(taps)


def scaling_layer(x_nchw):
    """lpips's ScalingLayer: (x - shift) / scale per channel."""
    shift = torch.tensor(LPIPS_SHIFT, device=x_nchw.device).view(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=x_nchw.device).view(1, 3, 1, 1)
    return (x_nchw - shift) / scale


def unit_normalize(f, eps: float = 1e-10):
    """Each position's channel vector over its L2 norm (+ eps). NCHW."""
    return f / (f.square().sum(dim=1, keepdim=True).sqrt() + eps)


def lpips_from_features(fa, fb, lin_weights):
    """Sum over layers of the spatial mean of sum_c w_c (na - nb)^2, with
    na, nb the unit-normalized NCHW features. Returns (N,)."""
    total = 0.0
    for f_a, f_b, w in zip(fa, fb, lin_weights):
        w = torch.as_tensor(w, dtype=torch.float32,
                            device=f_a.device).view(1, -1, 1, 1)
        d = (unit_normalize(f_a) - unit_normalize(f_b)).square() * w
        total = total + d.sum(dim=1).mean(dim=(1, 2))
    return total


def _prep(x_nhwc):
    x = torch.as_tensor(x_nhwc).float()
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return x.permute(0, 3, 1, 2)


def vgg_lpips(net: VGG16Features, lin_weights, x, y):
    """taming-style LPIPS(vgg) (``BBDM/model/VQGAN/lpips.py`` forward):
    NHWC inputs in [-1, 1] (grayscale repeated to 3 channels), the scaling
    layer, the five taps, channel-unit-normalized, weighted by the learned
    per-channel ``lin_weights``, spatial mean, layer sum. Returns (N,)."""
    fx = net(scaling_layer(_prep(x)))
    fy = net(scaling_layer(_prep(y)))
    return lpips_from_features(fx, fy, lin_weights)


def vgg_perceptual_loss(feats_x, feats_y):
    """VGGLoss (loss.py:44-57): the MSE of relu2_2 plus that of relu3_3,
    float32."""
    return (F.mse_loss(feats_x[1].float(), feats_y[1].float())
            + F.mse_loss(feats_x[2].float(), feats_y[2].float()))
