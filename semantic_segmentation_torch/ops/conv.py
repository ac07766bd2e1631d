"""The k4-s2-p1 down-convolution as one implicit GEMM — the port of
``conv_pallas`` (``scripts/bench_conv_down.py:133-223``), the down-conv of
the unet_256 generator and the PatchGAN, forward only.

The public function keeps the JAX contract: NHWC input (B, H, W, C_in), HWIO
weight (4, 4, C_in, C_out), no bias, stride 2, pad 1, H and W even, output
(B, H/2, W/2, C_out). C_in < 8 raises ``NotImplementedError`` as
``conv_pallas`` does (those layers keep the library convolution).

``conv_down4`` is the wrapper of the CUDA kernel ``kernels/csrc/
conv_down4.cu`` (bf16 only): a CUDA tensor launches the kernel, a CPU tensor
runs ``conv_down4_ref``, the plain PyTorch version beside it. The port's nets
call ``nn.Conv2d``; the kernel runs in ``bench/conv_down.py``, as the TPU
kernel runs only in its benchmark script.
"""

from __future__ import annotations

import torch

from semantic_segmentation_torch.kernels.build import launch


def _check_shapes(x, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (
            4, 4, x.shape[-1]):
        raise ValueError(f"conv_down4 takes NHWC x and HWIO (4, 4, C_in, "
                         f"C_out) w, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv_down4 needs even H and W, got "
                         f"{tuple(x.shape)}")


def conv_down4_ref(x, w):
    """Plain version: the (B*Ho*Wo, 16*C_in) patch matrix from 16 shifted
    stride-2 views of the zero-padded input, in the (dy, dx, c) order of
    ``w.reshape(16*C_in, C_out)``, and one matmul accumulated in float32
    (``conv_tapmm_concat``, ``scripts/bench_conv_down.py:107-130``). Takes
    float32 or bfloat16 and returns the input's dtype."""
    _check_shapes(x, w)
    b, h, wd, c = x.shape
    ho, wo = h // 2, wd // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2, :]
            for dy in range(4) for dx in range(4)]
    patch = torch.stack(taps, dim=3).reshape(b * ho * wo, 16 * c)
    y = patch @ w.float().reshape(16 * c, -1)
    return y.reshape(b, ho, wo, -1).to(x.dtype)


def conv_down4(x, w):
    """k4-s2-p1 conv of an NHWC batch by an HWIO kernel, no bias. A CUDA
    tensor goes through the kernel (bf16 in and out, f32 accumulation); a
    CPU tensor through ``conv_down4_ref``."""
    _check_shapes(x, w)
    if x.shape[-1] < 8:
        raise NotImplementedError(
            f"conv_down4 requires C_in >= 8, got {x.shape[-1]}")
    if x.device.type == "cpu":
        return conv_down4_ref(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv_down4: x on {x.device}, w on {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the conv_down4 kernel takes bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    x, w = x.contiguous(), w.contiguous()
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    if (b * (h // 2) * (wd // 2) + 63) // 64 > 65535:
        raise ValueError(f"conv_down4: too many output pixels for the grid, "
                         f"{tuple(x.shape)}")
    out = torch.empty(b, h // 2, wd // 2, cout, dtype=torch.bfloat16,
                      device=x.device)
    launch("conv_down4", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
           b, h, wd, c, cout)
    return out
