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
kernel runs only in its benchmark script. ``conv_down4_plan`` picks the
kernel's tiling (path, swap-AB, split-K, workspace) from the shapes alone,
so the CPU tests can check it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.kernels.build import launch

SMS = 132                # streaming multiprocessors of an H100 SXM
K_TILE = 64              # k per pipeline stage of the wgmma path
N_TILE = 64              # C_out per tile (one TMA box of the weight)
SWAP_ROWS = (8, 16, 32, 64)   # pixel tiles of swap-AB: wgmma N


class ConvDown4Plan(NamedTuple):
    """How ``conv_down4.cu`` tiles one call. ``path`` is "wgmma" (C_in and
    C_out multiples of 8) or "generic" (element gathers, 64x64 tiles, no
    split). A tile is ``rows`` output pixels by ``N_TILE`` output channels;
    with ``swap`` (M < 64) the weight is wgmma's A operand, so C_out fills
    its 64 rows and the pixels its N; with ``x_tma`` the pixel tile arrives
    as one TMA box (``x_tma_box``), else by cp.async. The ``k_tiles``
    K-tiles of 64 (of 32 on the generic path) are cut into ``split``
    ranges of ``k_per_split`` (the last may be shorter), one CTA each per
    tile; with ``split > 1`` the f32 partials need ``workspace_bytes`` and
    ``tiles`` ticket counters."""
    path: str
    swap: bool
    x_tma: bool
    rows: int
    tiles: int
    k_tiles: int
    split: int
    k_per_split: int
    ctas: int
    workspace_bytes: int


def split_k(tiles: int, k_tiles: int) -> tuple[int, int]:
    """(split, k_per_split): the fewest ranges of whole K-tiles, all of one
    length but the last, that give ``tiles * split >= SMS`` CTAs, or one
    K-tile per range where K is too short for that."""
    want = math.ceil(SMS / tiles)
    while True:
        per = math.ceil(k_tiles / want)
        split = math.ceil(k_tiles / per)
        if tiles * split >= SMS or per == 1:
            return split, per
        want += 1


def x_tma_box(rows: int, ho: int, wo: int, c_in: int):
    """(tb, th, tw): the pixel tile as one TMA box of tb images x th output
    rows x tw output columns, or None where the tiles do not fall on whole
    output rows and images or a K-tile spans two taps (C_in % 64)."""
    tw = min(wo, rows)
    th = min(ho, rows // tw)
    tb = rows // (tw * th)
    if (c_in % K_TILE or wo % tw or rows % tw or ho % th or (rows // tw) % th
            or tb * th * tw != rows or tb > 256):
        return None
    return tb, th, tw


def conv_down4_plan(b: int, h: int, w: int, c_in: int,
                    c_out: int) -> ConvDown4Plan:
    """The tiling of one ``conv_down4`` call: enough CTAs (split-K) to
    cover the card's ``SMS`` where K allows, swap-AB where M < 64."""
    m = b * (h // 2) * (w // 2)
    k = 16 * c_in
    if c_in % 8 or c_out % 8:
        tiles = math.ceil(m / 64) * math.ceil(c_out / 64)
        return ConvDown4Plan("generic", False, False, 64, tiles,
                             math.ceil(k / 32), 1, math.ceil(k / 32), tiles,
                             0)
    swap = m < 64
    rows = next(r for r in SWAP_ROWS if r >= m) if swap else 64
    tiles = math.ceil(m / rows) * math.ceil(c_out / N_TILE)
    k_tiles = k // K_TILE
    split, per = split_k(tiles, k_tiles)
    ws = split * tiles * rows * N_TILE * 4 if split > 1 else 0
    # 8- and 16-pixel tiles gather faster by cp.async than by a TMA box
    # (measured at G_d7 and G_d8: PERF.md)
    x_tma = rows >= 32 and x_tma_box(rows, h // 2, w // 2, c_in) is not None
    return ConvDown4Plan("wgmma", swap, x_tma, rows, tiles, k_tiles, split,
                         per, tiles * split, ws)


def conv_down4_k_ranges(plan: ConvDown4Plan) -> list[tuple[int, int]]:
    """The [start, stop) K-tile range of each split, as the kernel cuts
    them."""
    return [(s * plan.k_per_split,
             min(plan.k_tiles, (s + 1) * plan.k_per_split))
            for s in range(plan.split)]


_tickets: dict = {}      # device -> int32 arrival counters, kept at zero


def _ticket_buffer(device, n: int):
    """Zeroed int32 counters for ``n`` tiles on ``device``, allocated once
    (grown as needed) and reused: the kernel leaves them at zero."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


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
    CPU tensor through ``conv_down4_ref``. Inputs that require grad are
    refused."""
    kernels.refuse_grad("conv_down4", x, w)
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
    return launch_with_plan(x, w, conv_down4_plan(b, h, wd, c, w.shape[-1]))


def launch_with_plan(x, w, plan: ConvDown4Plan):
    """Launch the kernel on contiguous bf16 CUDA tensors with ``plan``:
    ``conv_down4``'s own, or a variant of it that
    ``scripts/sweep_torch_conv_down.py`` times. The C entry point refuses a
    plan it does not take."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    if plan.tiles >= 2**31 or plan.split > 65535:
        raise ValueError(f"conv_down4: {plan} exceeds the grid, "
                         f"{tuple(x.shape)}")
    if plan.path == "wgmma":
        # cp.async and TMA read 16-byte chunks: a view at an odd offset is
        # copied to a fresh (aligned) allocation
        x = x if x.data_ptr() % 16 == 0 else x.clone()
        w = w if w.data_ptr() % 16 == 0 else w.clone()
    out = torch.empty(b, h // 2, wd // 2, cout, dtype=torch.bfloat16,
                      device=x.device)
    ws = tickets = None
    if plan.split > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=x.device)
        tickets = _ticket_buffer(x.device, plan.tiles)
    launch("conv_down4", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
           ws.data_ptr() if ws is not None else None,
           tickets.data_ptr() if tickets is not None else None,
           b, h, wd, c, cout, plan.rows if plan.path == "wgmma" else 0,
           int(plan.swap), int(plan.x_tma), plan.split, plan.k_per_split)
    return out
