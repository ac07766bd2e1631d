"""The k4-s2-p1 down-conv at the flagship's layer shapes, three ways — the
port of ``scripts/bench_conv_down.py``:

- ``cudnn``: ``F.conv2d`` in bf16 on channels_last tensors, the counterpart
  of that script's ``xla`` form; a yardstick only, the port never calls it
  for this function;
- ``kernel``: ``ops/conv.conv_down4``, the hand-written implicit GEMM (the
  port of ``conv_pallas``); C_in < 8 records its ``NotImplementedError``;
- ``plain``: ``ops/conv.conv_down4_ref``.

Batch 2, seeded numpy inputs (x ~ N(0, 1), w ~ 0.05 N(0, 1), cast to bf16).
Per form: the error against ``cudnn`` (max |out - ref| / max |ref|) and the
forward device time (torch.profiler, inputs warm in L2); for ``kernel`` and
``cudnn`` also the cold time (``_cold_us``: L2 flushed by a 96 MiB pass
before each launch, the flush left out of the sum), since at G_d5..G_d8 the
8.4 MB weight fits in the 50 MB L2 and a warm time can fall under the HBM
bytes bound; forward+backward for ``cudnn`` only, as the JAX script does
for ``xla``; the kernel's error against ``plain`` and its plan (path, tile,
split, swap-AB: ``ops/conv.conv_down4_plan``). The bound per layer is
max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s), bytes = 2 (input + weight +
output elements), FLOPs = 2 B Ho Wo 16 C_in C_out; ``bound_share`` is the
bound over the kernel's warm time (``bound_share_cold``: over its cold
time). One JSON line per layer, then a summary line with sums weighted by
``mult``, the layer's uses per engine iteration, warm and cold.

    python -m semantic_segmentation_torch.bench.conv_down [--fast]

``--fast`` skips the layers under 16^2, as the JAX script does.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from semantic_segmentation_torch.bench.timing import (H100_BF16_OPS_PER_S,
                                                      bound_ms, card_line,
                                                      device_ms)
from semantic_segmentation_torch.ops.conv import (conv_down4, conv_down4_plan,
                                                  conv_down4_ref)

BATCH = 2
# (tag, H = W, C_in, C_out, mult): every k4-s2-p1 conv of the flagship's
# engine iteration (scripts/bench_conv_down.py:53-65)
LAYERS = [
    ("G_d1", 256, 1, 64, 3.0),
    ("G_d2", 128, 64, 128, 3.0),
    ("G_d3", 64, 128, 256, 3.0),
    ("G_d4", 32, 256, 512, 3.0),
    ("G_d5", 16, 512, 512, 3.0),
    ("G_d6", 8, 512, 512, 3.0),
    ("G_d7", 4, 512, 512, 3.0),
    ("G_d8", 2, 512, 512, 3.0),
    ("D_c0", 256, 2, 64, 2.0),
    ("D_c1", 128, 64, 128, 2.0),
    ("D_c2", 64, 128, 256, 2.0),
]
FORMS = ("cudnn", "kernel", "plain")
COLD_FORMS = ("cudnn", "kernel")
ITERS = 30                      # timed calls per form and layer


def layer_inputs(hw: int, cin: int, cout: int, rng: np.random.Generator,
                 device):
    """x (B, hw, hw, C_in) and w (4, 4, C_in, C_out), bf16 on ``device``."""
    x = torch.from_numpy(rng.standard_normal((BATCH, hw, hw, cin)))
    w = torch.from_numpy(0.05 * rng.standard_normal((4, 4, cin, cout)))
    return (x.to(device=device, dtype=torch.bfloat16),
            w.to(device=device, dtype=torch.bfloat16))


def layer_bound(hw: int, cin: int, cout: int):
    """(bound in ms, 'bytes' or 'operations') of one forward at batch 2."""
    ho = hw // 2
    n_bytes = 2 * (BATCH * hw * hw * cin + 16 * cin * cout
                   + BATCH * ho * ho * cout)
    flops = 2 * BATCH * ho * ho * 16 * cin * cout
    return bound_ms(n_bytes, flops, H100_BF16_OPS_PER_S)


def _rel_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-9))


def measure_layer(tag, hw, cin, cout, mult, rng, timing=True):
    """One layer's record: errors of each form against cuDNN and of the
    kernel against the plain version, and with ``timing`` the device
    microseconds of each form (forward) and of cuDNN forward+backward."""
    b, why = layer_bound(hw, cin, cout)
    row = {"layer": tag, "hw": hw, "cin": cin, "cout": cout, "mult": mult,
           "bound_us": b * 1e3, "bound_by": why}
    if cin >= 8:
        plan = conv_down4_plan(BATCH, hw, hw, cin, cout)
        row["plan"] = {k: getattr(plan, k) for k in (
            "path", "rows", "swap", "x_tma", "split", "k_per_split",
            "ctas")}
    x, w = layer_inputs(hw, cin, cout, rng, "cuda")
    x_nchw = x.permute(0, 3, 1, 2)                 # channels_last strides
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def cudnn():
        return F.conv2d(x_nchw, w_oihw, stride=2, padding=1).permute(
            0, 2, 3, 1)

    forms = {"cudnn": cudnn, "kernel": lambda: conv_down4(x, w),
             "plain": lambda: conv_down4_ref(x, w)}
    ref = cudnn()
    outs = {}
    for name, fn in forms.items():
        try:
            outs[name] = fn()
        except NotImplementedError as e:
            row[f"{name}_error"] = repr(e)[:160]
            continue
        row[f"{name}_err"] = _rel_err(outs[name], ref)
    if "kernel" in outs:
        row["kernel_vs_plain_err"] = _rel_err(outs["kernel"], outs["plain"])
        row["kernel_vs_plain_abs_err"] = float(
            (outs["kernel"].float() - outs["plain"].float()).abs().max())
    if not timing:
        return row
    for name in outs:
        symbol = "conv_down4" if name == "kernel" else None
        row[f"{name}_us"] = 1e3 * device_ms(forms[name], ITERS, symbol)
        if name in COLD_FORMS:
            row[f"{name}_cold_us"] = 1e3 * device_ms(forms[name], ITERS,
                                                     symbol, cold=True)
    if "kernel" in outs:
        row["bound_share"] = row["bound_us"] / row["kernel_us"]
        row["bound_share_cold"] = row["bound_us"] / row["kernel_cold_us"]
    xg = x_nchw.detach().requires_grad_(True)
    wg = w_oihw.detach().requires_grad_(True)
    gy = torch.randn(ref.permute(0, 3, 1, 2).shape, device="cuda",
                     dtype=torch.bfloat16)

    def cudnn_fwdbwd():
        y = F.conv2d(xg, wg, stride=2, padding=1)
        return torch.autograd.grad(y, (xg, wg), gy)

    row["cudnn_fwdbwd_us"] = 1e3 * device_ms(cudnn_fwdbwd, ITERS)
    return row


def summarize(rows) -> dict:
    """Sums weighted by ``mult``, warm and cold: over all layers (a form
    that does not take a layer counts cuDNN's time there, as the JAX script
    counts XLA's), and over the layers the kernel takes (C_in >= 8)."""
    def total(key, rows_, stand_in="cudnn_us"):
        return sum(r["mult"] * r.get(key, r.get(stand_in, 0.0))
                   for r in rows_)

    def cold(rows_):
        return {f: total(f"{f}_cold_us", rows_, "cudnn_cold_us")
                for f in COLD_FORMS}
    taken = [r for r in rows if "kernel_err" in r]
    return {
        "summary": "conv_down",
        "weighted_fwd_us": {f: total(f"{f}_us", rows) for f in FORMS},
        "weighted_fwd_cold_us": cold(rows),
        "weighted_fwdbwd_us": {"cudnn": total("cudnn_fwdbwd_us", rows)},
        "weighted_bound_us": total("bound_us", rows),
        "kernel_layers": [r["layer"] for r in taken],
        "kernel_layers_fwd_us": {f: total(f"{f}_us", taken) for f in FORMS},
        "kernel_layers_fwd_cold_us": cold(taken),
        "kernel_layers_bound_us": total("bound_us", taken),
    }


def run(fast: bool = False, timing: bool = True, emit=None):
    """Every layer of ``LAYERS`` (``fast``: only hw >= 16) on the card,
    with ``timing`` or only the errors. Returns (rows, summary; None without
    timing); ``emit`` is called with each record."""
    rng = np.random.default_rng(0)
    rows = []
    for tag, hw, cin, cout, mult in LAYERS:
        if fast and hw < 16:
            continue
        rows.append(measure_layer(tag, hw, cin, cout, mult, rng, timing))
        if emit:
            emit(rows[-1])
    summary = summarize(rows) if timing else None
    if emit and summary:
        emit(summary)
    return rows, summary


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench.conv_down needs a CUDA card")
    print(json.dumps({"card": card_line(),
                      "device": torch.cuda.get_device_name(0)}))
    run(fast="--fast" in argv,
        emit=lambda r: print(json.dumps(r), flush=True))


if __name__ == "__main__":
    main()
