"""Timing on the card, and the H100's published peaks for bounds.

Every function here needs a CUDA device; none runs at import.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12       # HBM3
H100_BF16_OPS_PER_S = 989e12     # tensor cores
H100_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = H100_F32_OPS_PER_S):
    """(least time in ms, 'bytes' or 'operations'): the larger of the bytes
    over the memory rate and the operations over ``ops_per_s``."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def time_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events: what a caller waits for, host launch overhead
    included when the calls are too short to queue ahead of the device."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


FLUSH_BYTES = 96 << 20          # written between cold launches: > 50 MB L2
FLUSH_KERNEL = "bitwise_not"    # the flush's kernel, left out of the sums
_flush_buf: list = []


def flush_l2():
    """Evict the L2 cache: one in-place pass over ``FLUSH_BYTES`` (read and
    written back), a kernel whose name holds ``FLUSH_KERNEL``."""
    import torch
    if not _flush_buf:
        _flush_buf.append(torch.zeros(FLUSH_BYTES, dtype=torch.uint8,
                                      device="cuda"))
    _flush_buf[0].bitwise_not_()


def device_ms(fn, iters: int, kernel: str | None = None,
              cold: bool = False):
    """Device time per call of ``fn``: the summed durations of the device
    kernels it launches (only those whose name holds ``kernel``, if given)
    over ``iters`` calls, from torch.profiler. Warm: the calls run back to
    back, their inputs in L2. ``cold``: ``flush_l2`` runs before each call
    and its kernel is left out of the sum. A trace that holds no such
    kernel (the profiler now and then records no device activity) is taken
    again, up to three times in all; then ``time_ms`` stands in, and says
    so (warm only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush_l2()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        flushes = sum(FLUSH_KERNEL in e.name for e in kernels)
        spans = [e.time_range.end - e.time_range.start for e in kernels
                 if FLUSH_KERNEL not in e.name
                 and (kernel is None or kernel in e.name)]
        if spans and (not cold or flushes == iters):
            return sum(spans) / 1e3 / iters
    if cold:
        raise RuntimeError(f"cold timing: no trace held the {iters} L2 "
                           f"flushes and a kernel {kernel or ''}")
    print(f"[timing] no device kernel{' ' + kernel if kernel else ''} "
          "in three profiler traces: CUDA events instead")
    return time_ms(fn, iters)
