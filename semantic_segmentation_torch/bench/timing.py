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
TRACES = 16                     # profiler traces device_ms takes at most
WARMUP_CALLS = 3                # calls in a trace's warm-up step
STEP_MARGIN_S = 0.01            # idle host time at each end of a step
_flush_buf: list = []


def _device_kernels(calls):
    """(the device kernels of ``calls()`` in start order, the kernel
    launches the host made), from a torch.profiler trace whose warm-up
    step runs ``calls`` too and keeps nothing. In long-lived processes on
    the H100 the profiler dropped device events of some traces: part or
    all of them, at times the first 4 or 5 of 30 in every trace of one
    call, and a device timestamp once fell 159 us before its launch on the
    host's clock. So each step leaves ``STEP_MARGIN_S`` of idle time at
    both ends, that a kernel near a step's edge is not cut by an error in
    the clocks' alignment, and the launches on the host's side of the same
    trace say how many kernels there were."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(STEP_MARGIN_S)
            calls()
            torch.cuda.synchronize()
            time.sleep(STEP_MARGIN_S)
            prof.step()
    events = prof.events()
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
    launches = sum(e.device_type != torch.autograd.DeviceType.CUDA
                   and "LaunchKernel" in e.name for e in events)
    return kernels, launches


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
    per call, over ``iters`` calls, from torch.profiler. Warm: the calls run
    back to back, their inputs in L2. ``cold``: ``flush_l2`` runs before
    each call and its kernel is left out of the sum; the flushes divide the
    trace into calls, and the mean is over the calls the trace holds whole.
    Each trace starts with a warm-up step (``_device_kernels``). The
    profiler now and then records no device activity, or drops a call's
    events: a trace that holds less than 90% of the kernels the host
    launched, or of the calls (warm with ``kernel``: of the kernels), is
    taken again, after one more untimed call, up to ``TRACES`` times in
    all. Raises RuntimeError, with what the last trace held, when none
    does: a number returned here is always the profiler's device time."""
    import torch

    def run(n):
        for _ in range(n):
            if cold:
                flush_l2()
            fn()

    for _ in range(3):
        fn()
    for _ in range(TRACES):
        fn()
        torch.cuda.synchronize()
        warm = iter((WARMUP_CALLS, iters))
        kernels, launches = _device_kernels(lambda: run(next(warm)))
        if len(kernels) < 0.9 * launches:
            continue
        spans = [e.time_range.end - e.time_range.start for e in kernels
                 if FLUSH_KERNEL not in e.name
                 and (kernel is None or kernel in e.name)]
        if cold:
            calls, cur = [], None        # the kernels after each flush
            for e in kernels:
                if FLUSH_KERNEL in e.name:
                    if cur:
                        calls.append(sum(cur))
                    cur = []
                elif cur is not None and (kernel is None or kernel in e.name):
                    cur.append(e.time_range.end - e.time_range.start)
            if cur:
                calls.append(sum(cur))
            if len(calls) >= 0.9 * iters:
                return sum(calls) / 1e3 / len(calls)
        elif kernel is not None and 0.9 * iters <= len(spans) <= iters:
            return sum(spans) / 1e3 / len(spans)
        elif kernel is None and spans:
            return sum(spans) / 1e3 / iters
    names = sorted({e.name[:48] for e in kernels})
    raise RuntimeError(
        f"device_ms: {TRACES} profiler traces without 90% of {iters} "
        f"{'cold ' if cold else ''}calls{' of ' + kernel if kernel else ''} "
        f"(the last: {len(kernels)} of {launches} launched kernels, names "
        f"{names})")


def call_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches, in
    order (torch.profiler, after a warm-up call and a warm-up step). A trace
    that holds fewer kernels than the host launched is taken again, up to
    three times in all."""
    import torch
    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        kernels, launches = _device_kernels(fn)
        names = [e.name for e in kernels]
        if names and len(names) >= launches:
            break
    return names
