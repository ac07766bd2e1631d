"""Tracing and step timing — the port of
``semantic_segmentation_tpu/core/profiling.py``.

- ``trace(dir)``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``<dir>/trace.json``, the CPU ops and, where CUDA is
  available, the device's kernels); it does nothing for ``dir = ''``.
- ``StepTimer``: host-side rolling step timing with the first steps
  excluded.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque


@contextlib.contextmanager
def trace(log_dir: str):
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling throughput meter; the first ``skip`` steps (warm-up) are
    excluded from statistics."""

    def __init__(self, window: int = 50, skip: int = 2):
        self._times: deque[float] = deque(maxlen=window)
        self._skip = skip
        self._last = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self._skip:
                self._times.append(now - self._last)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    @property
    def mean_step_ms(self) -> float:
        if not self._times:
            return 0.0
        return 1000.0 * sum(self._times) / len(self._times)
