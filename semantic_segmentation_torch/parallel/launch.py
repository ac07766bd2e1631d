"""Start the ranks of a data axis from one process (the reference BBDM's
``mp.spawn``, ``BBDM/main.py:70-127``).

``RankPool(n)`` starts ``n`` fresh processes (the ``spawn`` start method)
and joins them in one group through a file store in a temporary directory
(NCCL, rank r on ``cuda:r``; gloo on the CPU). It keeps them alive between
calls, for a harness that runs many steps on one group (the tests,
``chip_smoke.py``): ``pool.run(fn, *args)`` runs ``fn`` on every rank and
returns rank 0's result (arguments and results travel pickled through
pipes, tensors by value). When a rank fails or a call outlasts the pool's
``timeout``, the pool kills its ranks and raises. Its ranks may be asked
to join over gloo with CUDA tensors (``backend='gloo'``, all on
``cuda:0``): two ranks on one card, which NCCL refuses.

``run_ranks(fn, n, args)`` is one call on a pool of its own: how a trainer
started with ``run.data_axis`` > 1 runs itself on its ranks.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch

# how long ``run_ranks`` waits for its ranks (a whole training run)
JOIN_TIMEOUT = 24 * 3600.0


def _join(init_method: str, world: int, rank: int, device_type: str,
          backend: str | None, timeout: float):
    import torch.distributed as dist

    from semantic_segmentation_torch.parallel import mesh
    if backend is None or (backend == "nccl" and device_type == "cuda"):
        mesh.init_rank(init_method, world, rank, device_type)
        return
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def _pool_main(rank: int, world: int, init_method: str, device_type: str,
               backend: str | None, timeout: float, threads: int,
               log_level: int, tasks, results):
    import logging

    import torch.distributed as dist
    # the launcher's log level (rank 0 alone logs: core/logging_utils)
    logging.basicConfig(level=log_level, format="%(levelname)s: %(message)s")
    if threads:
        torch.set_num_threads(threads)
    try:
        _join(init_method, world, rank, device_type, backend, timeout)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = pickle.loads(task)
        try:
            out = fn(*args, **kwargs)
            # pickled here: a tensor put on a queue as it is would travel
            # through shared memory, which may be small
            results.put((rank, True, pickle.dumps(out) if rank == 0
                         else None))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            break
    dist.destroy_process_group()


class RankPool:
    """``n`` ranks joined in one group, kept between calls (module
    docstring), each with ``threads`` torch threads. A call that takes
    longer than ``timeout`` seconds kills the ranks and raises. Use as a
    context manager, or ``close()`` it."""

    def __init__(self, n: int, device_type: str = "cpu",
                 backend: str | None = None, timeout: float = 120.0,
                 threads: int = 1, workdir: str | None = None):
        import logging
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        level = logging.getLogger().getEffectiveLevel()
        self.n, self.timeout = n, timeout
        self._tmp = tempfile.mkdtemp(prefix="rankpool-", dir=workdir)
        init = f"file://{os.path.join(self._tmp, 'store')}"
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_pool_main, args=(
            r, n, init, device_type, backend, timeout, threads, level,
            self._tasks[r], self._results), daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        try:
            self._collect("joining the group")
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str):
        import queue
        deadline = time.monotonic() + self.timeout
        out, seen = None, 0
        while seen < self.n:
            try:
                rank, ok, value = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [p.exitcode for p in self._procs
                        if p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise TimeoutError(
                        f"rank pool, {what}: no answer in time (exit codes "
                        f"{[p.exitcode for p in self._procs]})")
                continue
            seen += 1
            if not ok:       # the others may wait at a collective: stop
                self.close()
                raise RuntimeError(f"rank pool, {what}, rank {rank}:\n"
                                   f"{value}")
            if rank == 0 and value is not None:
                out = pickle.loads(value)
        return out

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on every rank; rank 0's result."""
        task = pickle.dumps((fn, args, kwargs))
        for q in self._tasks:
            q.put(task)
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self):
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                try:
                    q.put(None)
                except Exception:
                    pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, n: int, args=(), device_type: str = "cpu"):
    """``fn(*args)`` on ``n`` new ranks in one group (a pool of its own,
    closed after); rank 0's result. ``fn`` must be importable by name (a
    module-level function). Each rank takes an n-th of this process's
    torch threads; the wait is ``JOIN_TIMEOUT`` seconds."""
    with RankPool(n, device_type, timeout=JOIN_TIMEOUT,
                  threads=max(1, torch.get_num_threads() // n)) as pool:
        return pool.run(fn, *args)
