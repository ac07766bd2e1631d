"""The global-batch reductions of data parallelism, with their gradients.

The JAX package's data parallelism is SPMD placement: the sharded step is
the single-device program over the global batch, XLA inserting the
collectives (``semantic_segmentation_tpu/parallel/data_parallel.py``). Here
each rank runs its rows of the global batch and the program says where the
batch meets itself:

- ``batch_var_mean``: batch-norm statistics over the global batch;
- ``all_reduce_sum``: a sum over ranks whose backward is the same sum (the
  Dice ratio of ``reduce_batch_first`` folds the global intersection and
  set sums; the unrolled hypergradient's inner gradients);
- ``global_min_max``: the fake batch's min and max, the gradient sent to the
  element that holds an extreme on whichever rank holds it, split evenly
  between ties as the single-device ``min()``/``max()`` do;
- ``mean_over_ranks``: a logged loss or metric of the global batch;
- ``all_reduce_grads``: the parameter gradients, averaged before every
  optimizer step;
- ``rows``: this rank's rows of a draw made at the global batch's shape.

Each rank's loss is its share of the global one: the global loss is the
mean over ranks of the local losses (a mean over the local rows, plus terms
that every rank computes alike from all-reduced sums). Its backward, with
every collective's backward an all-reduce sum, then averaged over ranks,
is the global loss's gradient.

Every function is the identity (or the plain reduction) when no process
group is up, and collective whenever one is, a group of one rank included:
such a group gives the plain values exactly.
``replicated()`` turns them off for code that runs the whole batch on
every rank (evaluation) or on one rank (rank 0's panels). Only
``all_reduce`` and ``broadcast`` are used: they run on NCCL, on gloo, and
on gloo with CUDA tensors.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

_replicated = [False]

# the gradient all-reduces since the last reset: calls, bytes, seconds
# (seconds end in a device sync when ``timed`` is set)
GRAD_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}

# elements per flat all-reduce buffer
_BUCKET = 1 << 26


def reset_grad_stats(timed: bool | None = None):
    GRAD_STATS.update(calls=0, bytes=0, seconds=0.0)
    if timed is not None:
        GRAD_STATS["timed"] = timed


def active() -> bool:
    """Whether the reductions are collective: a process group is up and no
    ``replicated()`` block is open."""
    return (dist.is_available() and dist.is_initialized()
            and not _replicated[0])


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """Rank 0, or no process group: the process that writes files."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


@contextlib.contextmanager
def replicated():
    """Every reduction local inside the block: for code that runs the same
    whole batch on every rank, or on rank 0 alone."""
    prev = _replicated[0]
    _replicated[0] = True
    try:
        yield
    finally:
        _replicated[0] = prev


def global_batch(n_local: int) -> int:
    return n_local * world()


def rows(x, n_local: int, dim: int = 0):
    """This rank's ``n_local`` rows (along ``dim``) of ``x``, a draw made
    at the global batch's shape."""
    w = world()
    if w == 1:
        return x
    if x.shape[dim] != n_local * w:
        raise ValueError(f"a draw of {x.shape[dim]} rows along dim {dim}: "
                         f"the global batch of {w} ranks x {n_local} rows "
                         "was expected")
    return x.narrow(dim, rank() * n_local, n_local)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # differentiable: the unrolled hypergradient takes its gradient
        return _AllReduceSum.apply(g)


def all_reduce_sum(x):
    """The sum of ``x`` over ranks, on every rank; its backward sums the
    gradients over ranks."""
    return _AllReduceSum.apply(x) if active() else x


def mean_over_ranks(x):
    """The mean of ``x`` over ranks (the global value of a mean over equal
    shards), differentiable."""
    return all_reduce_sum(x) / world() if active() else x


def _flat_groups(tensors):
    """Indices of ``tensors`` grouped by (dtype, device), in buckets of at
    most ``_BUCKET`` elements."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        bucket, size = [], 0
        for i in idx:
            n = tensors[i].numel()
            if bucket and size + n > _BUCKET:
                yield bucket
                bucket, size = [], 0
            bucket.append(i)
            size += n
        if bucket:
            yield bucket


def mean_over_ranks_list(tensors: list) -> list:
    """``mean_over_ranks`` of each tensor (None stays None), through flat
    buffers: one all-reduce per bucket, differentiable."""
    if not active():
        return list(tensors)
    out = list(tensors)
    live = [i for i, t in enumerate(tensors) if t is not None]
    ts = [tensors[i] for i in live]
    w = world()
    for bucket in _flat_groups(ts):
        flat = torch.cat([ts[i].reshape(-1) for i in bucket])
        flat = _AllReduceSum.apply(flat) / w
        for i, piece in zip(bucket, torch.split(
                flat, [ts[i].numel() for i in bucket])):
            out[live[i]] = piece.view_as(ts[i])
    return out


@torch.no_grad()
def all_reduce_grads(params):
    """Average the ``.grad`` of ``params`` over ranks, in place, before an
    optimizer step (flat buffers, one all-reduce per bucket). Counts the
    calls, bytes and seconds in ``GRAD_STATS``."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    timed = GRAD_STATS["timed"] and grads[0].is_cuda
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = world()
    for bucket in _flat_groups(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat)
        flat /= w
        for i, piece in zip(bucket, torch.split(
                flat, [grads[i].numel() for i in bucket])):
            grads[i].copy_(piece.view_as(grads[i]))
        GRAD_STATS["calls"] += 1
        GRAD_STATS["bytes"] += flat.numel() * flat.element_size()
    if timed:
        torch.cuda.synchronize()
    GRAD_STATS["seconds"] += time.perf_counter() - t0


@torch.no_grad()
def broadcast_(tensors, src: int = 0):
    """Copy rank ``src``'s values of ``tensors`` to every rank, in place
    (flat buffers, one broadcast per bucket). A no-op without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    ts = list(tensors)
    for bucket in _flat_groups(ts):
        flat = torch.cat([ts[i].reshape(-1) for i in bucket])
        dist.broadcast(flat, src)
        for i, piece in zip(bucket, torch.split(
                flat, [ts[i].numel() for i in bucket])):
            ts[i].copy_(piece.view_as(ts[i]))


def batch_var_mean(x, dims):
    """(biased variance, mean) of ``x`` over ``dims``, taken over the
    global batch: each rank's ``torch.var_mean``, combined over the equal
    shards (the mean of the means, then the mean of each shard's variance
    plus its mean's squared deviation; two all-reduces). A group of one
    rank gives ``torch.var_mean``'s values exactly."""
    var, mean = torch.var_mean(x, dim=dims, unbiased=False)
    if not active():
        return var, mean
    w = world()
    g_mean = all_reduce_sum(mean) / w
    return all_reduce_sum(var + (mean - g_mean) ** 2) / w, g_mean


class _GlobalMinMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ext = torch.stack([x.max(), -x.min()])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX)
        hi, lo = ext[0], -ext[1]
        is_hi, is_lo = x == hi, x == lo
        counts = torch.stack([is_hi.sum(), is_lo.sum()]).to(x.dtype)
        dist.all_reduce(counts)
        ctx.save_for_backward(is_hi, is_lo, counts)
        return lo.clone(), hi.clone()

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        is_hi, is_lo, counts = ctx.saved_tensors
        zero = counts.new_zeros(())
        g = _AllReduceSum.apply(torch.stack([
            zero if g_lo is None else g_lo, zero if g_hi is None else g_hi]))
        return is_lo * (g[0] / counts[1]) + is_hi * (g[1] / counts[0])


def global_min_max(x):
    """(min, max) of ``x`` over the global batch. The gradient of each goes
    to the elements that hold it, on whichever rank, split evenly between
    ties."""
    if not active():
        return x.min(), x.max()
    return _GlobalMinMax.apply(x)
