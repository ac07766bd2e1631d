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
- ``rows``: this rank's rows of a draw made at the global batch's shape;
- ``merge_slices`` (into a zero buffer from ``like``) and ``sum_over``:
  the exchanges of a named group, counted in the caller's statistics (the
  channel gathers of ``parallel/tensor_parallel.py``, the depth halos of
  ``parallel/spatial.py``).

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

The reductions run over the mesh's ``data`` axis: the whole group unless a
2-D mesh (``parallel/mesh.make_dp_tp_mesh``) or a spatial mesh
(``parallel/spatial.py``) names a subgroup for the duration of a step
(``axes``). On a (data, model) mesh the ranks of one model group hold the
same rows and different channels, so the batch meets itself over the data
group only; the model group's own traffic (the channel gathers of
``parallel/tensor_parallel.py``) runs on the group each sharded parameter
names (``TP_SHARD``) and does not turn off under ``replicated()``.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

_replicated = [False]

# the process group the reductions run over (``axes``; None: every rank)
_AXES = {"data": None}

# the attribute ``tensor_parallel.shard_state_tp`` sets on a channel-sharded
# parameter: (sharded dim, model group, model size)
TP_SHARD = "tp_shard"

# the gradient all-reduces since the last reset: calls, bytes, seconds
# (seconds end in a device sync when ``timed`` is set)
GRAD_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}

# elements per flat all-reduce buffer
_BUCKET = 1 << 26

_HALF = (torch.float16, torch.bfloat16)


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
    """The size of the data axis: 1 where the reductions are off."""
    return dist.get_world_size(_AXES["data"]) if active() else 1


def rank() -> int:
    """This process's index along the data axis."""
    return dist.get_rank(_AXES["data"]) if active() else 0


@contextlib.contextmanager
def axes(data=None):
    """The reductions over the process group ``data`` (None: every rank)
    inside the block."""
    prev = _AXES["data"]
    _AXES["data"] = data
    try:
        yield
    finally:
        _AXES["data"] = prev


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


def dense_view(x):
    """``x`` as a contiguous view of its own memory (a permutation of a
    dense tensor in any memory format: channels-last too), so that a
    collective can reduce it in place."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    v = x.permute(order)
    if not v.is_contiguous():
        raise ValueError(f"a tensor of strides {x.stride()} is not dense")
    return v


def like(x, shape):
    """Zeros of ``shape`` in ``x``'s dtype, device and memory format
    (NCHW, or channels-last as cuDNN and oneDNN keep an activation whose
    input was a permuted NHWC batch): a gathered activation keeps the
    layout, so the layers after it run the same kernels as without the
    mesh."""
    fmt = torch.contiguous_format
    if not x.is_contiguous():
        for f, nd in ((torch.channels_last, 4), (torch.channels_last_3d, 5)):
            if x.dim() == nd and x.is_contiguous(memory_format=f):
                fmt = f
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt).zero_()


def all_reduce_counted(t, group, stats: dict):
    """``dist.all_reduce`` of the dense tensor ``t`` in place over
    ``group`` (a no-op without a process group), counted in ``stats``."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    t0 = time.perf_counter()
    dist.all_reduce(dense_view(t), group=group)
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    stats["seconds"] += time.perf_counter() - t0


def sum_over(group, x, stats: dict):
    """A new tensor in ``x``'s layout: ``x`` summed over ``group`` (half
    types in float32). Without a process group, a copy of ``x``."""
    y = x.float() if x.dtype in _HALF else x.clone()
    all_reduce_counted(y, group, stats)
    return y.to(x.dtype)


def merge_slices(group, buf, stats: dict):
    """``buf``, a zero-filled buffer in which each rank of ``group`` wrote
    its own elements, with every rank's elements, in place: its bytes
    summed as uint8 (one rank's bytes and zeros: exact, whatever the
    dtype, and no wider than it)."""
    all_reduce_counted(dense_view(buf).view(torch.uint8), group, stats)
    return buf


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # differentiable: the unrolled hypergradient takes its gradient
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x):
    """The sum of ``x`` over the data axis, on every rank; its backward
    sums the gradients over the data axis."""
    return _AllReduceSum.apply(x, _AXES["data"]) if active() else x


def global_norm(tensors, like=None):
    """The Euclidean norm of ``tensors`` taken whole (float32 squares): a
    tensor whose counterpart in ``like`` (its parameter) is a channel shard
    (``TP_SHARD``) adds its model group's squares. Without shards, the
    plain norm."""
    tensors = list(tensors)
    like = [None] * len(tensors) if like is None else list(like)
    total, parts = 0.0, {}
    for t, w in zip(tensors, like):
        sq = t.float().pow(2).sum()
        shard = getattr(w, TP_SHARD, None)
        if shard is None:
            total = total + sq
        else:                      # summed per model group
            group, part = parts.get(id(shard[1]), (shard[1], 0.0))
            parts[id(shard[1])] = (group, part + sq)
    for group, part in parts.values():
        part = part.detach().clone()
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(part, group=group)
        total = total + part
    return torch.sqrt(total)


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
        flat = _AllReduceSum.apply(flat, _AXES["data"]) / w
        for i, piece in zip(bucket, torch.split(
                flat, [ts[i].numel() for i in bucket])):
            out[live[i]] = piece.view_as(ts[i])
    return out


@torch.no_grad()
def all_reduce_grads(params):
    """Average the ``.grad`` of ``params`` over the data axis, in place,
    before an optimizer step (flat buffers, one all-reduce per bucket).
    Counts the calls, bytes and seconds in ``GRAD_STATS``."""
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
        dist.all_reduce(flat, group=_AXES["data"])
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
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=_AXES["data"])
        hi, lo = ext[0], -ext[1]
        is_hi, is_lo = x == hi, x == lo
        counts = torch.stack([is_hi.sum(), is_lo.sum()]).to(x.dtype)
        dist.all_reduce(counts, group=_AXES["data"])
        ctx.save_for_backward(is_hi, is_lo, counts)
        return lo.clone(), hi.clone()

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        is_hi, is_lo, counts = ctx.saved_tensors
        zero = counts.new_zeros(())
        g = _AllReduceSum.apply(torch.stack([
            zero if g_lo is None else g_lo, zero if g_hi is None else g_hi]),
            _AXES["data"])
        return is_lo * (g[0] / counts[1]) + is_hi * (g[1] / counts[0])


def global_min_max(x):
    """(min, max) of ``x`` over the global batch. The gradient of each goes
    to the elements that hold it, on whichever rank, split evenly between
    ties."""
    if not active():
        return x.min(), x.max()
    return _GlobalMinMax.apply(x)
