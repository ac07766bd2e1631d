"""Spatial parallelism for 3D volumes — the port of
``semantic_segmentation_tpu/parallel/spatial.py``, with its names.

The JAX package shards the depth axis of NDHWC volumes over a ``spatial``
mesh axis, replicates the state, and lets XLA insert the halo exchanges,
the batch-norm reductions and the gradient reductions. Here the ranks of a
process group (``parallel/mesh.py``; gloo on the CPU, NCCL on cards) each
hold one depth slab of every volume and the whole state:

- ``halo``: the neighbours' boundary slices around this rank's slab
  (zeros at the volume's two ends), so a k3 conv with depth padding 0
  computes the slab of the whole volume's conv; its backward sends each
  halo's gradient back to the rank that owns those slices;
- ``gather_depth`` / ``split_depth``: a level too thin to split into even
  slabs runs whole on every rank, and splits again on the way up
  (``models/unet3d.py``);
- the batch-norm statistics, the loss's sums and the gradient mean reduce
  over the group (``parallel/collectives.py``, whose data axis the group
  is inside ``depth_sharded``).

Each rank's loss is its share of the global one (``collectives``'
convention: the global loss is the mean of the ranks' losses, and every
collective's backward sums over the ranks). The exchanges are all-reduces
of a zero-filled buffer in which each rank writes its slices, summed as
bytes (``collectives.merge_slices``: exact on NCCL, gloo, and gloo
with CUDA tensors). ``HALO_STATS`` counts them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from semantic_segmentation_torch.parallel import collectives
from semantic_segmentation_torch.parallel.collectives import (like,
                                                              merge_slices,
                                                              sum_over)
from semantic_segmentation_torch.parallel.mesh import (process_count,
                                                       process_index,
                                                       visible_devices)

# the exchanges since the last reset: calls, bytes, seconds
HALO_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}

# the spatial mesh the 3D nets' forwards run under (``depth_sharded``)
_ACTIVE = [None]

DEPTH = 2       # the depth axis of an NCDHW activation


def reset_halo_stats():
    HALO_STATS.update(calls=0, bytes=0, seconds=0.0)


@dataclass(frozen=True, eq=False)
class SpatialMesh:
    """A ``spatial`` axis of ``size`` ranks, this process ``rank``;
    ``group`` its process group (None without one)."""
    size: int
    rank: int = 0
    group: object = None
    device_type: str = "cuda"


def make_spatial_mesh(n_devices: int | None = None,
                      device_type: str = "cuda") -> SpatialMesh | None:
    """A spatial axis over the first ``n_devices`` ranks of the group
    (every rank must call it; None on a rank outside it), or, without a
    group, over that many devices, whose ranks a trainer starts. Raises
    when it needs more than there are."""
    have = (process_count() if dist.is_initialized()
            else visible_devices(device_type))
    n = n_devices or have
    if n > have:
        raise ValueError(f"spatial mesh {n} needs {n} devices, have {have}")
    if not dist.is_initialized():
        return SpatialMesh(n, 0, None, device_type)
    group = dist.group.WORLD if n == have else dist.new_group(list(range(n)))
    if process_index() >= n:
        return None
    return SpatialMesh(n, process_index(), group, device_type)


def spatial_mesh_from_config(cfg) -> SpatialMesh | None:
    """Consume ``cfg.run.spatial_axis`` (1 = off, 0 = every visible card,
    n = the first n). Raises for more ranks than cards."""
    n = cfg.run.spatial_axis
    device_type = torch.device(cfg.run.device).type
    if n < 0:
        raise ValueError(f"run.spatial_axis={n}")
    if n == 0:
        n = (process_count() if dist.is_initialized()
             else visible_devices(device_type))
    if n <= 1:
        return None
    return make_spatial_mesh(n, device_type)


@contextlib.contextmanager
def depth_sharded(mesh: SpatialMesh | None):
    """A block whose 3D forwards run on depth slabs of ``mesh`` and whose
    reductions run over its group (a no-op for None)."""
    if mesh is None:
        yield
        return
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        with collectives.axes(mesh.group):
            yield
    finally:
        _ACTIVE[0] = prev


def active_mesh() -> SpatialMesh | None:
    """The spatial mesh of the enclosing ``depth_sharded`` block."""
    return _ACTIVE[0]


def _depth_slab(x, mesh: SpatialMesh, axis: int):
    d = x.shape[axis]
    if d % mesh.size:
        raise ValueError(f"a depth of {d} does not split over the spatial "
                         f"mesh of {mesh.size}")
    c = d // mesh.size
    return x[(slice(None),) * axis + (slice(mesh.rank * c,
                                            (mesh.rank + 1) * c),)]


def volume_sharding(mesh: SpatialMesh):
    """The placement of an NDHWC volume: this rank's slab of axis 1 (the
    batch whole, so that a batch of one splits too)."""
    return lambda x: _depth_slab(x, mesh, 1)


def shard_volume_batch(mesh: SpatialMesh | None, batch):
    """This rank's depth slab of every array of ``batch`` (a dict, or one
    array) with 4 or more dimensions (N, D, ...); lower ranks whole."""
    if mesh is None:
        return batch
    place = volume_sharding(mesh)

    def put(x):
        return place(x) if getattr(x, "ndim", 0) >= 4 else x

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def replicate_state(mesh: SpatialMesh | None, state):
    """Rank 0's state on every rank (``data_parallel.replicate_state``):
    the activations, not the weights, are what the mesh splits."""
    from semantic_segmentation_torch.parallel.data_parallel import \
        replicate_state as broadcast_state
    return broadcast_state(mesh, state)


def _exchange(mesh, lo_out, hi_out):
    """Each rank's ``lo_out`` to the rank below it and ``hi_out`` to the
    rank above (None at the ends): one all-reduce of a zero buffer of
    (size, 2) slots. Returns (what the rank below sent up, what the rank
    above sent down), zeros at the ends."""
    ref = lo_out if lo_out is not None else hi_out
    buf = ref.new_zeros((mesh.size, 2) + tuple(ref.shape))
    r = mesh.rank
    if lo_out is not None and r > 0:
        buf[r - 1, 1] = lo_out
    if hi_out is not None and r < mesh.size - 1:
        buf[r + 1, 0] = hi_out
    merge_slices(mesh.group, buf, HALO_STATS)
    return buf[r, 0], buf[r, 1]


class _Halo(torch.autograd.Function):
    """[the rank below's last p slices, x, the rank above's first p]."""

    @staticmethod
    def forward(ctx, x, p, mesh):
        ctx.p, ctx.mesh = p, mesh
        if x.shape[DEPTH] < p:
            raise ValueError(f"a depth slab of {x.shape[DEPTH]} is thinner "
                             f"than its halo of {p}")
        # slot 0 of rank r: what rank r-1 sends up (its last slices), slot
        # 1: what rank r+1 sends down (its first slices)
        from_below, from_above = _exchange(
            mesh, x.narrow(DEPTH, 0, p), x.narrow(DEPTH, x.shape[DEPTH] - p,
                                                  p))
        return torch.cat([from_below, x, from_above], dim=DEPTH)

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, ctx.p, ctx.mesh), None, None


class _HaloAdjoint(torch.autograd.Function):
    """The halo's backward: the interior gradient plus the gradients the
    neighbours' halos took of this rank's boundary slices."""

    @staticmethod
    def forward(ctx, g, p, mesh):
        ctx.p, ctx.mesh = p, mesh
        d = g.shape[DEPTH] - 2 * p
        # the low halo's gradient goes down to the rank below (whose last
        # slices it was), the high halo's up; what comes up from below is
        # the gradient of this rank's first slices, what comes down from
        # above that of its last
        from_below, from_above = _exchange(
            mesh, g.narrow(DEPTH, 0, p), g.narrow(DEPTH, d + p, p))
        out = g.narrow(DEPTH, p, d).clone()
        out.narrow(DEPTH, 0, p).add_(from_below)
        out.narrow(DEPTH, d - p, p).add_(from_above)
        return out

    @staticmethod
    def backward(ctx, g):
        return _Halo.apply(g, ctx.p, ctx.mesh), None, None


def halo(x, p: int, mesh: SpatialMesh):
    """``x`` (N, C, d, H, W), this rank's depth slab, with ``p`` slices of
    each neighbour's around it (zeros at the volume's ends)."""
    return _Halo.apply(x, p, mesh)


class _GatherDepth(torch.autograd.Function):
    """The whole depth from the ranks' slabs; backward: the sum of the
    ranks' gradients of it, this rank's slab."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        d = x.shape[DEPTH]
        shape = list(x.shape)
        shape[DEPTH] = d * mesh.size
        buf = like(x, shape)
        buf.narrow(DEPTH, mesh.rank * d, d).copy_(x)
        return merge_slices(mesh.group, buf, HALO_STATS)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        d = g.shape[DEPTH] // mesh.size
        return sum_over(mesh.group, g, HALO_STATS).narrow(
            DEPTH, mesh.rank * d, d), None


class _SplitDepth(torch.autograd.Function):
    """This rank's slab of a whole-depth tensor that every rank holds;
    backward: its gradient in place, zeros elsewhere (each rank's share of
    the whole tensor's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.shape = mesh, x.shape
        d = x.shape[DEPTH] // mesh.size
        return x.narrow(DEPTH, mesh.rank * d, d).clone()

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        out = like(g, ctx.shape)
        d = g.shape[DEPTH]
        out.narrow(DEPTH, mesh.rank * d, d).copy_(g)
        return out, None


def gather_depth(x, mesh: SpatialMesh):
    return _GatherDepth.apply(x, mesh)


def split_depth(x, mesh: SpatialMesh):
    return _SplitDepth.apply(x, mesh)
