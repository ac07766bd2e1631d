"""The data mesh as a process group — the port of
``semantic_segmentation_tpu/parallel/mesh.py``, with its names.

The JAX package's mesh is a ``data`` axis of devices; batches are sharded
on axis 0 and the state is replicated. Its torch counterpart is a process
group with one rank per card: rank r runs on ``cuda:r`` over NCCL (on the
CPU, ranks are processes over gloo), holds the whole state and computes on
its rows of the global batch; ``parallel/collectives.py`` reduces where the
batch meets itself. ``data.batch_size`` stays the global batch.

A group comes up in one of two ways:

- ``run.multihost``: ``maybe_init_distributed`` joins the group every
  process of the launch joins (``torchrun``, or one command per process
  with ``run.coordinator`` = ``host:port``, ``run.num_processes`` and
  ``run.process_id``); unset options read torchrun's environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``). The group's size is the data axis.
- ``run.data_axis`` > 1 in one process: the trainers start the ranks
  themselves (``parallel/launch.py``).

``make_dp_tp_mesh`` lays a 2-D ``(data, model)`` mesh over the group (the
JAX package's ``tensor_parallel.make_dp_tp_mesh``): rank r = d * n_model
+ m, row-major as the JAX mesh, with a data subgroup (the ranks of one m)
and a model subgroup (the ranks of one d).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits for the others at a collective
TIMEOUT = datetime.timedelta(minutes=10)

_local_rank = [0]


@dataclass(frozen=True)
class DataMesh:
    """A data axis of ``size`` ranks; ``rank`` is this process's."""
    size: int
    rank: int = 0
    device_type: str = "cuda"
    axis: str = "data"

    @property
    def devices(self) -> np.ndarray:
        """The ranks' devices, one per rank (the JAX mesh's
        ``devices``)."""
        if self.device_type == "cuda":
            return np.array([f"cuda:{r}" for r in range(self.size)])
        return np.array(["cpu"] * self.size)


@dataclass(frozen=True, eq=False)
class DpTpMesh:
    """A (data, model) mesh of ``n_data`` x ``n_model`` ranks; this
    process is ``rank`` = data_rank * n_model + model_rank. The groups are
    process groups (the default group where one spans every rank; None
    without a process group)."""
    n_data: int
    n_model: int
    rank: int
    data_group: object
    model_group: object
    device_type: str = "cuda"

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def data_mesh(self) -> "DataMesh":
        """The data axis alone, with this rank's index on it."""
        return DataMesh(self.n_data, self.data_rank, self.device_type)

    def axes(self):
        """A block whose reductions run over this rank's data group."""
        from semantic_segmentation_torch.parallel import collectives
        return collectives.axes(self.data_group)


def _subgroups(blocks: list, world: int):
    """One process group per block of ranks, created on every rank in the
    same order (``dist.new_group``'s rule); this rank's group. A block
    of every rank is the default group."""
    mine = None
    for ranks in blocks:
        g = dist.group.WORLD if len(ranks) == world else \
            dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return mine


def make_dp_tp_mesh(n_data: int, n_model: int,
                    device_type: str = "cuda") -> DpTpMesh | None:
    """The 2-D mesh over the first ``n_data * n_model`` ranks of the group
    (every rank must call it, in the same order); None on a rank outside
    it. Raises when the mesh needs more ranks than the group has."""
    world = process_count()
    n = n_data * n_model
    if n_data < 1 or n_model < 1 or n > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n} devices, "
                         f"have {world}")
    r = process_index()
    if not dist.is_initialized():
        return DpTpMesh(n_data, n_model, r, None, None, device_type)
    data = _subgroups([[d * n_model + m for d in range(n_data)]
                       for m in range(n_model)], world)
    model = _subgroups([[d * n_model + m for m in range(n_model)]
                        for d in range(n_data)], world)
    if r >= n:
        return None
    return DpTpMesh(n_data, n_model, r, data, model, device_type)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else default


def maybe_init_distributed(cfg) -> bool:
    """Join the process group of a multi-process launch when
    ``cfg.run.multihost`` is set (the DDP launcher of ``BBDM/main.py:70-87``
    without its ``mp.spawn``: each process runs the same command). The
    coordinator (``host:port``), the process count and this process's id
    come from ``run.coordinator``/``num_processes``/``process_id``, or,
    unset ('' / 0 / -1), from torchrun's environment. The backend is NCCL
    for ``run.device`` cuda (this process on ``cuda:LOCAL_RANK``), gloo
    for the CPU. Returns True when more than one process runs."""
    if not getattr(cfg.run, "multihost", False):
        return False
    if not dist.is_initialized():
        r = cfg.run
        coordinator = r.coordinator or (
            f"{os.environ.get('MASTER_ADDR', '')}:"
            f"{os.environ.get('MASTER_PORT', '')}")
        if coordinator.startswith(":") or coordinator.endswith(":"):
            raise ValueError("run.multihost needs run.coordinator=host:port "
                             "or MASTER_ADDR and MASTER_PORT")
        world = r.num_processes or _env_int("WORLD_SIZE", 0)
        rank = r.process_id if r.process_id >= 0 else _env_int("RANK", -1)
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"run.multihost: process {rank} of {world}; set "
                             "run.num_processes and run.process_id, or "
                             "WORLD_SIZE and RANK")
        cuda = torch.device(r.device).type == "cuda"
        if cuda:
            n_dev = torch.cuda.device_count()
            local = _env_int("LOCAL_RANK", rank % max(n_dev, 1))
            if local >= n_dev:
                raise ValueError(f"process {rank} wants cuda:{local}, but "
                                 f"only {n_dev} cards are visible")
            torch.cuda.set_device(local)
            _local_rank[0] = local
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://{coordinator}",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    return dist.get_world_size() > 1


def init_rank(init_method: str, world: int, rank: int, device_type: str):
    """Join a group of ``world`` processes started by one launcher (one
    rank per card, ``cuda:rank``; or CPU processes over gloo)."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        _local_rank[0] = rank
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank, timeout=TIMEOUT)


def rank_device(device) -> torch.device:
    """This rank's device of type ``device``: its own card under a process
    group, else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", _local_rank[0])
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard_indices(n: int, seed: int, epoch: int) -> np.ndarray:
    """This process's shard of a shuffled global index range (the
    DistributedSampler replacement, ``BBDM/runners/BaseRunner.py:339-345``):
    the same permutation on every process (seeded by epoch), strided by
    the process index, so the shards are disjoint and exhaustive."""
    perm = np.random.default_rng(seed + epoch).permutation(n)
    return perm[process_index()::process_count()]


def visible_devices(device_type: str) -> int:
    """The cards a data axis can span (CPU ranks: one per core)."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def make_data_mesh(n_devices: int | None = None,
                   device_type: str = "cuda") -> DataMesh:
    """A data axis of ``n_devices`` ranks (every visible one by default)
    with this process's rank."""
    n = n_devices or (process_count() if dist.is_initialized()
                      else visible_devices(device_type))
    return DataMesh(n, process_index(), device_type)


def mesh_from_config(cfg) -> DataMesh | None:
    """Consume ``cfg.run.data_axis`` (1 = off, 0 = every visible card,
    n = the first n). Returns None when data parallelism is off; raises
    ``ValueError`` for more ranks than cards and for a ``data.batch_size``
    that the data axis does not divide. Under a process group
    (``run.multihost``, or ranks a trainer started) the axis is the group:
    ``data_axis`` must be 0 or its size."""
    n = cfg.run.data_axis
    device_type = torch.device(cfg.run.device).type
    if dist.is_initialized():
        world = dist.get_world_size()
        if n not in (0, world):
            raise ValueError(
                f"run.data_axis={n} under a process group of {world}: the "
                f"group is the data axis, so data_axis takes 0 or {world} "
                "(a subset of the processes has no use: each has one card)")
        n = world
    elif n == 0:
        n = visible_devices(device_type)
    if n <= 1:
        return None
    if not dist.is_initialized() and n > visible_devices(device_type):
        raise ValueError(f"run.data_axis={n} but only "
                         f"{visible_devices(device_type)} {device_type} "
                         "devices")
    if cfg.data.batch_size % n != 0:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} must divide "
                         f"the data mesh size {n}")
    return DataMesh(n, process_index(), device_type)


def batch_sharding(mesh: DataMesh | None, axis: str = "data"):
    """Which rows of the global batch this rank holds, for a batch of any
    size that the mesh divides (``slice(None)``, every row, without a
    mesh)."""
    if mesh is None or mesh.size == 1:
        return slice(None)
    return _RankRows(mesh.size, mesh.rank)


class _RankRows:
    """Rank ``rank``'s contiguous 1/``size`` of the rows of a batch."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank

    def of(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not divide the data "
                             f"mesh size {self.size}")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def replicate(mesh: DataMesh | None) -> slice:
    """Every row: the placement of replicated state."""
    return slice(None)


def _take(x, sharding):
    if isinstance(sharding, slice):
        return x[sharding]
    return x[sharding.of(x.shape[0])]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DataMesh | None, batch, axis: str = "data"):
    """This rank's rows of every leaf of ``batch`` (arrays or tensors,
    batch on axis 0). The batch size must divide the mesh size."""
    sh = batch_sharding(mesh, axis)
    return _tree_map(lambda x: _take(x, sh), batch)


def global_from_host_local(mesh: DataMesh | None, batch, axis: str = "data"):
    """The global batch from each process's local shard
    (``jax.make_array_from_process_local_data``): here each rank computes
    on its own rows and the collectives join them, so the local shard IS
    this rank's part of the global batch and is returned as it is. On one
    process it equals ``shard_batch``."""
    return batch


def pad_to_multiple(arr: np.ndarray, multiple: int):
    """Pad axis 0 to a device-count multiple (for eval loaders whose sizes
    do not divide the mesh) with copies of the last row; returns (padded,
    real_count)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.repeat(arr[-1:], rem, axis=0)
    return np.concatenate([arr, pad], axis=0), n
