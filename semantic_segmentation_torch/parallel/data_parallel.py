"""Data-parallel steps — the port of
``semantic_segmentation_tpu/parallel/data_parallel.py``.

The JAX package replicates the state over the ``data`` mesh axis, shards
the batches on their leading axis and lets XLA's SPMD partitioner insert
the reductions: the sharded step computes the single-device program over
the global batch, batch-norm statistics included. Here each rank of the
process group (``parallel/mesh.py``) holds the whole state and runs its
rows of the global batch; the program's global reductions are all-reduces
(``parallel/collectives.py``: batch norm, the batch-folded Dice, the fake
batch's min-max, the draws at the global batch's shape) and every
optimizer step averages the gradients first (``engine/bilevel.py``,
``train/train_unet.train_step``). No ``DistributedDataParallel`` wrapper:
the engine runs nets on other weights and scratch buffers and
differentiates through an inner update, which DDP's hooks do not see.
"""

from __future__ import annotations

import contextlib

import torch

from semantic_segmentation_torch.parallel import collectives
from semantic_segmentation_torch.parallel.mesh import DataMesh, shard_batch


def to_device(tree, device):
    """``tree`` (dicts, lists, tuples) with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def to_cpu(tree):
    """A copy of ``tree`` with every tensor on the CPU (never a view of a
    live tensor): what a rank hands back to the process that started it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu() if tree.is_cuda else tree.detach().clone()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate_state(mesh: DataMesh | None, state):
    """Rank 0's values of every tensor of ``state`` on every rank, in place
    (a broadcast). ``state``: a module, an optimizer, an engine (its
    problems' modules and optimizers, the arch tables and their
    optimizer), or a tree of tensors. Returns ``state``."""
    if isinstance(state, torch.nn.Module):
        ts = list(state.state_dict().values())
    elif isinstance(state, torch.optim.Optimizer):
        ts = list(_tensors(state.state_dict()["state"]))
    elif hasattr(state, "problems"):                # a BilevelEngine
        ts = []
        for p in state.problems:
            ts += list(p.module.state_dict().values())
            ts += list(_tensors(p.optimizer.state_dict()["state"]))
        ts += list(state.arch.values())
        if state.arch_optimizer is not None:
            ts += list(_tensors(state.arch_optimizer.state_dict()["state"]))
    else:
        ts = list(_tensors(state))
    # an optimizer counts its steps in CPU scalars (alike on every rank),
    # which NCCL cannot move
    nccl = (torch.distributed.is_initialized()
            and torch.distributed.get_backend() == "nccl")
    collectives.broadcast_([t for t in ts if t.is_floating_point()
                            and (t.is_cuda or not nccl)])
    return state


def shard_batch_trees(mesh: DataMesh | None, *trees, axis: str = "data"):
    """This rank's rows of each tree of batches (leaves batch-first)."""
    out = tuple(shard_batch(mesh, t, axis) for t in trees)
    return out if len(out) > 1 else out[0]


def dp_engine_step(engine, mesh: DataMesh | None, batch_stack, val_batch,
                   draws=None):
    """One bilevel engine iteration over the global batches: this rank's
    rows of ``batch_stack`` (K dicts of problem batches) and ``val_batch``;
    ``draws`` (injected, ``BilevelEngine.engine_step``'s) are global too.
    Every rank must hold the same state (``replicate_state``). Returns the
    metrics of the global batch."""
    batch_stack = [shard_batch(mesh, b) for b in batch_stack]
    val_batch = None if val_batch is None else shard_batch(mesh, val_batch)
    return engine.engine_step(batch_stack, val_batch, draws)


def dp_seg_step(seg, optimizer, mesh: DataMesh | None, batch,
                amp=contextlib.nullcontext, generator=None):
    """One optimizer step of the segmenter (``train_unet.train_step``) on
    this rank's rows of the numpy NHWC global ``batch``; the loss of the
    global batch. Every rank must hold the same net and optimizer state."""
    from semantic_segmentation_torch.train.train_unet import train_step
    device = next(seg.net.parameters()).device
    return train_step(seg, optimizer, shard_batch(mesh, batch), amp, device,
                      generator)
