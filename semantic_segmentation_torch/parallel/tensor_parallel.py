"""Tensor (model) parallelism — the port of
``semantic_segmentation_tpu/parallel/tensor_parallel.py``, with its names.

The JAX package places the state on a 2-D ``(data, model)`` mesh, every
float leaf whose last axis divides by the model size sharded on that axis
(an HWIO kernel's output channels, its bias, the BN scale, bias and
statistics, the optimizer moments that share their shapes), and lets XLA
insert the collectives. Here the collectives are written out, Megatron's
channel-parallel pair around every sharded layer:

- a conv or transposed conv (``nn.Conv*d``, ``nn.ConvTranspose*d``, the
  NAS ``MixedConv``/``MixedConvTranspose``) whose output channels divide by
  the model size computes its slice of them from the whole input. Its
  inputs pass an identity whose backward sums over the model group (each
  rank's input gradient covers its channels only; so does the gradient of
  the softmaxed arch row a mixed op takes, which is how the replicated arch
  tables get the model group's sum), and a gather along channels follows
  it, whose backward takes the rank's slice;
- a ``BatchNorm2d`` of such a width takes the rank's channels of its input
  (backward: the gather; a BN that follows its conv takes the conv's own
  slice, which the conv's gathered output carries), normalizes them with
  per-channel statistics over the data group alone, and gathers its
  output.

Between layers every activation is whole, the same on every rank of a
model group, so dropout masks, losses, the warp and the equalize run
unchanged on each rank. A leaf is sharded where its channel count divides
by the model size and is at least that size: the set of leaves JAX's
``_leaf_spec`` shards on the HWIO last axis. Everything else stays whole:
heads whose width does not divide, scalars, step counters, and the arch
tables (JAX places an arch table whose last axis divides, which changes no
number, so the port keeps them whole), and the parameters of layers no
rule above covers (a ``Linear`` or ``LayerNorm`` keeps its layer's plain
forward: JAX's placement of them changes no number either).

The gathers are all-reduces of a zero-filled buffer in which each rank
writes its slice, its bytes summed as uint8 (adding zeros is exact, so a
gather is bit-exact on NCCL, gloo, and gloo with CUDA tensors, in the
activation's own dtype and memory format); the sums over the model group
run in float32 for half types. Each collective is a
``torch.autograd.Function`` whose backward applies another one, so
``unroll``'s double backward goes through them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn

from semantic_segmentation_torch.parallel import collectives
from semantic_segmentation_torch.parallel.data_parallel import (
    dp_engine_step, dp_seg_step)
from semantic_segmentation_torch.parallel.mesh import (  # noqa: F401
    DpTpMesh, make_dp_tp_mesh)

TP_SHARD = collectives.TP_SHARD

# the model-group all-reduces since the last reset: calls, bytes, seconds
TP_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_tp_stats():
    TP_STATS.update(calls=0, bytes=0, seconds=0.0)


def _index(group) -> tuple:
    """(rank, size) of this process in ``group`` (1 rank without a
    process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _gather(x, dim: int, group):
    """The whole tensor from each rank's slice along ``dim``: a
    zero-filled buffer, this rank's slice written in, summed."""
    m, n = _index(group)
    if n == 1 and not dist.is_initialized():
        return x.clone()
    c = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = c * n
    buf = collectives.like(x, shape)
    buf.narrow(dim, m * c, c).copy_(x)
    return collectives.merge_slices(group, buf, TP_STATS)


def _slice(x, dim: int, group):
    """This rank's slice of ``x`` along ``dim`` (a copy)."""
    m, n = _index(group)
    c = x.shape[dim] // n
    return x.narrow(dim, m * c, c).clone()


class _Copy(torch.autograd.Function):
    """Identity; backward: the sum over the model group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        # a view with x's own strides (``view_as`` normalizes a size-1
        # dim's, which can turn a channels-last tensor into an NCHW one
        # and move the next conv to other kernels)
        return x.as_strided(x.size(), x.stride(), x.storage_offset())

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """The sum over the model group; backward: identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collectives.sum_over(group, x, TP_STATS)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """The gather along ``dim``; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    """This rank's slice along ``dim``; backward: the gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.group), None, None


def copy_to_model(x, group):
    return _Copy.apply(x, group)


def gather_channels(x, group, dim: int = 1):
    return _Gather.apply(x, dim, group)


def scatter_channels(x, group, dim: int = 1):
    return _Scatter.apply(x, dim, group)


def _conv_plan(module) -> dict | None:
    """{parameter name: output-channel dim} of a layer this module shards,
    with its output width; None for a layer it keeps whole."""
    from semantic_segmentation_torch.ops.layers import BatchNorm2d
    from semantic_segmentation_torch.ops.nas import (MixedConv,
                                                     MixedConvTranspose)
    if isinstance(module, nn.modules.conv._ConvNd):
        if module.groups != 1:
            return None
        dim = 1 if module.transposed else 0
        plan = {"weight": dim}
        if module.bias is not None:
            plan["bias"] = 0
        return {"kind": "conv", "plan": plan,
                "width": module.weight.shape[dim]}
    if isinstance(module, (MixedConv, MixedConvTranspose)):
        dim = 1 if isinstance(module, MixedConvTranspose) else 0
        plan = {}
        for name, p in module.named_parameters(recurse=False):
            plan[name] = dim if name.startswith("kernel_") else 0
        width = next(p for n, p in module.named_parameters(recurse=False)
                     if n.startswith("kernel_")).shape[dim]
        return {"kind": "conv", "plan": plan, "width": width}
    if isinstance(module, BatchNorm2d):
        return {"kind": "norm", "width": module.weight.shape[0],
                "plan": {"weight": 0, "bias": 0, "running_mean": 0,
                         "running_var": 0}}
    return None


def _hooks(kind: str, group):
    def copy_inputs(_, args):
        return tuple(copy_to_model(a, group) if torch.is_tensor(a)
                     and a.is_floating_point() else a for a in args)

    def scatter_input(_, args):
        # the slice this rank's conv made, when a conv's gathered output
        # comes in: the same values, without a gather in the backward
        local = getattr(args[0], "_tp_local", None)
        if local is None or local[1] is not group:
            local = (scatter_channels(args[0], group),)
        return (local[0],) + tuple(args[1:])

    def gather_output(_, args, out):
        whole = gather_channels(out, group)
        whole._tp_local = (out, group)
        return whole

    return (copy_inputs if kind == "conv" else scatter_input), gather_output


def _modules_and_optimizers(state):
    """(modules, optimizers) of a state: an engine (its problems' modules
    and optimizers), a module, an optimizer, or a list or tuple of them."""
    if hasattr(state, "problems"):                 # a BilevelEngine
        return ([p.module for p in state.problems],
                [p.optimizer for p in state.problems])
    items = state if isinstance(state, (list, tuple)) else [state]
    mods = [s for s in items if isinstance(s, nn.Module)]
    opts = [s for s in items if isinstance(s, torch.optim.Optimizer)]
    if len(mods) + len(opts) != len(items):
        raise TypeError(f"shard_state_tp: {type(state).__name__} is not an "
                        "engine, a module, an optimizer or a list of them")
    return mods, opts


@torch.no_grad()
def shard_state_tp(mesh, state):
    """Shard ``state`` in place over ``mesh``'s model axis (module
    docstring): each covered layer of width C (C divisible by the model
    size M, C >= M) keeps output channels [m C/M, (m+1) C/M) of its
    parameters and BN statistics on model rank m, and the optimizers'
    per-parameter state follows its parameter. ``state``: an engine, a
    module, an optimizer, or a list of them (the optimizers of the modules
    it holds). The ``Parameter`` objects stay the same, so optimizers and
    engines keep their references. Returns ``state``."""
    group, n = mesh.model_group, mesh.n_model
    m = mesh.model_rank
    mods, opts = _modules_and_optimizers(state)
    for root in mods:
        if getattr(root, "_tp_handles", None) is not None:
            raise ValueError(f"{type(root).__name__} is already sharded")
        handles = []
        for mod in root.modules():
            spec = _conv_plan(mod)
            if spec is None or spec["width"] % n or spec["width"] < n:
                continue
            for name, dim in spec["plan"].items():
                t = getattr(mod, name)
                c = t.shape[dim] // n
                part = t.narrow(dim, m * c, c).clone()
                if isinstance(t, nn.Parameter):
                    for opt in opts:
                        st = opt.state.get(t, {})
                        for k, v in st.items():
                            if torch.is_tensor(v) and v.shape == t.shape:
                                st[k] = v.narrow(dim, m * c, c).clone()
                    grad = None if t.grad is None else \
                        t.grad.narrow(dim, m * c, c).clone()
                    t.grad = None
                    t.data, t.grad = part, grad
                    setattr(t, TP_SHARD, (dim, group, n))
                else:
                    mod._buffers[name] = part
            pre, post = _hooks(spec["kind"], group)
            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post)]
            mod._tp_plan = spec["plan"]
        root._tp_handles = handles
    return state


@torch.no_grad()
def gather_state_tp(mesh, state):
    """The inverse of ``shard_state_tp``, in place: every shard gathered
    back to the one-process layout (the gradients and the optimizers'
    state too) and the layers' plain forwards restored. A checkpoint
    written from it is the one-process layout, which a plain run loads.
    Returns ``state``."""
    group = mesh.model_group
    mods, opts = _modules_and_optimizers(state)
    for root in mods:
        if getattr(root, "_tp_handles", None) is None:
            raise ValueError(f"{type(root).__name__} is not sharded")
        for mod in root.modules():
            plan = getattr(mod, "_tp_plan", None)
            if plan is None:
                continue
            for name, dim in plan.items():
                t = getattr(mod, name)
                if isinstance(t, nn.Parameter):
                    for opt in opts:
                        st = opt.state.get(t, {})
                        for k, v in st.items():
                            if torch.is_tensor(v) and v.shape == t.shape:
                                st[k] = _gather(v, dim, group)
                    grad = None if t.grad is None else \
                        _gather(t.grad, dim, group)
                    t.grad = None
                    t.data, t.grad = _gather(t.data, dim, group), grad
                    delattr(t, TP_SHARD)
                else:
                    mod._buffers[name] = _gather(t, dim, group)
            del mod._tp_plan
        for h in root._tp_handles:
            h.remove()
        root._tp_handles = None
    return state


def sharded_bytes(state) -> tuple:
    """(bytes of this rank's sharded leaves, bytes of its whole leaves) of
    the modules of ``state`` (parameters and buffers)."""
    mods, _ = _modules_and_optimizers(state)
    sh = whole = 0
    for root in mods:
        for mod in root.modules():
            plan = getattr(mod, "_tp_plan", {})
            for name, t in list(mod.named_parameters(recurse=False)) + \
                    list(mod.named_buffers(recurse=False)):
                size = t.numel() * t.element_size()
                if name in plan:
                    sh += size
                else:
                    whole += size
    return sh, whole


def tp_engine_step(engine, mesh, batch_stack, val_batch, draws=None):
    """One bilevel engine iteration with the batch sharded over ``data``
    and every covered layer channel-sharded over ``model``
    (``shard_state_tp`` first): this rank's data rows of ``batch_stack``
    and ``val_batch`` (global; ``draws`` global too), the reductions over
    its data group. Returns the metrics of the global batch, the same on
    every rank."""
    with mesh.axes():
        return dp_engine_step(engine, mesh.data_mesh, batch_stack,
                              val_batch, draws)


def tp_seg_step(seg, optimizer, mesh, batch, amp=None, generator=None):
    """One optimizer step of the segmenter (``train_unet.train_step``) on
    this rank's data rows of the numpy NHWC global ``batch``, its net and
    optimizer sharded (``shard_state_tp``); the loss of the global
    batch."""
    with mesh.axes():
        return dp_seg_step(seg, optimizer, mesh.data_mesh, batch,
                           amp or contextlib.nullcontext, generator)
