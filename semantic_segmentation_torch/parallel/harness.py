"""Rank-side functions that run the parallel steps from a
``launch.RankPool``, so that a harness can hold n ranks against one
process on the same state, batches and draws: data-parallel
(``tests/test_torch_parallel.py`` on the CPU, ``chip_smoke.py`` phase 7j
on the card), tensor-parallel on a (data, model) mesh and spatially
parallel (``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_spatial.py``, phase 7k).

Each function runs on every rank of the pool's group, builds its nets once
per process (cached by their configuration), loads the state it is given
(the same on every rank) and returns plain values: floats, and tensors on
the CPU. The batches and draws it is given are the global ones; each rank
takes its rows (``parallel/data_parallel.py``).
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import torch

from semantic_segmentation_torch.parallel import collectives, tensor_parallel
from semantic_segmentation_torch.parallel.data_parallel import (
    dp_engine_step, dp_seg_step, to_cpu, to_device)
from semantic_segmentation_torch.parallel.mesh import (DataMesh,
                                                       make_data_mesh,
                                                       process_count,
                                                       shard_batch)

_BUILT: dict = {}


def warm_up(seg_argv: tuple | None = None, engine_argv: tuple | None = None,
            modules: tuple = (), preset: str = "end2end_jsrt",
            device: str = "cpu"):
    """Build a rank's segmenter (``seg_steps``'s) and engine
    (``build_engine``'s) of these configurations, and import ``modules``,
    ahead of their first use."""
    import importlib
    for name in modules:
        importlib.import_module(name)
    if seg_argv is not None:
        seg_steps(seg_argv, device, None, [])
    if engine_argv is not None:
        build_engine(engine_argv, preset, device)


def tp_mesh(shape: tuple, device_type: str):
    """The (data, model) mesh of ``shape`` over the pool's group, made once
    per process (its subgroups are created on every rank in one order)."""
    key = ("mesh", tuple(shape), device_type)
    if key not in _BUILT:
        _BUILT[key] = tensor_parallel.make_dp_tp_mesh(*shape, device_type)
    return _BUILT[key]


def _device(device: str) -> torch.device:
    # gloo ranks that share one card all run on it (launch.RankPool)
    return torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)


def build_engine(argv: tuple, preset: str, device: str):
    """The flagship engine of ``argv`` under ``preset`` on this rank's
    device, built once per process; the engines of every preset share one
    set of nets (the models' options are ``argv``'s)."""
    key = ("engine", tuple(argv), preset, device)
    if key not in _BUILT:
        from semantic_segmentation_torch.core.config import parse_config
        from semantic_segmentation_torch.train import train_end2end
        cfg = parse_config(list(argv), preset=preset)
        nets = ("nets", tuple(argv), device)
        if nets not in _BUILT:
            _BUILT[nets] = train_end2end.build_nets(cfg, _device(device))
        _BUILT[key] = train_end2end.engine_over(cfg, *_BUILT[nets],
                                                _device(device))
    return _BUILT[key]


def nets_state(engine, on_device: bool = False) -> dict:
    """The parts of an engine's state that ``state_gap`` compares, on the
    CPU (copies on the engine's device with ``on_device``: ``state_gap``
    is then far quicker on a card): each problem's parameters and BN
    statistics (``module``) and the gradients its last optimizer step took
    (``grads``, averaged over the ranks: what the gradient all-reduce
    gave), the arch tables."""
    copy = _clone if on_device else to_cpu
    return {"problems": {p.name: {"module": copy(p.module.state_dict()),
                                  "grads": _grads(p.module, copy)}
                         for p in engine.problems},
            "arch": copy(dict(engine.arch))}


def _clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _grads(module, copy=to_cpu) -> dict:
    return copy({k: q.grad for k, q in module.named_parameters()
                 if q.grad is not None})


def leaf_gap(got: dict, want: dict, floor: float = 1e-2) -> float:
    """The largest gap of two {name: tensor} trees relative to each leaf's
    scale, the largest |value| of ``want``'s leaf, or ``floor`` times the
    tree's largest scale where that is more (a leaf that is 0 in exact
    arithmetic, such as the gradient of a conv bias that a following batch
    norm cancels, is held at the tree's scale)."""
    scales = {k: w.float().abs().max().item() for k, w in want.items()
              if w.is_floating_point() and w.numel()}
    top = max(scales.values(), default=0.0)
    worst = 0.0
    for k, scale in scales.items():
        err = (got[k].float() - want[k].float()).abs().max().item()
        worst = max(worst, err / max(scale, floor * top, 1e-30))
    return worst


def norm_gap(got: dict, want: dict) -> float:
    """|got - want| / |want| over the whole of two {name: tensor} trees
    (Euclidean norms)."""
    num = sum(((got[k].float() - w.float()) ** 2).sum().item()
              for k, w in want.items())
    den = sum((w.float() ** 2).sum().item() for w in want.values())
    return math.sqrt(num / max(den, 1e-300))


def state_gap(a: dict, b: dict) -> dict:
    """The gaps between two ``nets_state``s, ``b`` the reference, the
    largest over the problems: ``params`` and ``bn`` (the BN running
    statistics), each relative per leaf (``leaf_gap``); ``grads``, the
    last step's averaged gradients relative to their norm (``norm_gap``),
    and ``grads_leaf`` relative per leaf; ``arch``, the arch tables'
    largest |difference|."""
    gap = {"params": 0.0, "bn": 0.0, "grads": 0.0, "grads_leaf": 0.0}
    for name, prob in b["problems"].items():
        mod, other = prob["module"], a["problems"][name]["module"]
        bn = {k for k in mod if "running" in k}
        grads = a["problems"][name]["grads"]
        for k, g in (("params", leaf_gap(other, {k: v for k, v in mod.items()
                                                 if k not in bn})),
                     ("bn", leaf_gap(other, {k: mod[k] for k in bn})),
                     ("grads", norm_gap(grads, prob["grads"])),
                     ("grads_leaf", leaf_gap(grads, prob["grads"]))):
            gap[k] = max(gap[k], g)
    gap["arch"] = max(((a["arch"][k] - v).abs().max().item()
                       for k, v in b["arch"].items()), default=0.0)
    return gap


def engine_iterations(argv: tuple, preset: str, device: str,
                      state: dict | None,
                      steps: list, return_state: bool = True,
                      timed: bool = False, mesh: tuple | None = None,
                      state_on_device: bool = False,
                      record_inputs: str | None = None) -> dict:
    """From ``state`` (an engine ``state_dict``, on the CPU; None: the
    state the engine's nets were built with, kept in ``_BUILT`` at the
    first such call), one ``dp_engine_step`` per entry of ``steps``
    ((batch_stack, val_batch, draws), global, on the CPU); with ``mesh``
    (n_data, n_model), one ``tp_engine_step`` on that mesh, the engine
    sharded first and gathered after (ranks outside the mesh run no step).
    Returns the metrics of each step, the final ``nets_state`` (with
    ``return_state``), the seconds of each step (ending in a device sync),
    the gradient all-reduces' calls, bytes and seconds over all steps
    (``timed``: each ending in a device sync), every rank's peak device
    memory and the kernel launches of this rank (the final state on the
    engine's device with ``state_on_device``); with ``record_inputs``, the
    name of a problem, every batch its module took (``inputs``, on the
    CPU); under ``mesh`` also the model group's all-reduces (``tp``: calls,
    bytes, seconds) and this rank's bytes of sharded and whole leaves
    while sharded."""
    from semantic_segmentation_torch import kernels
    dev = _device(device)
    engine = build_engine(argv, preset, device)
    if state is None:
        key = ("start", tuple(argv), device)
        if key not in _BUILT:
            _BUILT[key] = to_cpu(engine.state_dict())
        state = _BUILT[key]
    engine.load_state_dict(state)
    tp = None if mesh is None else tp_mesh(mesh, dev.type)
    # the whole batch where the collectives are off (``alone_and_on_ranks``)
    dmesh = DataMesh(collectives.world(), collectives.rank(), dev.type)
    collectives.reset_grad_stats(timed)
    tensor_parallel.reset_tp_stats()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    metrics, seconds, leaf_bytes, inputs = [], [], None, []
    hook = None if record_inputs is None else next(
        p.module for p in engine.problems if p.name == record_inputs
    ).register_forward_pre_hook(
        lambda _, args: inputs.append(args[0].detach().cpu()))
    if tp is not None:
        tensor_parallel.shard_state_tp(tp, engine)
        leaf_bytes = tensor_parallel.sharded_bytes(engine)
    for batch_stack, val_batch, draws in (
            steps if mesh is None or tp is not None else []):
        t0 = time.perf_counter()
        args = (to_device(batch_stack, dev), to_device(val_batch, dev),
                to_device(draws, dev))
        m = (dp_engine_step(engine, dmesh, *args) if tp is None
             else tensor_parallel.tp_engine_step(engine, tp, *args))
        metrics.append({k: float(v) for k, v in m.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
    if tp is not None:
        tensor_parallel.gather_state_tp(tp, engine)
    if hook is not None:
        hook.remove()
    launches = dict(kernels.LAUNCHES)
    peaks = torch.zeros(collectives.world(), dtype=torch.float64,
                        device=dev if dev.type == "cuda" else "cpu")
    if dev.type == "cuda":
        peaks[collectives.rank()] = torch.cuda.max_memory_allocated(dev)
    peaks = collectives.all_reduce_sum(peaks)
    return {"metrics": metrics, "seconds": seconds,
            "grad_allreduce": {k: collectives.GRAD_STATS[k]
                               for k in ("calls", "bytes", "seconds")},
            "tp": dict(tensor_parallel.TP_STATS), "leaf_bytes": leaf_bytes,
            "peak_bytes": [int(p) for p in peaks.tolist()],
            "launches": launches, "world": collectives.world(),
            "state": (nets_state(engine, state_on_device) if return_state
                      else None),
            "inputs": inputs}


def engine_iterations_alone(*args, **kwargs):
    """``engine_iterations`` on rank 0 alone, the collectives off: the
    one-process run beside a pool's parallel one, in the ranks' own
    setting (their thread count, hence their CPU kernels' rounding). None
    on the other ranks."""
    if collectives.rank() != 0:
        return None
    with collectives.replicated():
        return engine_iterations(*args, **kwargs)


def _ulp(w, sign: float):
    """``w`` one ulp up (``sign`` 1) or down (-1)."""
    return torch.nextafter(w, torch.full_like(w, sign * math.inf))


def _moved(state: dict, sign: float) -> dict:
    """A ``state_dict`` to load: ``state`` with every parameter (not the
    BN statistics) one ulp up (``sign`` 1) or down (-1)."""
    return {k: _ulp(w, sign) if w.is_floating_point() and "running" not in k
            else w for k, w in state.items()}


# the parts of a run's record that stay on rank 0 (compared, then dropped)
_HEAVY = ("state", "grads", "sharded")


def _alone_and_on_ranks(run, gap, meshes: tuple, nudged: bool = True
                        ) -> dict | None:
    """Hold parallel runs against one process with no state crossing a
    process. Rank 0 first calls ``run(None, 0.0)`` alone with the
    collectives off (``collectives.replicated``: the plain program over
    the global batch) and, with ``nudged``, ``run(None, 1.0)`` and
    ``run(None, -1.0)``, from the start with every parameter one ulp up
    and one ulp down; then every rank calls ``run(mesh, 0.0)`` for each of
    ``meshes``. Rank 0 sets each later record's ``gap`` to ``gap(record,
    first)`` (a dict of gaps) and drops the records' ``_HEAVY`` parts.
    Rank 0 returns {"one": the first record, "nudged": the moved runs',
    "runs": the parallel runs' in the order of ``meshes``, "spread": per
    gap the largest of the moved runs', "alone_s": the wall seconds of the
    runs alone, "ranks_s": those of each parallel run}; the other ranks
    None."""
    out, one = {"nudged": [], "runs": [], "ranks_s": []}, None

    def held(record):
        if one is not None:
            record["gap"] = gap(record, one)
            for k in _HEAVY:
                record.pop(k, None)
        return record
    t0 = time.perf_counter()
    if collectives.rank() == 0:
        with collectives.replicated():
            one = run(None, 0.0)
            out["nudged"] = [held(run(None, sign))
                             for sign in ((1.0, -1.0) if nudged else ())]
    out["alone_s"] = time.perf_counter() - t0
    for mesh in meshes:
        t1 = time.perf_counter()
        out["runs"].append(held(run(mesh, 0.0)))
        out["ranks_s"].append(time.perf_counter() - t1)
    if one is None:
        return None
    for k in _HEAVY:
        one.pop(k, None)
    out["one"] = one
    out["spread"] = {k: max(r["gap"][k] for r in out["nudged"])
                     for k in (out["nudged"][0]["gap"] if nudged else ())}
    return out


def _rel(a: list, b: list) -> float:
    """The largest relative gap of two lists of numbers."""
    return max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)),
               default=0.0)


def _run_gap(losses: list, want_losses: list, state: dict,
             want_state: dict) -> dict:
    """Two runs apart: their losses' largest relative gap, the parameters
    and BN statistics of their final states relative per leaf."""
    bn = {k for k in want_state if "running" in k}
    return {"losses": _rel(losses, want_losses),
            "params": leaf_gap(state, {k: v for k, v in want_state.items()
                                       if k not in bn}),
            "bn": leaf_gap(state, {k: want_state[k] for k in bn})}


def _engine_gap(got: dict, want: dict) -> dict:
    """Two ``engine_iterations`` records apart: the losses' (every metric
    but ``arch_grad_norm``) and ``arch_grad_norm``'s largest relative gaps
    over the steps, and the final states' ``state_gap``."""
    def metric(keys):
        return _rel([m[k] for m in got["metrics"] for k in keys],
                    [m[k] for m in want["metrics"] for k in keys])
    keys = [k for k in want["metrics"][0] if k != "arch_grad_norm"]
    return {"losses": metric(keys),
            "arch_grad_norm": metric([k for k in ("arch_grad_norm",)
                                      if k in want["metrics"][0]]),
            **state_gap(got["state"], want["state"])}


def alone_and_on_ranks(argv: tuple, preset: str, device: str,
                       steps: list, meshes: tuple = (None,),
                       nudged: bool = True) -> dict:
    """``_alone_and_on_ranks`` for the engine: ``engine_iterations`` of
    ``steps`` from the nets as built (their parameters one ulp away for the
    moved runs), the parallel runs on each of ``meshes`` (None:
    data-parallel over the group; (n_data, n_model): tensor-parallel on
    that mesh), their gradient all-reduces timed; the states compared on
    the engine's device (``_engine_gap``)."""
    def run(mesh, sign):
        start = None
        if sign:
            start = dict(_BUILT[("start", tuple(argv), device)])
            start["problems"] = {
                name: {**prob, "module": _moved(prob["module"], sign)}
                for name, prob in start["problems"].items()}
        return engine_iterations(argv, preset, device, start, steps,
                                 timed=collectives.active(), mesh=mesh,
                                 state_on_device=True)
    return _alone_and_on_ranks(run, _engine_gap, meshes, nudged)


def darts_term(argv: tuple, preset: str, device: str, state: dict,
               step: tuple, mesh: tuple | None = None) -> dict:
    """The ``darts`` hypergradient (``BilevelEngine._darts_hypergrad``) at
    ``state`` itself, on this rank's rows of the global ``step``
    ((batch_stack, val_batch, draws)): {arch name: hypergradient} on the
    CPU; with ``mesh`` (n_data, n_model) on that mesh, the engine sharded.
    An engine iteration takes it at the unrolled state, which carries the
    inner steps' rounding; this is the term alone."""
    dev = _device(device)
    engine = build_engine(argv, preset, device)
    engine.load_state_dict(state)
    tp = None if mesh is None else tp_mesh(mesh, dev.type)
    if mesh is not None and tp is None:         # a rank outside the mesh
        return None
    dmesh = make_data_mesh(process_count(), dev.type) if tp is None \
        else tp.data_mesh
    batch_stack, val_batch, draws = to_device(step, dev)
    if tp is not None:
        tensor_parallel.shard_state_tp(tp, engine)
    try:
        with tp.axes() if tp is not None else contextlib.nullcontext():
            hg, _ = engine._darts_hypergrad(
                [shard_batch(dmesh, b) for b in batch_stack],
                shard_batch(dmesh, val_batch), (draws or {}).get("hyper"))
    finally:
        if tp is not None:
            tensor_parallel.gather_state_tp(tp, engine)
    return to_cpu(hg)


def seg_steps(argv: tuple, device: str, net_state: dict | None,
              batches: list, mesh: tuple | None = None) -> dict:
    """From ``net_state`` (None: the net as built, kept in ``_BUILT`` at
    the first such call), one ``dp_seg_step`` (``train_unet``'s step) per
    numpy NHWC global batch of ``batches``, with a fresh optimizer; with
    ``mesh`` (n_data, n_model), ``tp_seg_step`` on that mesh, the net and
    optimizer sharded first and gathered after (None on a rank outside
    it). Returns each step's loss and seconds (ending in a device sync),
    the net's final state and the gradients of the last step (averaged
    over the data axis), this rank's peak device memory, and under
    ``mesh`` the net's state as sharded, this rank's model index and the
    model group's all-reduces (``tp``)."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train.common import (autocast_for,
                                                          build_seg_problem)
    dev = _device(device)
    cfg = parse_config(list(argv))
    key = ("seg", tuple(argv), device)
    if key not in _BUILT:
        _BUILT[key] = build_seg_problem(cfg, dev)
        _BUILT[key + ("start",)] = to_cpu(_BUILT[key].net.state_dict())
    seg = _BUILT[key]
    seg.net.load_state_dict(_BUILT[key + ("start",)] if net_state is None
                            else net_state)
    opt = seg.make_opt()
    amp = autocast_for(cfg, dev)
    tp = None if mesh is None else tp_mesh(mesh, dev.type)
    if mesh is not None and tp is None:         # a rank outside the mesh
        return None
    out = {}
    if tp is not None:
        tensor_parallel.shard_state_tp(tp, (seg.net, opt))
        out = {"sharded": to_cpu(seg.net.state_dict()),
               "model_rank": tp.model_rank}
    from semantic_segmentation_torch import kernels
    tensor_parallel.reset_tp_stats()
    kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, seconds = [], []
    try:
        for b in batches:
            t0 = time.perf_counter()
            if tp is None:
                dmesh = DataMesh(collectives.world(), collectives.rank(),
                                 dev.type)
                loss = dp_seg_step(seg, opt, dmesh, b, amp)
            else:
                loss = tensor_parallel.tp_seg_step(seg, opt, tp, b, amp)
            losses.append(float(loss))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
    finally:
        if tp is not None:
            tensor_parallel.gather_state_tp(tp, (seg.net, opt))
    return {**out, "losses": losses, "seconds": seconds,
            "state": to_cpu(seg.net.state_dict()), "grads": _grads(seg.net),
            "tp": dict(tensor_parallel.TP_STATS),
            "launches": dict(kernels.LAUNCHES),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0)}


def _peaks(peak: int) -> list:
    """Every rank's ``peak`` (bytes), on every rank of the group (this
    rank's alone where the collectives are off)."""
    import torch.distributed as dist
    if not collectives.active():
        return [peak]
    cuda = torch.cuda.is_available() and \
        dist.get_backend() == "nccl"
    t = torch.zeros(dist.get_world_size(), dtype=torch.float64,
                    device="cuda" if cuda else "cpu")
    t[dist.get_rank()] = peak
    dist.all_reduce(t)
    return [int(v) for v in t.tolist()]


def seg_alone_and_on_ranks(argv: tuple, device: str, batches: list,
                           mesh: tuple) -> dict:
    """``_alone_and_on_ranks`` for the segmenter's step: ``seg_steps`` from
    the net as built, the parallel run on ``mesh``; the gaps ``_run_gap``'s
    and the last step's gradients relative to their norm."""
    def run(mesh, sign):
        state = None if not sign else _moved(
            _BUILT[("seg", tuple(argv), device, "start")], sign)
        r = seg_steps(argv, device, state, batches, mesh)
        r["peak_bytes_per_rank"] = _peaks(r["peak_bytes"])
        return r

    def gap(got, want):
        return {**_run_gap(got["losses"], want["losses"], got["state"],
                           want["state"]),
                "grads": norm_gap(got["grads"], want["grads"])}
    return _alone_and_on_ranks(run, gap, (mesh,))


def unet3d_alone_and_on_ranks(argv: tuple, iters: int, crop: int,
                              spatial_size: int) -> dict:
    """``_alone_and_on_ranks`` for ``train_unet3d``: alone at
    ``run.spatial_axis=1`` from the seed's net (one ulp away for the moved
    runs), the parallel run at ``run.spatial_axis=spatial_size`` (the
    ranks are the group: one depth slab each). ``argv``: the
    configuration, its ``run.save_dir`` included. Each record holds the
    trainer's results (its ``log``), wall seconds, peak, exchanges
    (``halo``) and launches; the gaps are ``_run_gap``'s over the logged
    losses and the final net, and ``first_grads``: the first step's
    gradients (averaged over the group: what the optimizer took, before any
    step's rounding moves the nets apart) relative to their norm."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from semantic_segmentation_torch import kernels
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.parallel import spatial
    from semantic_segmentation_torch.train import train_unet3d as tu

    def run(mesh, sign):
        name = "spatial" if mesh else f"alone{sign:+.0f}"
        cfg = parse_config(list(argv) + [f"--run.spatial_axis={mesh or 1}",
                                         f"--run.name={name}"])
        net = tu.build_unet3d(cfg, "cpu")
        if sign:
            net.load_state_dict(_moved(net.state_dict(), sign))
        first = {}

        def first_grads(optimizer, *_):
            if not first:
                first.update(_grads(net))
        spatial.reset_halo_stats()
        kernels.reset_launches()
        cuda = torch.device(cfg.run.device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hook = register_optimizer_step_pre_hook(first_grads)
        try:
            net, res = tu.train(cfg, iters, crop, net=net)
        finally:
            hook.remove()
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        return {"results": res, "wall_s": time.perf_counter() - t0,
                "peak_bytes": peak, "peak_bytes_per_rank": _peaks(peak),
                "halo": dict(spatial.HALO_STATS),
                "launches": dict(kernels.LAUNCHES),
                "state": to_cpu(net.state_dict()), "grads": first}

    def gap(got, want):
        return {**_run_gap([r["loss"] for r in got["results"]["log"]],
                           [r["loss"] for r in want["results"]["log"]],
                           got["state"], want["state"]),
                "first_grads": norm_gap(got["grads"], want["grads"]),
                "first_grads_leaf": leaf_gap(got["grads"], want["grads"])}
    return _alone_and_on_ranks(run, gap, (spatial_size,))


def run_trainer(module: str, cfg, train_iters: int, *args) -> dict:
    """``semantic_segmentation_torch.train.<module>.train(cfg, train_iters,
    *args)`` on every rank of the group (the ranks a trainer would start
    itself); rank 0's results."""
    import importlib
    mod = importlib.import_module(f"semantic_segmentation_torch.train.{module}")
    return to_cpu(mod.train(cfg, train_iters, *args)[1])


def collective_probe(device: str, n: int) -> dict:
    """Each reduction of ``parallel/collectives.py`` once on a small tensor
    of this rank's device (rank r holds r + 1 ... ): its results and the
    min-max gradient, for a check that every collective the path needs
    runs on the group's backend."""
    dev = _device(device)
    r, w = collectives.rank(), collectives.world()
    x = (torch.arange(n, dtype=torch.float32, device=dev) + 1 + r * n
         ).requires_grad_(True)
    lo, hi = collectives.global_min_max(x)
    # each rank's share of the global value (collectives' convention): the
    # input gradient is then the global function's
    ((hi - 2 * lo) / w).backward()
    var, mean = collectives.batch_var_mean(x.detach().reshape(1, 1, -1)
                                           .expand(2, 1, -1), (0, 2))
    s = collectives.all_reduce_sum(x.detach().sum())
    return {"world": w, "lo": float(lo), "hi": float(hi),
            "grad": x.grad.cpu(), "sum": float(s), "mean": float(mean),
            "var": float(var), "jax_loaded": "jax" in sys.modules}


def generator_arch_grad(x, mesh: tuple | None = None):
    """The gradient of a train-mode ``unet_32`` generator's (ngf 8, weights
    and an arch table of scale 0.5 drawn from seed 0) mean squared output
    on the global batch ``x`` (N, 1, 32, 32; numpy) with respect to its
    arch table; with ``mesh`` (n_data, n_model), on that mesh with the
    generator sharded (None on a rank outside it)."""
    from semantic_segmentation_torch.models.pix2pix.networks import define_G
    g = torch.Generator().manual_seed(0)
    net = define_G(1, 1, "unet_32", 8, generator=g)
    arch = (0.5 * torch.randn(net.num_downs, 3, generator=g)
            ).requires_grad_(True)
    tp = None if mesh is None else tp_mesh(mesh, "cpu")
    if mesh is not None and tp is None:
        return None
    rows = torch.from_numpy(x)
    if tp is not None:
        tensor_parallel.shard_state_tp(tp, net)
        rows = shard_batch(tp.data_mesh, rows)
    with tp.axes() if tp is not None else contextlib.nullcontext():
        loss = net(rows, arch).square().mean()
        grad, = torch.autograd.grad(loss, [arch])
        grad = collectives.mean_over_ranks(grad)
    return grad.detach()


def mesh_layout(shape: tuple) -> dict:
    """This rank's place on the (data, model) mesh of ``shape`` and the
    ranks of its data and model groups."""
    import torch.distributed as dist
    tp = tp_mesh(shape, "cpu")
    if tp is None:
        return None
    return {"rank": tp.rank, "data_rank": tp.data_rank,
            "model_rank": tp.model_rank,
            "data_group": dist.get_process_group_ranks(tp.data_group),
            "model_group": dist.get_process_group_ranks(tp.model_group)}


def unet3d_sgd_step(level_channels: tuple, bottleneck: int, state: dict,
                    batch: dict, lr: float, spatial_size: int = 1) -> dict:
    """One SGD step of a float32 UNet3D (``tests/test_spatial.py``'s step:
    ``seg3d_loss`` of the logits of ``batch['B']`` (N, D, H, W, 1) against
    ``batch['mask']`` (N, D, H, W), numpy) from ``state`` on the CPU, over
    a spatial mesh of the group's first ``spatial_size`` ranks (1: alone,
    the reductions off). Returns the loss, the state after the step and
    the step's gradients (averaged over the mesh)."""
    from semantic_segmentation_torch.models.unet3d import UNet3D
    from semantic_segmentation_torch.parallel import spatial
    from semantic_segmentation_torch.train.train_end2end_3d import (
        ncdhw, seg3d_loss)
    net = UNet3D(1, 2, tuple(level_channels), bottleneck)
    net.load_state_dict(state)
    mesh = spatial.make_spatial_mesh(spatial_size, "cpu") \
        if spatial_size > 1 else None
    if spatial_size > 1 and mesh is None:        # a rank outside the mesh
        return None
    with spatial.depth_sharded(mesh), (
            collectives.replicated() if mesh is None
            else contextlib.nullcontext()):
        b = {k: torch.from_numpy(v) for k, v in
             spatial.shard_volume_batch(mesh, batch).items()}
        loss = seg3d_loss(net(ncdhw(b["B"])), b["mask"])
        loss.backward()
        collectives.all_reduce_grads(net.parameters())
        loss = collectives.mean_over_ranks(loss.detach())
    grads = _grads(net)
    with torch.no_grad():
        for q in net.parameters():
            q -= lr * q.grad
    return {"loss": float(loss), "state": to_cpu(net.state_dict()),
            "grads": grads}


def halo_gradcheck(slab: int, p: int = 1, ranks: int | None = None
                   ) -> bool:
    """``torch.autograd.gradcheck`` in float64 of the depth halo over the
    pool's group, through a function of the whole volume that every rank
    computes alike: its slab (``split_depth``) with its halo, the padded
    slabs gathered (``gather_depth``). The collectives' gradients are of
    the sum over the ranks of their outputs, so the volume enters through
    ``mean_over_ranks`` (the volume itself, as every rank holds it; its
    backward the mean over ranks): each rank's analytical gradient is then
    the Jacobian of its own output, which the numerical one, perturbing
    the volume on every rank alike, measures. Over the group's first
    ``ranks`` (default every one)."""
    from semantic_segmentation_torch.parallel import spatial
    mesh = spatial.make_spatial_mesh(ranks, "cpu")
    if mesh is None:                # a rank outside the mesh
        return True
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, slab * mesh.size, 3, 2), generator=g,
                    dtype=torch.float64, requires_grad=True)

    def fn(v):
        v = collectives.mean_over_ranks(v)
        y = spatial.halo(spatial.split_depth(v, mesh), p, mesh)
        return spatial.gather_depth(y, mesh)

    with spatial.depth_sharded(mesh):
        return torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-8)


def exchange_probe(device: str) -> dict:
    """Each exchange of tensor and spatial parallelism once on small
    tensors of this rank's device, over the whole group (rank r holds
    slice r of a seeded volume): the channel gather in float32 and
    bfloat16, the depth halo with its backward, and the depth gather.
    Rank 0's results on the CPU, for a check that the exchanges give the
    same values on the card's backend as on the CPU's."""
    import torch.distributed as dist

    from semantic_segmentation_torch.parallel import spatial
    dev = _device(device)
    r, w = dist.get_rank(), dist.get_world_size()
    g = torch.Generator().manual_seed(0)
    full = torch.randn((2, 3 * w, 2 * w, 3, 4), generator=g)
    weights = torch.randn((2, 3 * w, 4, 3, 4), generator=g)
    ch = full[:, 3 * r:3 * r + 3].to(dev)
    out = {"gathered": tensor_parallel.gather_channels(ch, None),
           "gathered_bf16": tensor_parallel.gather_channels(
               ch.bfloat16(), None)}
    mesh = spatial.make_spatial_mesh(None, dev.type)
    x = full[:, :, 2 * r:2 * r + 2].to(dev).requires_grad_(True)
    y = spatial.halo(x, 1, mesh)
    (y * weights.to(dev)).sum().backward()
    out.update(halo=y, halo_grad=x.grad,
               depth=spatial.gather_depth(x.detach(), mesh))
    return to_cpu(out)
