"""Rank-side functions that run the data-parallel steps from a
``launch.RankPool``, so that a harness can hold n ranks against one
process on the same state, batches and draws (``tests/test_torch_parallel.py``
on the CPU, ``chip_smoke.py`` phase 7j on the card).

Each function runs on every rank of the pool's group, builds its nets once
per process (cached by their configuration), loads the state it is given
(the same on every rank) and returns plain values: floats, and tensors on
the CPU. The batches and draws it is given are the global ones; each rank
takes its rows (``parallel/data_parallel.py``).
"""

from __future__ import annotations

import math
import sys
import time

import torch

from semantic_segmentation_torch.parallel import collectives
from semantic_segmentation_torch.parallel.data_parallel import (
    dp_engine_step, dp_seg_step, to_cpu, to_device)
from semantic_segmentation_torch.parallel.mesh import (DataMesh,
                                                       make_data_mesh,
                                                       process_count)

_BUILT: dict = {}


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


def nets_state(engine) -> dict:
    """The parts of an engine's state that ``state_gap`` compares, on the
    CPU: each problem's parameters and BN statistics (``module``) and the
    gradients its last optimizer step took (``grads``, averaged over the
    ranks: what the gradient all-reduce gave), the arch tables."""
    return {"problems": {p.name: {"module": to_cpu(p.module.state_dict()),
                                  "grads": _grads(p.module)}
                         for p in engine.problems},
            "arch": to_cpu(dict(engine.arch))}


def _grads(module) -> dict:
    return {k: to_cpu(q.grad) for k, q in module.named_parameters()
            if q.grad is not None}


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
                      timed: bool = False, compare_to: dict | None = None
                      ) -> dict:
    """From ``state`` (an engine ``state_dict``, on the CPU; None: the
    state the engine's nets were built with, kept in ``_BUILT`` at the
    first such call), one ``dp_engine_step`` per entry of ``steps`` ((batch_stack, val_batch,
    draws), global, on the CPU). Returns the metrics of each step, the
    final ``nets_state`` (with ``return_state``), the seconds of each step
    (ending in a device sync), the gradient all-reduces' calls, bytes and
    seconds over all steps (``timed``: each ending in a device sync), every
    rank's peak device memory, the kernel launches of this rank, and the
    final state's ``state_gap`` to the ``nets_state`` ``compare_to``."""
    from semantic_segmentation_torch import kernels
    dev = _device(device)
    engine = build_engine(argv, preset, device)
    if state is None:
        key = ("start", tuple(argv), device)
        if key not in _BUILT:
            _BUILT[key] = to_cpu(engine.state_dict())
        state = _BUILT[key]
    engine.load_state_dict(state)
    # the whole batch where the collectives are off (``alone_and_on_ranks``)
    mesh = DataMesh(collectives.world(), collectives.rank(), dev.type)
    collectives.reset_grad_stats(timed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    metrics, seconds = [], []
    for batch_stack, val_batch, draws in steps:
        t0 = time.perf_counter()
        m = dp_engine_step(engine, mesh, to_device(batch_stack, dev),
                           to_device(val_batch, dev), to_device(draws, dev))
        metrics.append({k: float(v) for k, v in m.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    peaks = torch.zeros(collectives.world(), dtype=torch.float64,
                        device=dev if dev.type == "cuda" else "cpu")
    if dev.type == "cuda":
        peaks[collectives.rank()] = torch.cuda.max_memory_allocated(dev)
    peaks = collectives.all_reduce_sum(peaks)
    final = nets_state(engine) if return_state or compare_to else None
    return {"metrics": metrics, "seconds": seconds,
            "grad_allreduce": {k: collectives.GRAD_STATS[k]
                               for k in ("calls", "bytes", "seconds")},
            "peak_bytes": [int(p) for p in peaks.tolist()],
            "launches": launches, "world": collectives.world(),
            "state": final if return_state else None,
            "state_gap": (None if compare_to is None
                          else state_gap(final, compare_to))}


def one_ulp_moved(state: dict, sign: float) -> dict:
    """A copy of an engine state with every parameter (not the BN
    statistics) one ulp up (``sign`` 1) or down (-1)."""
    moved = to_cpu(state)
    for prob in moved["problems"].values():
        for k, w in prob["module"].items():
            if w.is_floating_point() and "running" not in k:
                w.copy_(torch.nextafter(w, torch.full_like(
                    w, sign * math.inf)))
    return moved


def alone_and_on_ranks(argv: tuple, preset: str, device: str,
                       steps: list) -> dict:
    """On every rank of a pool: the iterations ``steps`` from the nets as
    built, alone and on the ranks, with no state crossing a process.
    Rank 0 first runs them alone with the collectives off
    (``collectives.replicated``: the plain program over the global batch),
    from the nets and from them with every parameter one ulp up and one
    ulp down (``one_ulp_moved``); then every rank runs them data-parallel,
    its gradient all-reduces timed. Rank 0 holds each later run's final
    state against the first run's (``state_gap``). Returns {"one": the
    first run's ``engine_iterations`` record, "nudged": the two moved
    runs', "two": the data-parallel run's (their ``state_gap`` set, no
    state), "alone_s", "ranks_s": the wall seconds of rank 0's runs alone
    and of the data-parallel run}."""
    out, ref = {}, None
    t0 = time.perf_counter()
    if collectives.rank() == 0:
        with collectives.replicated():
            out["one"] = engine_iterations(argv, preset, device, None, steps)
            ref = out["one"].pop("state")
            start = _BUILT[("start", tuple(argv), device)]
            out["nudged"] = [engine_iterations(
                argv, preset, device, one_ulp_moved(start, sign), steps,
                False, compare_to=ref) for sign in (1.0, -1.0)]
    t1 = time.perf_counter()
    out["two"] = engine_iterations(argv, preset, device, None, steps,
                                   False, timed=True, compare_to=ref)
    out["alone_s"], out["ranks_s"] = t1 - t0, time.perf_counter() - t1
    return out


def darts_term(argv: tuple, preset: str, device: str, state: dict,
               step: tuple) -> dict:
    """The ``darts`` hypergradient (``BilevelEngine._darts_hypergrad``) at
    ``state`` itself, on this rank's rows of the global ``step``
    ((batch_stack, val_batch, draws)): {arch name: hypergradient} on the
    CPU. An engine iteration takes it at the unrolled state, which carries
    the inner steps' rounding; this is the term alone."""
    from semantic_segmentation_torch.parallel.mesh import shard_batch
    dev = _device(device)
    engine = build_engine(argv, preset, device)
    engine.load_state_dict(state)
    mesh = make_data_mesh(process_count(), dev.type)
    batch_stack, val_batch, draws = to_device(step, dev)
    hg, _ = engine._darts_hypergrad([shard_batch(mesh, b) for b in batch_stack],
                                    shard_batch(mesh, val_batch),
                                    (draws or {}).get("hyper"))
    return to_cpu(hg)


def seg_steps(argv: tuple, device: str, net_state: dict, batches: list
              ) -> dict:
    """From ``net_state``, one ``dp_seg_step`` (``train_unet``'s step) per
    numpy NHWC global batch of ``batches``, with a fresh optimizer. Returns
    each step's loss, the net's final state and the gradients of the last
    step (averaged over the ranks)."""
    from semantic_segmentation_torch.core.config import parse_config
    from semantic_segmentation_torch.train.common import (autocast_for,
                                                          build_seg_problem)
    dev = _device(device)
    cfg = parse_config(list(argv))
    key = ("seg", tuple(argv), device)
    if key not in _BUILT:
        _BUILT[key] = build_seg_problem(cfg, dev)
    seg = _BUILT[key]
    seg.net.load_state_dict(net_state)
    opt = seg.make_opt()
    mesh = make_data_mesh(process_count(), dev.type)
    losses = [float(dp_seg_step(seg, opt, mesh, b, autocast_for(cfg, dev)))
              for b in batches]
    return {"losses": losses, "state": to_cpu(seg.net.state_dict()),
            "grads": _grads(seg.net)}


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
