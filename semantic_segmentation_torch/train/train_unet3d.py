"""Supervised 3D segmentation baseline — the port of
``semantic_segmentation_tpu/train/train_unet3d.py``
(``GenSeg-3D/train_unet.py:37-202``): UNet3D trained with RMSprop on the
weighted cross entropy + argmax-Dice loss, the validation argmax Dice
every ``engine.valid_step`` steps, the U-Net saved at every new best
(``unet3d.pt``), and the final net's test Dice.

Spatial parallelism (``--run.spatial_axis=n``: 1 off, 0 every visible card,
n the first n; ``parallel/spatial.py``): ``train`` starts n ranks
(``parallel/launch.run_ranks``; gloo processes on the CPU, one card each
over NCCL), each holding one depth slab of every training and evaluation
volume and the whole state, with halos around the k3 convs, the BN
statistics, loss sums and Dice sums over the group and the gradients
averaged. Rank 0 writes ``unet3d.pt`` (the one-process layout) and
``metrics.jsonl``; every rank returns the same results.

Usage: ``python -m semantic_segmentation_torch.train.train_unet3d
--data.dataroot=<dir with imgsA/ imgsB/ truths/> [--data.synthetic=true]
[--run.device=cpu] [--run.spatial_axis=2]``.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from semantic_segmentation_torch.core.config import (Config, parse_config,
                                                     resolve_device)
from semantic_segmentation_torch.core.logging_utils import MetricsLogger
from semantic_segmentation_torch.core.optim import rmsprop_torch
from semantic_segmentation_torch.data.pipeline import (batch_iterator,
                                                       eval_batches)
from semantic_segmentation_torch.models.unet3d import UNet3D
from semantic_segmentation_torch.ops import losses
from semantic_segmentation_torch.parallel import collectives, launch
from semantic_segmentation_torch.parallel.data_parallel import to_cpu
from semantic_segmentation_torch.parallel.mesh import rank_device
from semantic_segmentation_torch.parallel.spatial import (
    depth_sharded, replicate_state, shard_volume_batch,
    spatial_mesh_from_config)
from semantic_segmentation_torch.train.common import autocast_for
from semantic_segmentation_torch.train.train_end2end_3d import (
    load_volume_splits, ncdhw, seg3d_loss)

MODEL_FILE = "unet3d.pt"


def build_unet3d(cfg: Config, device) -> UNet3D:
    """UNet3D at ``model.base_features`` (x1, x2, x4, bottleneck x8), its
    weights drawn from a CPU generator seeded with ``run.seed``."""
    b = cfg.model.base_features
    return UNet3D(1, 2, (b, 2 * b, 4 * b), 8 * b,
                  torch.Generator().manual_seed(cfg.run.seed)).to(device)


def train_step(net, optimizer, batch, amp):
    """One RMSprop step on a batch of device tensors (under a spatial mesh
    this rank's depth slabs, the gradients averaged over the group);
    returns the loss of the whole volumes."""
    net.train()
    with amp():
        logits = net(ncdhw(batch["B"].float()))
        loss = seg3d_loss(logits, batch["mask"][..., 0].float())
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    collectives.all_reduce_grads(net.parameters())
    optimizer.step()
    return collectives.mean_over_ranks(loss.detach())


@torch.no_grad()
def evaluate(net, data, batch_size: int, amp, mesh=None) -> float:
    """The mean over batches of the argmax Dice of ``net`` in eval mode
    (under the spatial mesh ``mesh``, on this rank's depth slabs, the Dice
    sums over the group)."""
    device = next(net.parameters()).device
    net.eval()
    total, count = 0.0, 0
    with depth_sharded(mesh):
        for b in eval_batches(data, batch_size):
            b = shard_volume_batch(mesh, b)
            with amp():
                logits = net(ncdhw(torch.from_numpy(b["B"]).float().to(
                    device)))
            total += float(losses.argmax_dice_score(
                logits, torch.from_numpy(b["mask"][..., 0]).float().to(
                    device)))
            count += 1
    return total / max(count, 1)


def _rank_train(cfg: Config, train_iters, crop, device, net):
    """``train`` on one rank that ``train`` started; rank 0's net state (on
    the CPU) and results."""
    net, results = train(cfg, train_iters, crop, device, net)
    return to_cpu(net.state_dict()), results


def train(cfg: Config, train_iters: int | None = None, crop: int = 64,
          device=None, net: UNet3D | None = None):
    """Train ``net`` (default ``build_unet3d``'s) on ``device`` (default
    ``cfg.run.device``, 'cuda') for ``train_iters`` steps (default
    ``engine.train_iters``). Returns (net, results); ``results['log']`` has
    one record per validation: step, loss, val score, best, and the steps
    since the last record with their wall seconds (ending in a device sync;
    the save is not counted). With ``run.spatial_axis`` > 1 and no process
    group up, the ranks start here (module docstring)."""
    mesh = spatial_mesh_from_config(cfg)
    if mesh is not None and not dist.is_initialized():
        state, results = launch.run_ranks(
            _rank_train, mesh.size, (cfg, train_iters, crop, device, net),
            mesh.device_type)
        net = build_unet3d(cfg, resolve_device(device or cfg.run.device))
        net.load_state_dict(state)
        return net, results
    dev = rank_device(resolve_device(device or cfg.run.device))
    net = build_unet3d(cfg, dev) if net is None else net.to(dev)
    amp = autocast_for(cfg, dev)
    optimizer = rmsprop_torch(net.parameters(), cfg.optim.unet_lr)
    if mesh is not None:
        replicate_state(mesh, net)
    splits = load_volume_splits(cfg, crop)
    save_dir = os.path.join(cfg.run.save_dir, cfg.run.name)
    bs = cfg.data.batch_size
    records = []
    with MetricsLogger(save_dir) as log, depth_sharded(mesh):
        iters = train_iters or cfg.engine.train_iters
        it, epoch, best = 0, 0, 0.0
        last, t0 = 0, time.perf_counter()
        while it < iters:
            rng = np.random.default_rng((cfg.run.seed, epoch))
            for batch in batch_iterator(splits["train"], bs, rng):
                loss = train_step(net, optimizer,
                                  {k: torch.from_numpy(v).to(dev)
                                   for k, v in shard_volume_batch(
                                       mesh, batch).items()}, amp)
                it += 1
                if it % cfg.engine.valid_step == 0:
                    val = evaluate(net, splits["val"], bs, amp, mesh)
                    seconds = time.perf_counter() - t0
                    if val > best:
                        best = val
                        if collectives.is_main():
                            torch.save(net.state_dict(),
                                       os.path.join(save_dir, MODEL_FILE))
                    rec = {"loss": float(loss), "val_score": val,
                           "best_val": best}
                    log.log(rec, it)
                    records.append({"step": it, **rec, "steps": it - last,
                                    "seconds": seconds})
                    last, t0 = it, time.perf_counter()
                if it >= iters:
                    break
            epoch += 1
        results = {"best_val": best}
        if splits["test"] is not None:
            results["test_dice"] = evaluate(net, splits["test"], bs, amp,
                                            mesh)
        log.log(results, it)
        log.info("final: %s", results)
    return net, {**results, "log": records}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    train(parse_config(argv))


if __name__ == "__main__":
    main()
