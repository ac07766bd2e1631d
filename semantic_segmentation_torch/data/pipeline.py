"""Batching: deterministic splits, shuffled index streams, and whole-split
device residency — the port's copy of ``semantic_segmentation_tpu/data/
pipeline.py``. ``epoch_index_batches`` is identical, so both packages draw
the same batch indices from the same seeds."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def stack_dataset(dataset, indices=None) -> dict[str, np.ndarray]:
    """Materialize a (subset of a) dataset into stacked NHWC arrays."""
    idx = range(len(dataset)) if indices is None else indices
    items = [dataset[i] for i in idx]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def subset_split(n_total: int, n_train: int, n_val: int, n_test: int):
    """The reference's deterministic split (train_end2end_jsrt.py:86-89):
    first n_train train, next n_val val, LAST n_test test."""
    idx = list(range(n_total))
    return (idx[:n_train], idx[n_train:n_train + n_val],
            idx[n_total - n_test:] if n_test else [])


def _check_nonempty_epoch(n: int, batch_size: int, drop_last: bool):
    if drop_last and n - (n % batch_size) == 0:
        raise ValueError(
            f"batch_size={batch_size} > split size {n} with drop_last=True "
            "produces zero batches per epoch; lower batch_size or pass "
            "drop_last=False")


def batch_iterator(data: Mapping[str, np.ndarray], batch_size: int,
                   rng: np.random.Generator):
    """One epoch of whole numpy batches (dicts of stacked arrays), the order
    shuffled in place by ``rng`` as the JAX package's ``batch_iterator``
    does with its defaults (shuffle, drop_last)."""
    n = len(next(iter(data.values())))
    _check_nonempty_epoch(n, batch_size, True)
    order = np.arange(n)
    rng.shuffle(order)
    for i in range(0, n - n % batch_size, batch_size):
        sel = order[i:i + batch_size]
        yield {k: v[sel] for k, v in data.items()}


def eval_batches(data: Mapping[str, np.ndarray], batch_size: int):
    """Sequential eval batches, the last one possibly short."""
    n = len(next(iter(data.values())))
    for i in range(0, n, batch_size):
        yield {k: v[i:i + batch_size] for k, v in data.items()}


def epoch_index_batches(n: int, batch_size: int, seed: int,
                        drop_last: bool = True):
    """Infinite stream of shuffled INDEX batches, reseeded per epoch."""
    _check_nonempty_epoch(n, batch_size, drop_last)
    epoch = 0
    while True:
        rng = np.random.default_rng((seed, epoch))
        order = rng.permutation(n)
        stop = n - (n % batch_size) if drop_last else n
        for i in range(0, stop, batch_size):
            yield order[i:i + batch_size]
        epoch += 1


def to_device_split(split: Mapping[str, np.ndarray], device):
    """One-time upload of a stacked split; batches are then index gathers on
    the device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in split.items()}


def take_batch(device_split, idx):
    """Device-side gather of a batch by an index array."""
    some = next(iter(device_split.values()))
    idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=some.device)
    return {k: v[idx_t] for k, v in device_split.items()}
