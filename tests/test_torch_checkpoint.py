"""The port's run artifacts against the JAX package's: ``CheckpointManager``
retention (the steps left on disk, ``best_step``, ``latest_step``) on the
same save sequences as the orbax-backed JAX manager, ties and overwrites
included, also after reopening the directory; a ``restore`` round trip; and
``MetricsLogger`` records with the same keys and values as the JAX logger's
for the same calls, apart from the wall clock ``t``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.core.checkpoint import \
    CheckpointManager as JManager
from semantic_segmentation_tpu.core.logging_utils import \
    MetricsLogger as JLogger
from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.logging_utils import MetricsLogger


def v(x):
    return {"val_score": x}


SEQUENCES = {   # case: (manager kwargs, [(step, metrics), ...])
    "max": ({}, [(1, v(.5)), (2, v(.7)), (3, v(.6)), (4, v(.4)), (5, v(.9))]),
    "max_ties": ({}, [(1, v(.7)), (2, v(.5)), (3, v(.5)), (4, v(.5)),
                      (5, v(.6))]),
    "all_tied": ({}, [(3, v(.5)), (1, v(.5)), (2, v(.5)), (4, v(.5))]),
    "overwrite": ({}, [(1, v(.5)), (2, v(.7)), (3, v(.6)), (2, v(.1)),
                       (4, v(.4))]),
    "overwrite_last": ({}, [(1, v(.5)), (2, v(.7)), (3, v(.6)), (2, v(.1))]),
    "missing_metric": ({}, [(1, {}), (2, v(.7)), (3, None), (4, v(.4))]),
    "min": ({"best_mode": "min"}, [(1, v(.5)), (2, v(.7)), (3, v(.6)),
                                   (4, v(.4)), (5, v(.9))]),
    "min_ties": ({"best_mode": "min", "max_to_keep": 2},
                 [(1, v(.5)), (2, v(.5)), (3, {}), (4, v(.5))]),
    "latest": ({"best_key": None}, [(5, v(.5)), (2, v(.7)), (3, v(.6)),
                                    (1, v(.8))]),
    "keep_one": ({"max_to_keep": 1}, [(1, v(.5)), (2, v(.4)), (3, v(.6))]),
}


def _drive(cls, directory, kwargs, seq):
    """The sequence through a manager, then a reopened manager and one more
    save; (steps on disk, best, latest) after each part."""
    def seen(m):
        on_disk = sorted(int(s) for s in os.listdir(directory) if s.isdigit())
        return on_disk, m.best_step(), m.latest_step()

    m = cls(directory, **kwargs)
    for step, metrics in seq:
        m.save(step, {"x": np.asarray(step, np.float32)}, metrics, force=True)
    m.wait()
    out = [seen(m)]
    m.close()
    m = cls(directory, **kwargs)
    out.append(seen(m))
    m.save(9, {"x": np.asarray(9, np.float32)}, v(.55), force=True)
    m.wait()
    out.append(seen(m))
    m.close()
    return out


@pytest.mark.parametrize("case", SEQUENCES)
def test_retention_matches_orbax(case, tmp_path):
    kwargs, seq = SEQUENCES[case]
    ref = _drive(JManager, str(tmp_path / "jax"), kwargs, seq)
    got = _drive(CheckpointManager, str(tmp_path / "torch"), kwargs, seq)
    assert got == ref


def test_restore_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    state = {"engine": {"w": torch.randn(3, 4, generator=gen),
                        "gen": gen.get_state(), "step": 7,
                        "opt": {"state": {0: {"step": torch.tensor(2.0)}},
                                "param_groups": [{"lr": 1e-4,
                                                  "params": [0]}]}},
             "host": {"best_val": 0.25, "plateau": {"best": float("-inf")}}}
    m = CheckpointManager(str(tmp_path / "ckpt"))
    assert m.restore() == (None, None)
    m.save(4, state, v(0.25))
    restored, step = m.restore({"engine": None, "host": None})
    assert step == 4
    assert torch.equal(restored["engine"]["w"], state["engine"]["w"])
    assert torch.equal(restored["engine"]["gen"], state["engine"]["gen"])
    assert restored["engine"]["opt"] == state["engine"]["opt"]
    assert restored["host"] == state["host"]
    with pytest.raises(ValueError, match="expected"):
        m.restore({"unet": None})
    # no temporary directory is left behind
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4"]


def test_metrics_logger_records_match_jax(tmp_path):
    calls = [({"loss": 1.5, "count": 3, "name": "x", "arch": [[0.1, 0.2]]},
              4),
             ({"val_score": 0.625}, None)]
    for k, cls, scalar in (("jax", JLogger, jnp.float32),
                           ("torch", MetricsLogger, torch.tensor)):
        log = cls(str(tmp_path / k))
        for metrics, step in calls:
            log.log({**metrics, "device_scalar": scalar(0.75)}, step)
        log.log_images({"panel": np.zeros((4, 4), np.float32)}, 5)
        log.close()
    records = {}
    for k in ("jax", "torch"):
        with open(tmp_path / k / "metrics.jsonl") as f:
            records[k] = [json.loads(line) for line in f]
    for rec in records["jax"] + records["torch"]:
        assert isinstance(rec.pop("t"), float)
    assert records["torch"] == records["jax"]
    assert records["torch"][0]["device_scalar"] == 0.75
