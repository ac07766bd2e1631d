"""Checkpoint / resume on ``torch.save`` — the port of
``semantic_segmentation_tpu/core/checkpoint.py`` (an orbax manager there).

One directory per step, ``<directory>/<step>/`` holding ``state.pt`` (the
whole state tree: ``state_dict``s, generator states, host values) and
``metrics.json``. A save writes a temporary directory and renames it into
place, so a step directory is either whole or absent; saving a step that
exists replaces it. Saves are synchronous.

Retention is orbax's, with the JAX manager's options: the manager keeps its
steps in the order they were saved (in step order when it opens a
directory). With ``best_key`` it keeps the ``max_to_keep`` best by
``metrics[best_key]`` (missing: 0.0 for ``best_mode='max'``, +inf for
``'min'``), ranked by a stable sort of that order, so of equal metrics the
later-saved ranks better; ``best_step`` is the best. Without it, it keeps
the last ``max_to_keep`` saved, and ``best_step`` is ``latest_step``, the
last saved.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from semantic_segmentation_torch.parallel.collectives import is_main

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 best_key: str | None = "val_score", best_mode: str = "max"):
        """``best_key``/``best_mode`` parameterize retention: the end2end
        trainers keep best-val Dice (max); ``best_key=None`` keeps the most
        recent ``max_to_keep``."""
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', not "
                             f"{best_mode!r}")
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        self._best_key, self._best_mode = best_key, best_mode
        self._default = 0.0 if best_mode == "max" else float("inf")
        os.makedirs(self._dir, exist_ok=True)
        self._metrics: dict[int, dict] = {}
        for name in os.listdir(self._dir):   # ignores .tmp-* (unfinished)
            path = os.path.join(self._dir, name)
            if name.isdigit() and os.path.isfile(os.path.join(path,
                                                              STATE_FILE)):
                with open(os.path.join(path, METRICS_FILE)) as f:
                    self._metrics[int(name)] = json.load(f)
        self._steps: list[int] = sorted(self._metrics)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _score(self, step: int) -> float:
        return self._metrics[step].get(self._best_key, self._default)

    def _ranked(self) -> list[int]:
        """The steps from worst to best (stable: ties keep saving order)."""
        return sorted(self._steps, key=self._score,
                      reverse=self._best_mode == "min")

    def save(self, step: int, state: Any, metrics: dict | None = None,
             force: bool = False):
        """Write ``state`` as step ``step`` with its ``metrics``, then drop
        the steps retention does not keep. ``force`` is the JAX manager's
        (it overrides orbax's save-interval policy): this manager has no
        such policy and writes every save. Under data parallelism rank 0
        alone writes (every rank holds the same state)."""
        del force
        if not is_main():
            return
        tmp = os.path.join(self._dir, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump(dict(metrics or {}), f)
        if step in self._metrics:             # resume/re-run overwrite
            shutil.rmtree(self._step_dir(step))
            self._steps.remove(step)
        os.replace(tmp, self._step_dir(step))
        self._steps.append(step)
        self._metrics[step] = dict(metrics or {})
        if len(self._steps) > self._keep:
            keep = set(self._steps[-self._keep:] if self._best_key is None
                       else self._ranked()[-self._keep:])
            for s in [s for s in self._steps if s not in keep]:
                shutil.rmtree(self._step_dir(s))
                self._steps.remove(s)
                del self._metrics[s]

    def restore(self, template: Any = None, step: int | None = None):
        """(state, step) of ``step`` (default: the latest), or (None, None)
        when there is none; tensors load onto the CPU (``load_state_dict``
        copies them where they belong). ``template``, where given, is a
        tree of the expected layout: the file's top-level keys must equal
        its (the port's ``state_dict``s carry their own structure, so that
        is all it is checked against)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        state = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        if template is not None and set(state) != set(template):
            raise ValueError(f"checkpoint step {step} in {self._dir} holds "
                             f"{sorted(state)}, expected {sorted(template)}")
        return state, step

    def best_step(self):
        if self._best_key is None:
            return self.latest_step()
        return self._ranked()[-1] if self._steps else None

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def wait(self):
        """Nothing to wait for: saves are synchronous."""

    def close(self):
        """Nothing to release: no file stays open between calls."""
