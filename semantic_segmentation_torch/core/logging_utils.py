"""Metric stream: host logging, a JSONL record per ``log`` call, and wandb
when it is installed and asked for — the port of
``semantic_segmentation_tpu/core/logging_utils.py``.

Metrics always go to ``<save_dir>/metrics.jsonl`` (appended, so a resumed
run continues its stream), one object per call: ``t`` (wall clock), ``step``
when given, and the metrics, each as a float where it has ``__float__``
(tensors, numpy scalars). wandb attaches only if it imports and initializes;
otherwise the run warns and goes on offline.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

logger = logging.getLogger("semantic_segmentation_torch")


class MetricsLogger:
    def __init__(self, save_dir: str, use_wandb: bool = False,
                 wandb_project: str = "", run_name: str = "",
                 config: Mapping[str, Any] | None = None):
        os.makedirs(save_dir, exist_ok=True)
        self._fh = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore
                self._wandb = wandb.init(project=wandb_project, name=run_name,
                                         resume="allow", anonymous="must")
                if config:
                    self._wandb.config.update(dict(config))
            except Exception as e:  # wandb is optional: any failure to
                # import or reach it leaves the JSONL stream as the record
                logger.warning("wandb unavailable (%s); continuing without", e)

    def log_images(self, images: Mapping[str, Any], step: int | None = None):
        """wandb image panels (train_end2end_jsrt.py:206-223 ims_dict); does
        nothing without wandb."""
        if self._wandb is not None:
            import wandb  # type: ignore
            self._wandb.log({k: wandb.Image(v) for k, v in images.items()},
                            step=step)

    def log(self, metrics: Mapping[str, Any], step: int | None = None):
        rec = {"t": time.time(),
               **({"step": step} if step is not None else {}),
               **{k: float(v) if hasattr(v, "__float__") else v
                  for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def info(self, msg: str, *args):
        logger.info(msg, *args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
