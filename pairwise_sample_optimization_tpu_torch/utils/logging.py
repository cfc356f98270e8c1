"""Console and JSONL metrics: an append-only ``metrics.jsonl`` per run
(one ``{"step", "ts", ...}`` object per line), as the JAX package writes;
with ``use_wandb`` also wandb where it can be imported and a run started
(else a warning, and the JSONL alone), as there."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional


def get_logger(name: str = "pso") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


WANDB_PROJECT = "Online_PSO"  # the JAX package's project for every run


class MetricLogger:
    def __init__(self, output_dir: Optional[str] = None, run_name: str = "run",
                 use_wandb: bool = False, config: Optional[dict] = None):
        self.log = get_logger()
        self._jsonl = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=WANDB_PROJECT, name=run_name,
                                         config=config or {})
            except Exception as e:  # wandb absent or offline: the JSONL still records
                self.log.warning("wandb unavailable (%s); JSONL logging only", e)

    def log_metrics(self, metrics: Dict[str, Any], step: int):
        clean = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **clean}) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(clean, step=step)
        self.log.info("step %d: %s", step,
                      {k: round(v, 5) if isinstance(v, float) else v for k, v in clean.items()})

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
