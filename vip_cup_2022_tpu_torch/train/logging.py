"""Experiment metric logging (counterpart of
``vip_cup_2022_tpu/train/logging.py``): one JSON line per ``log`` call in
``<log_dir>/<name>.jsonl``, the config first. The JAX logger also forwards to
``wandb`` when that package imports; the port writes the file only."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """``log({'loss': ..., 'lr': ...}, step=N)`` -> a JSONL row."""

    def __init__(self, log_dir: str, name: Optional[str] = None, config: Optional[Dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name or 'metrics'}.jsonl")
        self._fh = open(self.path, "a")
        if config:
            self._write({"_config": config, "_time": time.time()})

    def _write(self, row: Dict) -> None:
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        row = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        if step is not None:
            row["step"] = int(step)
        row["_time"] = time.time()
        self._write(row)

    def finish(self) -> None:
        self._fh.close()
