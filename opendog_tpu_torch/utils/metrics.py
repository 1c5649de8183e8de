"""Metrics / logging: a copy of the JAX package's JAX-free
``utils/metrics.py``.

The reference logs through TensorBoard (SB3 logger + custom per-info-key
means every 100 steps, ``train/train.py:31-44``) and console episode lines
(``sim2real/train.py:552``).  This writer emits JSONL always (machine
readable, no deps) and TensorBoard events when a writer is available
(torch.utils.tensorboard is in the image).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, directory: str, use_tensorboard: bool = True):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=directory)
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "") -> None:
        flat = {
            (f"{prefix}/{k}" if prefix else k): float(v)
            for k, v in metrics.items()
        }
        rec = {"step": int(step), "time": time.time(), **flat}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
