"""Training metrics sink: one JSON object a line in ``<log_dir>/metrics.jsonl``,
always, and TensorBoard scalars in ``log_dir`` where
``torch.utils.tensorboard`` imports (JSONL alone where it does not)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:  # noqa: BLE001 — no tensorboard: JSONL only
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
