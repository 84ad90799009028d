"""Training metrics sink: one JSON object a line in ``<log_dir>/metrics.jsonl``
(the JAX package's MetricsWriter without its TensorBoard branch)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
