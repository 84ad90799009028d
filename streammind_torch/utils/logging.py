"""Metric smoothing for the training log (the JAX package's SmoothedValue and
MetricLogger).  Log records go through the standard ``logging`` module;
nothing here opens a file."""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    """Windowed + global average tracker."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg)


class MetricLogger:
    """Named smoothed meters, printed as "name: median (global avg)"."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())
