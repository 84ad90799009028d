"""Loggers of the serving plane and metric smoothing for the training log
(the JAX package's build_logger, SmoothedValue and MetricLogger).

``build_logger`` gives each log file name one daily-rotating handler under
``constants.LOGDIR`` (relative to the working directory); the first file
also receives the records of every logger that exists when it is made.
"""
from __future__ import annotations

import logging
import logging.handlers
import os
from collections import defaultdict, deque
from typing import Dict

from ..constants import LOGDIR

_handlers: Dict[str, logging.Handler] = {}
_FORMAT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    formatter = logging.Formatter(fmt=_FORMAT, datefmt="%Y-%m-%d %H:%M:%S")
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format=_FORMAT)
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    if logger_filename not in _handlers:
        os.makedirs(LOGDIR, exist_ok=True)
        h = logging.handlers.TimedRotatingFileHandler(
            os.path.join(LOGDIR, logger_filename), when="D", utc=True, encoding="utf-8")
        h.setFormatter(formatter)
        if not _handlers:
            for item in logging.root.manager.loggerDict.values():
                if isinstance(item, logging.Logger):
                    item.addHandler(h)
        _handlers[logger_filename] = h
    if _handlers[logger_filename] not in logger.handlers:
        logger.addHandler(_handlers[logger_filename])
    return logger


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
