"""Latency observability: per-stage percentile trackers, a JSONL sink, a
sliding-window rate, a ``torch.profiler`` trace window and a device sync.

``LatencyTracker``, ``StageProfiler`` and ``ThroughputMeter`` are the JAX
package's, on the host clock.  ``device_trace(log_dir)`` records the CPU
and (with a card) CUDA activity of its block and writes a Chrome trace
there; ``force_execute(x)`` waits for the card when ``x`` holds a CUDA
tensor, so a host clock around it measures the work and not its enqueue.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .params import tree_leaves


class LatencyTracker:
    """Percentile tracker for one stage (e.g. 'perceive', 'prefill',
    'first_token'); keeps the newest ``capacity`` samples, in seconds."""

    def __init__(self, capacity: int = 10000):
        self.samples = deque(maxlen=capacity)
        self.capacity = capacity

    def add(self, seconds: float) -> None:
        self.samples.append(seconds)

    @contextlib.contextmanager
    def timed(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.add(time.perf_counter() - t0)

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.samples, q)) if self.samples else 0.0

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    def fps(self) -> float:
        return 1.0 / self.mean if self.mean > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "n": len(self.samples),
            "mean_ms": self.mean * 1000,
            "p50_ms": self.p50 * 1000,
            "p90_ms": self.percentile(90) * 1000,
            "p99_ms": self.p99 * 1000,
        }


class StageProfiler:
    """Named latency trackers and a JSONL sink."""

    def __init__(self, sink_path: Optional[str] = None):
        self.stages: Dict[str, LatencyTracker] = defaultdict(LatencyTracker)
        self.sink_path = sink_path

    def timed(self, stage: str):
        return self.stages[stage].timed()

    def add(self, stage: str, seconds: float):
        self.stages[stage].add(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: v.summary() for k, v in self.stages.items()}

    def flush(self, extra: Optional[Dict] = None) -> None:
        if not self.sink_path:
            return
        os.makedirs(os.path.dirname(self.sink_path) or ".", exist_ok=True)
        record = {"ts": time.time(), "stages": self.summary()}
        if extra:
            record.update(extra)
        with open(self.sink_path, "a") as f:
            f.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` window over the block (CPU activity, and CUDA
    activity when a card is present), written to ``log_dir`` as a Chrome
    trace (``trace.json``).  Yields the profiler, for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def force_execute(x) -> None:
    """Wait until the card has finished the work queued before this call
    when ``x`` (a tensor or a tree of them) holds a CUDA tensor; nothing on
    the CPU, whose tensors are computed when their call returns."""
    for t in tree_leaves(x):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class ThroughputMeter:
    """Sliding-window items/sec, for stream fps accounting."""

    def __init__(self, window: int = 200):
        self.times: List[float] = []
        self.window = window

    def tick(self, n: int = 1) -> None:
        now = time.perf_counter()
        self.times.extend([now] * n)
        if len(self.times) > self.window:
            self.times = self.times[-self.window:]

    def rate(self) -> float:
        if len(self.times) < 2:
            return 0.0
        span = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / span if span > 0 else 0.0
