"""Latency observability: per-stage percentile trackers, the program's
tracer (spans and counters, a JSONL sink), a ``torch.profiler`` trace
window and a device sync.

``LatencyTracker`` and ``StageProfiler``'s ``timed``, ``add``, ``summary``
and ``flush`` are the JAX package's, on the host clock.  ``StageProfiler``
is also the tracer, and ``tracer`` is the one instance the serving path
records into: ``tracer.span(name)`` around a layer's work and
``tracer.count(name)`` where it counts.  The tracer is on while a
``torch.profiler`` records, or after ``tracer.enable()``; while it is off a
span costs one flag check and a shared no-op ``with``.  Inside
``tracer.recording()`` (the capture of a CUDA graph) counts and the kernel
wrappers' launches are collected instead, and counted again on each
replay.  Spans are stamped
with ``time.time_ns()``, the clock of the profiler's events, and while a
profiler records each span also opens a ``record_function`` range of its
name, which the profiler mirrors onto the device's timeline.

``device_trace(log_dir)`` records the CPU and (with a card) CUDA activity
of its block and writes a Chrome trace there; ``force_execute(x)`` waits
for the card when ``x`` holds a CUDA tensor, so a host clock around it
measures the work and not its enqueue.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

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


class _NoSpan:
    """What ``span`` returns while the tracer is off: one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    """One span being recorded: its parent is the innermost span open on the
    same thread, and it takes the parent's event id unless given one."""

    __slots__ = ("_tracer", "_rec", "_range")

    def __init__(self, tracer: "StageProfiler", name: str, event: Optional[int], attrs: dict):
        self._tracer = tracer
        self._rec = {"name": name, "id": None, "parent": None, "event": event, "thread": None,
                     "t0": None, "t1": None, "attrs": attrs}
        self._range = None

    def set(self, **attrs) -> None:
        """Integer attributes known only once the span has begun."""
        self._rec["attrs"].update(attrs)

    def __enter__(self):
        rec, stack = self._rec, self._tracer._stack()
        if stack:
            rec["parent"] = stack[-1]["id"]
            if rec["event"] is None:
                rec["event"] = stack[-1]["event"]
        rec["id"] = next(self._tracer._ids)
        rec["thread"] = threading.get_ident()
        stack.append(rec)
        rec["t0"] = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(rec["name"])
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec["t1"] = time.time_ns()
        self._tracer._stack().pop()
        self._tracer._finish(self._rec)
        return False


def _launch_counters() -> Dict[tuple, int]:
    """The kernel wrappers' own launch counts, by (wrapper, counter)."""
    from ..ops import attention, int4_grouped_gemm, int4_matvec, int8_matvec, paged_attention, scan

    wrappers = (int8_matvec.int8_matvec, int4_matvec.int4_matvec, attention.flash_attention,
                attention.flash_attention_lse, attention.flash_bwd_dq, attention.flash_bwd_dkv,
                attention.exact_attention, scan.selective_scan_kernel,
                paged_attention.paged_decode_attention, int4_grouped_gemm.int4_grouped_gemm)
    return {(fn, k): v for fn in wrappers for k, v in vars(fn).items() if k.endswith("launches")}


def _kernel_launches() -> Dict[str, int]:
    """The kernel wrappers' own launch counts, as ``<wrapper>.<counter>``."""
    return {f"{fn.__name__}.{k}": v for (fn, k), v in _launch_counters().items()}


class Recorded:
    """What a block of the program counted, collected by
    ``StageProfiler.recording``: the tracer's counts and the kernel
    wrappers' launches.  ``replay`` counts them once more, as a CUDA graph
    captured from the block does its work once more on each replay."""

    def __init__(self, tracer: "StageProfiler"):
        self._tracer = tracer
        self.counts: Dict[str, int] = {}
        self.launches: Dict[tuple, int] = {}

    def replay(self) -> None:
        for name, n in self.counts.items():
            self._tracer.count(name, n)
        for (fn, k), n in self.launches.items():
            setattr(fn, k, getattr(fn, k) + n)


class StageProfiler:
    """Named latency trackers and a JSONL sink, and the tracer: spans and
    counters kept in memory while it is on, each span's length added to
    the tracker of its name."""

    def __init__(self, sink_path: Optional[str] = None):
        self.stages: Dict[str, LatencyTracker] = defaultdict(LatencyTracker)
        self.sink_path = sink_path
        self._enabled = False
        self._records: List[dict] = []
        self._counters: Dict[str, int] = defaultdict(int)
        self._launches0: Dict[str, int] = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def timed(self, stage: str):
        return self.stages[stage].timed()

    def add(self, stage: str, seconds: float):
        self.stages[stage].add(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: v.summary() for k, v in self.stages.items()}

    def flush(self, extra: Optional[Dict] = None) -> None:
        """Append the summary (and the counters, where any were counted) as
        one JSON line to the sink, then each span recorded since the last
        flush as a line of its own, and let those spans go."""
        if not self.sink_path:
            return
        os.makedirs(os.path.dirname(self.sink_path) or ".", exist_ok=True)
        record = {"ts": time.time(), "stages": self.summary()}
        if self._counters:
            record["counters"] = self.counters()
        if extra:
            record.update(extra)
        with self._lock:
            spans, self._records = self._records, []
        with open(self.sink_path, "a") as f:
            f.write(json.dumps(record) + "\n")
            for rec in spans:
                f.write(json.dumps(rec) + "\n")

    # -- the tracer ------------------------------------------------------------
    def enable(self) -> None:
        """Record spans and counts with no profiler running."""
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def span(self, name: str, event: Optional[int] = None, **attrs):
        """A context manager that records the span ``name`` (a record of its
        name, id, parent, event id, thread, start and end in ``time.time_ns``
        and ``attrs``, a few ints) while the tracer is on."""
        if not (self._enabled or _autograd_profiler._is_profiler_enabled):
            return _NO_SPAN
        return _Span(self, name, event, attrs)

    def count(self, name: str, n: int = 1) -> None:
        sink = getattr(self._local, "sink", None)
        if sink is not None:
            sink[name] = sink.get(name, 0) + n
            return
        if self._enabled or _autograd_profiler._is_profiler_enabled:
            with self._lock:
                self._counters[name] += n

    @contextlib.contextmanager
    def recording(self) -> Iterator[Recorded]:
        """Inside the block, this thread's counts and the kernel wrappers'
        launches are collected into the ``Recorded`` it yields, not
        counted: the block is the capture of a CUDA graph, whose kernels
        run only when it replays (``Recorded.replay``)."""
        rec = Recorded(self)
        before = _launch_counters()
        self._local.sink = rec.counts
        try:
            yield rec
        finally:
            self._local.sink = None
            for key, n in _launch_counters().items():
                if n != before.get(key, 0):
                    rec.launches[key] = n - before.get(key, 0)
                    setattr(key[0], key[1], before.get(key, 0))

    def records(self) -> List[dict]:
        """The spans recorded since the last reset or flush, as they ended."""
        with self._lock:
            return list(self._records)

    def counters(self) -> Dict[str, int]:
        """The tracer's counts, and the kernel wrappers' launches since the
        last reset."""
        with self._lock:
            out = dict(self._counters)
        for name, n in _kernel_launches().items():
            out[name] = n - self._launches0.get(name, 0)
        return out

    def reset(self) -> None:
        """Forget every span, count and summary."""
        with self._lock:
            self._records.clear()
            self._counters.clear()
            self.stages.clear()
        self._launches0 = _kernel_launches()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _finish(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            self.stages[rec["name"]].add((rec["t1"] - rec["t0"]) / 1e9)


# the program's one tracer
tracer = StageProfiler()


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
