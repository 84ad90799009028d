"""The program's own spans and counters, read after a traced run, and the
device's idle gaps named by the innermost program span the host was in.

The port's tracer (``streammind_torch.utils.profiling.tracer``) records
while a profiler records, so in a ``--trace 1`` run its records are the
traced part of the window.  It stamps them with ``time.time_ns()``, the
clock of the profiler's events, so they join ``run.trace.busy``.  A span
is a dict: name, id, parent (the id of the span around it on its thread),
event (the server's tick number), thread, t0 and t1 in nanoseconds, and
attrs.  A program without the tracer gives no records, and every metric
read from them is left out.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import tracing


def of(run):
    """(spans, counters) of the run's program, read once; a run record may
    carry them already as ``run.program``."""
    got = getattr(run, "program", None)
    if got is None:
        try:
            from streammind_torch.utils import profiling
        except ImportError:
            profiling = None
        tracer = getattr(profiling, "tracer", None)
        got = (tracer.records(), tracer.counters()) if tracer is not None else ([], {})
        run.program = got
    return got


def named(spans: list, name: str) -> list:
    return [r for r in spans if r["name"] == name]


def mean_ms(spans: list, name: str):
    """Mean length of the spans called ``name``, in ms; None where there are none."""
    got = named(spans, name)
    return sum(r["t1"] - r["t0"] for r in got) / len(got) / 1e6 if got else None


def enclosing(spans: list, name: str) -> dict:
    """span id -> the id of the nearest span called ``name`` around it (the
    span itself included), for every span that has one."""
    by_id = {r["id"]: r for r in spans}
    out = {}
    for r in spans:
        cur = r
        while cur is not None and cur["name"] != name:
            cur = by_id.get(cur["parent"])
        if cur is not None:
            out[r["id"]] = cur["id"]
    return out


def idle_by_span(run) -> dict:
    """Device idle nanoseconds between consecutive busy intervals of the
    trace, by the id of the innermost program span open at the gap's
    middle (of the spans open then on any thread, the one begun last);
    gaps with none open under None.  Empty where the run has no trace,
    no device work or no spans."""
    spans, _ = of(run)
    if run.trace is None or not spans or len(run.trace.busy) < 2:
        return {}
    threads = defaultdict(list)
    for r in spans:
        threads[r["thread"]].append((r["t0"], r["t1"], r["id"]))
    segs = [tracing._segments(v) for v in threads.values()]
    starts = [[s[0] for s in sg] for sg in segs]
    begun = {r["id"]: r["t0"] for r in spans}
    idle = defaultdict(int)
    busy = run.trace.busy
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        inner = None
        for sg, st in zip(segs, starts):
            i = bisect.bisect_right(st, mid) - 1
            if i >= 0 and mid < sg[i][1] and (inner is None or begun[sg[i][2]] > begun[inner]):
                inner = sg[i][2]
        idle[inner] += s1 - e0
    return dict(idle)
