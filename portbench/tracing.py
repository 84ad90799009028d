"""What a traced window's profiler events say: device busy time, each
kernel's count and time, kernels inside the benchmark's own ranges, and
where the device sat idle by what the host was doing.

Reads the profiler's raw events (no per-event Python objects are built
for the whole trace).  The benchmark's spans enter the trace as
``record_function`` ranges named ``portbench.*``; the profiler mirrors each
on the device's timeline, which is how a kernel is put under a span.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

OUTSIDE = "outside the benchmark's spans (clients, broker)"


def short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    out, depth = [], 0
    name = name.replace("(anonymous namespace)", "anon")
    for ch in name[5:] if name.startswith("void ") else name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _segments(spans):
    """Nested host spans → non-overlapping (start, end, innermost name)."""
    segs, stack, cur = [], [], None

    def flush(t):
        nonlocal cur
        if stack and cur is not None and t > cur:
            segs.append((cur, t, stack[-1][1]))
        cur = t

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            flush(stack[-1][0])
            stack.pop()
        flush(s)
        stack.append((e, name))
    while stack:
        flush(stack[-1][0])
        stack.pop()
    return segs


class Trace:
    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.ops = []                              # (start_ns, end_ns, name) of device work
        self.gpu_ranges = defaultdict(list)        # span name -> device-side (start, end)
        self.cpu_ranges = []                       # (start, end, name) of benchmark spans
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            s, e = ev.start_ns(), ev.end_ns()
            if ev.device_type() == DeviceType.CUDA:
                if ev.is_user_annotation():
                    if name.startswith("portbench."):
                        self.gpu_ranges[name].append((s, e))
                elif e > s:
                    self.ops.append((s, e, name))
            elif name.startswith("portbench."):
                self.cpu_ranges.append((s, e, name))
        self.ops.sort()
        self.busy = _merge([(s, e) for s, e, _ in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        for v in self.gpu_ranges.values():
            v.sort()

    def kernel(self, pattern: str, inside: str = None):
        """(launches, seconds) of the kernels whose name holds ``pattern``;
        with ``inside``, only those whose middle lies in a device-side
        range of that span."""
        rng = self.gpu_ranges.get(inside, []) if inside else None
        starts = [r[0] for r in rng] if rng else None
        n, t = 0, 0
        for s, e, name in self.ops:
            if pattern not in name:
                continue
            if inside is not None:
                mid = (s + e) // 2
                i = bisect.bisect_right(starts, mid) - 1 if starts else -1
                if i < 0 or mid > rng[i][1]:
                    continue
            n += 1
            t += e - s
        return n, t / 1e9

    def time_inside(self, span: str):
        """(ranges, device seconds of all kernels inside them) of a span."""
        rng = self.gpu_ranges.get(span, [])
        if not rng:
            return 0, 0.0
        return len(rng), self.kernel("", inside=span)[1]

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(int)
        for s, e, name in self.ops:
            by_op[short(name)] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        # idle gaps between device work, named by the innermost host span around their middle
        segs = _segments(self.cpu_ranges)
        starts = [sg[0] for sg in segs]
        idle = defaultdict(int)
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            mid = (e0 + s1) // 2
            i = bisect.bisect_right(starts, mid) - 1
            idle[segs[i][2] if i >= 0 and mid < segs[i][1] else OUTSIDE] += s1 - e0
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}
