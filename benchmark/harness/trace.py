"""
What a traced window shows: every device activity (kernels, copies,
sets) from ``torch.profiler``'s trace, the CUDA runtime calls and the
benchmark's own spans beside them, and the reductions the per-layer
metrics read: device busy time (the union of activity), device seconds by
kernel, and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


class Trace:
    """The profiled window's events, in seconds from its start.

    ``device``: ``(name, start, end)`` of each device activity; ``host``:
    ``(name, start, end)`` of each host operation and ``bench.*`` span;
    ``window_s``: the traced window's length."""

    def __init__(self, device, host, window_s: float):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        self.window_s = window_s
        self.intervals = _union([(s, e) for _, s, e in self.device])
        self.busy_s = sum(e - s for s, e in self.intervals)

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds any of
        ``parts``."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in parts))

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(float)
        for n, s, e in self.device:
            total[_short(n)] += e - s
        return sorted(([n, t] for n, t in total.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time by what the host was doing: each gap between
        device activities (and before the first and after the last, inside
        the window) named by the innermost host span open at its middle,
        within its ``bench.*`` span; summed by name."""
        edges = [(0.0, 0.0)] + self.intervals + [(self.window_s,
                                                  self.window_s)]
        gaps = [(a[1], b[0]) for a, b in zip(edges, edges[1:])
                if b[0] > a[1]]
        ops = [h for h in self.host if not h[0].startswith("bench.")]
        spans = [h for h in self.host if h[0].startswith("bench.")]
        op_starts = [h[1] for h in ops]
        span_starts = [h[1] for h in spans]
        total = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            label = []
            for pool, starts, reach in ((spans, span_starts, 8),
                                        (ops, op_starts, 64)):
                # the host's spans nest: the latest one still open at the
                # middle is the innermost
                i = bisect.bisect_right(starts, mid)
                for j in range(i - 1, max(-1, i - 1 - reach), -1):
                    if pool[j][2] >= mid:
                        label.append(pool[j][0])
                        break
            total[_short(" / ".join(label) or "host idle")] += e - s
        return sorted(([n, t] for n, t in total.items()),
                      key=lambda x: -x[1])[:top]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def profiled(run, marks: list):
    """Run ``run()`` under ``torch.profiler`` tracing the device (and the
    CUDA runtime calls that drive it; the host's operations are left
    untraced, which would slow a host-paced cell by a third); return
    ``(its result, Trace)``. ``run`` ends synchronized. ``marks``: the
    ``(name, start ns, end ns)`` spans ``run`` recorded on the host's
    wall clock, the clock of the profiler's timestamps; with the runtime
    calls they name what the host did in each idle gap."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    # (a build of PyTorch without CUDA, in the tests, traces its host)
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        result = run()
        t1 = time.time_ns()
    device, host = [], []
    for name, s, e in marks:
        if e >= t0 and s <= t1:
            host.append((name, (max(s, t0) - t0) * 1e-9,
                         (min(e, t1) - t0) * 1e-9))
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        if end < t0 or s > t1:
            continue
        item = (e.name(), (max(s, t0) - t0) * 1e-9,
                (min(end, t1) - t0) * 1e-9)
        (device if str(e.device_type()).endswith("CUDA") else host) \
            .append(item)
    return result, Trace(device, host, (t1 - t0) * 1e-9)
