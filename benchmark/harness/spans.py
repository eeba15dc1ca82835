"""
The program's own spans in a traced window, and what they say a call.

The port records a span (``ics_wt_physicsengine_torch.utils.profiling``,
``wt.<layer>.<part>``) around each part of the B3 and B1 wrappers and of
the served chunk, on the clock of the profiler's timestamps, while
``recording()`` is open. Put on the window's timeline beside the
``trace.Trace``'s runtime calls and the benchmark's ``bench.*`` spans,
they give:

- each part's **self time**: its span less the spans inside it and less
  the blocking runtime calls (``cuda*Synchronize``, ``cudaMemcpy*``)
  inside it and outside those;
- the blocking calls and the kernel launches (``cudaLaunchKernel*``,
  ``cuLaunchKernel*``) inside any program span, counted and timed: the
  harness's own calls (its final wait) lie outside them;
- the device's idle gaps named by all three: the benchmark's span, the
  program's innermost span and the runtime call open at the gap's middle
  (``bench.call / wt.b3.lead_in / cudaLaunchKernel``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# metric base name -> the spans whose self time it sums
PARTS = {
    "b3_statics_ms": ("wt.b3.statics",),
    "b3_tables_ms": ("wt.b3.tables",),
    "b3_lead_in_ms": ("wt.b3.lead_in",),
    "b3_launch_ms": ("wt.b3.launch",),
    "b3_rings_ms": ("wt.b3.rings",),
    "b3_unpack_ms": ("wt.b3.unpack", "wt.serve.codes"),
}
# the spans around whole calls, which hold the parts
CONTAINERS = ("wt.b3.wrapper", "wt.b1.wrapper", "wt.serve.chunk")


def blocking(name: str) -> bool:
    """A runtime call that waits for the device or copies through it."""
    return name.startswith("cudaMemcpy") or (
        name.startswith("cuda") and name.endswith("Synchronize"))


def launch(name: str) -> bool:
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


class Program:
    """The program's spans of a traced window, ``(name, start, end,
    parent, root)`` in seconds from the window's start, in the order they
    opened (so by start); ``parent`` and ``root`` index this list, -1 for
    none. ``runtime``: the trace's host events other than the benchmark's
    spans, ``(name, start, end)``."""

    def __init__(self, spans, runtime):
        self.spans = list(spans)
        self.starts = [s[1] for s in self.spans]
        self.runtime = list(runtime)
        self.children = defaultdict(float)   # span -> seconds of children
        for _, s, e, parent, _ in self.spans:
            if parent >= 0:
                self.children[parent] += e - s
        # each runtime call's innermost program span (None: outside all)
        self.inside = [self.innermost(s) for _, s, _ in self.runtime]

    def innermost(self, t: float):
        """The index of the innermost span open at ``t``, or None. Spans
        nest, so walking back from the last one opened before ``t``, the
        first that is still open holds ``t``; a closed outermost one ends
        the walk."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            _, s, e, parent, _ = self.spans[i]
            if e >= t:
                return i
            if parent < 0:
                return None
            i -= 1
        return None

    def waits(self):
        """``(span index, seconds)`` of each blocking call inside a span."""
        return [(i, e - s) for (n, s, e), i in zip(self.runtime, self.inside)
                if i is not None and blocking(n)]

    def self_s(self) -> dict:
        """Each span name's self seconds, summed over its spans."""
        waited = defaultdict(float)
        for i, w in self.waits():
            waited[i] += w
        out = defaultdict(float)
        for i, (name, s, e, _, _) in enumerate(self.spans):
            out[name] += e - s - self.children[i] - waited[i]
        return out

    def wait_s(self) -> dict:
        """Seconds of blocking calls by the span they lie in, named with
        its parent (``wt.serve.chunk > wt.b3.statics``)."""
        out = defaultdict(float)
        for i, w in self.waits():
            name, _, _, parent, _ = self.spans[i]
            up = self.spans[parent][0] + " > " if parent >= 0 else ""
            out[up + name] += w
        return out

    def metrics(self, calls: int, suffix: str = "", parts: bool = True
                ) -> dict:
        """The per-call numbers, named ``<base><suffix>``: with ``parts``
        the B3 parts' self times (0.0 for a part that never ran), and
        always the waits, host syncs and launches inside program spans."""
        calls = max(calls, 1)
        out = {}
        if parts:
            own = self.self_s()
            for base, names in PARTS.items():
                out[base + suffix] = 1e3 * sum(own[n] for n in names) / calls
        waits = self.waits()
        out["sync_wait_ms" + suffix] = 1e3 * sum(w for _, w in waits) / calls
        out["host_syncs_per_call" + suffix] = len(waits) / calls
        out["launches_per_call" + suffix] = sum(
            1 for (n, _, _), i in zip(self.runtime, self.inside)
            if i is not None and launch(n)) / calls
        return out

    def outermost(self, name: str) -> dict:
        """Over the spans ``name`` that are outermost (their own root): how
        many, their milliseconds a span, and the self time of the parts
        inside them (every span but the ``CONTAINERS``) with the waits
        inside those, a span, which should account for nearly all of it
        (the rest is the containers' own)."""
        roots = {i for i, s in enumerate(self.spans)
                 if s[0] == name and s[4] == i}
        n = max(len(roots), 1)
        parts = sum(e - s - self.children[i]
                    for i, (x, s, e, _, root) in enumerate(self.spans)
                    if root in roots and x not in CONTAINERS)
        total = sum(self.spans[i][2] - self.spans[i][1] for i in roots)
        return {"count": len(roots), "span_ms": 1e3 * total / n,
                "parts_and_waits_ms": 1e3 * parts / n,
                "share": parts / total if total else 0.0}


def on_timeline(spans, anchor_ns: int, anchor_s: float) -> list:
    """Recorded spans (``time_ns`` clock) in seconds from a window's start,
    given one instant on both clocks: ``anchor_ns`` recorded, found at
    ``anchor_s`` in the window."""
    return [(name, (s - anchor_ns) * 1e-9 + anchor_s,
             (e - anchor_ns) * 1e-9 + anchor_s, parent, root)
            for name, s, e, parent, root in spans]


def _open_at(pool, starts, t: float, reach: int):
    """The latest-started of ``pool``'s last ``reach`` events before ``t``
    still open at ``t`` (the innermost, where they nest), or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        if pool[j][2] >= t:
            return pool[j][0]
    return None


def idle_gaps(trace, program: Program, top: int = 12) -> list:
    """The device's idle gaps inside the window (as ``Trace.idle_gaps``
    finds them), each named at its middle by the benchmark's span, the
    program's innermost span and the runtime call open; summed by name,
    largest first."""
    edges = [(0.0, 0.0)] + trace.intervals + [(trace.window_s,
                                               trace.window_s)]
    bench = [h for h in trace.host if h[0].startswith("bench.")]
    bench_starts = [h[1] for h in bench]
    ops = program.runtime
    op_starts = [h[1] for h in ops]
    total = defaultdict(float)
    for a, b in zip(edges, edges[1:]):
        s, e = a[1], b[0]
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inner = program.innermost(mid)
        label = [_open_at(bench, bench_starts, mid, 8),
                 program.spans[inner][0] if inner is not None else None,
                 _open_at(ops, op_starts, mid, 64)]
        total[" / ".join(x for x in label if x) or "host idle"] += e - s
    return sorted(([n, t] for n, t in total.items()),
                  key=lambda x: -x[1])[:top]


def named_share(gaps: list, wrappers=("bench.call", "bench.chunk")) -> float:
    """Of the idle seconds inside the benchmark's call spans, the share
    that a program span names (``gaps``: all of ``idle_gaps``, ``top``
    None)."""
    inside = [(n, t) for n, t in gaps if n.split(" / ")[0] in wrappers]
    total = sum(t for _, t in inside)
    named = sum(t for n, t in inside if " / wt." in n)
    return named / total if total else 0.0
