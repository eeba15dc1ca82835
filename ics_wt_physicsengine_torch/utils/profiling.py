"""
Profiling and diagnostics hooks (port of
``ics_wt_physicsengine_tpu/utils/profiling.py``).

- ``diagnostics()``: a pure metrics dictionary of tensors (no host sync);
- ``span()``, ``spanned()``, ``recording()``: the program's own spans
  (``wt.<layer>.<part>``) around the parts of its wrappers, recorded only
  inside ``recording()`` on the clock of ``torch.profiler``'s timestamps;
- ``trace()``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``), the program's
  spans beside the profiler's events;
- ``StepTimer``: lightweight host-side rate/latency tracking for the serving
  loop (real-time-factor accounting).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import threading
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile


def diagnostics(params, state) -> Dict:
    """Metrics: conservation + mixing quality + per-variable spreads, as
    tensors on the state's device."""
    # imported here: the core imports utils.dispatch, and this package's
    # __init__ imports this module
    from ics_wt_physicsengine_torch.core import reactor as R
    from ics_wt_physicsengine_torch.core import transport as transport_mod

    cons = R.conservation_metrics(params, state)
    ph_cv, ph_seg = transport_mod.mixing_quality(state.pH)
    cl_cv, cl_seg = transport_mod.mixing_quality(state.chlorine)
    return {
        **cons,
        "pH_cv": ph_cv, "pH_segregation": ph_seg,
        "chlorine_cv": cl_cv, "chlorine_segregation": cl_seg,
        "pH_range": torch.amax(state.pH, dim=-1)
        - torch.amin(state.pH, dim=-1),
        "temperature_range": torch.amax(state.temperature, dim=-1)
        - torch.amin(state.temperature, dim=-1),
    }


# The spans one recording keeps; those past it are counted, not kept.
SPAN_CAP = 1 << 16

_OFF = contextlib.nullcontext()
_recording = None       # the Spans of the open recording(), or None


class Spans(list):
    """The spans of one ``recording()``, in the order they opened: ``(name,
    start_ns, end_ns, parent, root)`` on ``time.time_ns``'s clock, which is
    the clock of ``torch.profiler``'s event timestamps. ``parent`` is the
    index of the enclosing span (-1 for none), ``root`` the index of the
    outermost span open at the time (its own where it is outermost): the
    spans of one call share it. ``dropped`` counts the spans past
    ``SPAN_CAP``. Spans nest as the calls that open them; record one thread
    at a time."""

    def __init__(self):
        super().__init__()
        self.dropped = 0
        self.stack = []         # indices of the open spans, innermost last


class _Span:
    __slots__ = ("spans", "name", "index", "start")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.index = spans, name, None

    def __enter__(self):
        spans = self.spans
        if len(spans) >= SPAN_CAP:
            spans.dropped += 1
            return self
        self.index = len(spans)
        spans.append(None)      # its place, filled in when it closes
        spans.stack.append(self.index)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.index is not None:
            spans = self.spans
            spans.stack.pop()
            spans[self.index] = (
                self.name, self.start, end,
                spans.stack[-1] if spans.stack else -1,
                spans.stack[0] if spans.stack else self.index)
        return False


def span(name: str):
    """A context manager around one part of the program, ``name`` of the
    form ``wt.<layer>.<part>``. Outside ``recording()`` it is one shared
    object that does nothing (no clock, no allocation, no device call);
    inside, it adds the part's span to the recording. Spans hold no
    tensors and call nothing on the device, so outputs are the same with
    them on or off."""
    if _recording is None:
        return _OFF
    return _Span(_recording, name)


def spanned(name: str):
    """Decorate a function so that each call of it is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record the program's spans for the block; yields the ``Spans`` it
    fills. The only switch of the spans: outside it they are off. A
    recording opened inside another takes the spans of its block."""
    global _recording
    outer, spans = _recording, Spans()
    _recording = spans
    try:
        yield spans
    finally:
        _recording = outer


def _write_spans(path: str, spans: Spans, tid: int) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as complete events on
    the thread ``tid`` of this process, on the trace's own time base."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "wt_span", "name": name, "pid": pid, "tid": tid,
         "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
         "args": {"parent": parent, "root": root}}
        for name, start, end, parent, root in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels when there is one) and write ``trace.json``, a Chrome
    trace, into ``log_dir`` (default: ``torch-trace`` in the temporary
    directory), the program's spans (``recording()``) among its events, so
    that Perfetto shows the wrappers' parts above the operations and
    kernels they launch. Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    tid = threading.get_native_id()
    with recording() as spans:
        prof.start()
        try:
            yield log_dir
        finally:
            prof.stop()
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            _write_spans(path, spans, tid)


class StepTimer:
    """Host-side step timing for the HIL loop: rolling rate and the
    achieved real-time factor."""

    def __init__(self, window: int = 256):
        self.window = window
        self._stamps = []
        self._sim_times = []

    def tick(self, sim_time: float):
        now = time.monotonic()
        self._stamps.append(now)
        self._sim_times.append(sim_time)
        if len(self._stamps) > self.window:
            self._stamps.pop(0)
            self._sim_times.pop(0)

    @property
    def steps_per_second(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0

    @property
    def real_time_factor(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        wall = self._stamps[-1] - self._stamps[0]
        sim = self._sim_times[-1] - self._sim_times[0]
        return sim / wall if wall > 0 else 0.0
