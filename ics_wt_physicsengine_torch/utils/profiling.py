"""
Profiling and diagnostics hooks (port of
``ics_wt_physicsengine_tpu/utils/profiling.py``).

- ``diagnostics()``: a pure metrics dictionary of tensors (no host sync);
- ``trace()``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- ``StepTimer``: lightweight host-side rate/latency tracking for the serving
  loop (real-time-factor accounting).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
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


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels when there is one) and write ``trace.json``, a Chrome
    trace, into ``log_dir`` (default: ``torch-trace`` in the temporary
    directory). Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
